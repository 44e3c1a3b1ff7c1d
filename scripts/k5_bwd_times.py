"""K5's backward timed kernel by kernel, in any checkout of the port.

Times ``flash_attention_bwd_kernel`` (a whole call: CUDA events around 10
calls behind a device sleep, as ``chip_smoke.py``'s ``timed_ms``) and
each kernel one call launches (delta, dK/dV, the partials' sum where the
dK/dV pass is split, dQ; ``torch.profiler`` over 5 calls) at the shapes
of ``chip_smoke.py``'s backward rows: qwen2-1.5b's training attention in
bf16 and float32 and every family's.  It uses only the wrapper's
``flash_attention_kernel`` and ``flash_attention_bwd_kernel``, whose
signatures every checkout since the backward's port shares, so one copy
times an older checkout's kernels beside this one's:

    python scripts/k5_bwd_times.py --src path/to/checkout/src \\
        [--only train] [--splits N] [--report out.json]

Run the two checkouts in turns (older, newer, newer, older) in one call
on one card.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

#: name, B, H, KH, S (Sq = Skv), D, causal, dtype; seamless cross has Sq
#: 512 against Skv 1,024
SHAPES = [
    ("qwen2-1.5b train", 4, 12, 2, 2048, 2048, 128, True, "bfloat16"),
    ("qwen2-1.5b train float32", 4, 12, 2, 2048, 2048, 128, True,
     "float32"),
    ("granite-moe prefill", 4, 16, 8, 2048, 2048, 64, True, "bfloat16"),
    ("zamba2 shared attention", 4, 32, 32, 2048, 2048, 64, True,
     "bfloat16"),
    ("seamless encoder", 4, 16, 16, 1024, 1024, 64, False, "bfloat16"),
    ("seamless decoder self", 4, 16, 16, 512, 512, 64, True, "bfloat16"),
    ("seamless cross", 4, 16, 16, 512, 1024, 64, False, "bfloat16"),
    ("pixtral prefill", 4, 32, 8, 2048, 2048, 160, True, "bfloat16"),
    ("pixtral prefill float32", 4, 32, 8, 2048, 2048, 160, True,
     "float32"),
]
SLEEP_CYCLES = 50_000_000
CALLS = 10
TRACED = 5


def timed_ms(fn) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def by_kernel(fn) -> dict:
    """Device ms a call of each kernel whose name holds ``flash_bwd``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "flash_bwd" in e.name:
            name = e.name.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / TRACED
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    parser.add_argument("--only", choices=["train"], default=None,
                        help="train: qwen2-1.5b's two rows alone")
    parser.add_argument("--splits", type=int, default=None,
                        help="force the dK/dV pass's split count "
                             "(kernel.dkv_splits, where the checkout has "
                             "it) instead of the rule's")
    parser.add_argument("--report", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("k5_bwd_times: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import kernel
    if args.splits is not None:
        kernel.dkv_splits = lambda *shape: args.splits
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for name, b, h, kh, sq, skv, d, causal, dtype in SHAPES:
        if args.only == "train" and not name.startswith("qwen2"):
            continue
        dtype = getattr(torch, dtype)
        q, g = (torch.randn((b, sq, h, d), generator=gen, device="cuda")
                .to(dtype).transpose(1, 2) for _ in range(2))
        k, v = (torch.randn((b, skv, kh, d), generator=gen, device="cuda")
                .to(dtype).transpose(1, 2) for _ in range(2))
        out, lse = kernel.flash_attention_kernel(q, k, v, causal)

        def call():
            return kernel.flash_attention_bwd_kernel(q, k, v, out, lse, g,
                                                     causal)
        rows.append({"shape": name, "src": os.path.abspath(args.src),
                     "splits": args.splits, "ms": timed_ms(call),
                     "kernels_ms": by_kernel(call)})
        print(json.dumps(rows[-1]), flush=True)
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
