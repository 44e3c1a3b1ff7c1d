"""K5's forward timed at the float32 shapes, in any checkout of the port.

Times ``flash_attention_kernel`` (CUDA events around 10 calls behind a
device sleep, as ``chip_smoke.py``'s ``timed_ms``) at the float32 shapes
the port runs: qwen2-1.5b's prefill and training attention and every
family's attention shape of ``chip_smoke.py``'s ``K5_FAMILY_SHAPES``,
in the model's [B, S, H, D] strides; with ``--bf16`` also the bf16
shapes (qwen2-1.5b's and the families'), whose variant does not change
with the float32 one.  It uses only the wrapper's
``flash_attention_kernel``, whose signature every checkout since K5's
port shares, so one copy times an older checkout's kernel beside this
one's:

    python scripts/k5_fwd_times.py --src path/to/checkout/src \\
        [--bf16] [--report out.json]

Run the two checkouts in turns (older, newer, newer, older) in one call
on one card.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: name, B, H, KH, Sq, Skv, D, causal
SHAPES = [
    ("qwen2-1.5b", 4, 12, 2, 2048, 2048, 128, True),
    ("granite-moe prefill", 4, 16, 8, 2048, 2048, 64, True),
    ("zamba2 shared attention", 4, 32, 32, 2048, 2048, 64, True),
    ("seamless encoder", 4, 16, 16, 1024, 1024, 64, False),
    ("seamless decoder self", 4, 16, 16, 512, 512, 64, True),
    ("seamless cross", 4, 16, 16, 512, 1024, 64, False),
    ("pixtral prefill", 4, 32, 8, 2048, 2048, 160, True),
]
SLEEP_CYCLES = 50_000_000
CALLS = 10


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    parser.add_argument("--bf16", action="store_true",
                        help="also time the bf16 shapes")
    parser.add_argument("--report", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("k5_fwd_times: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import kernel
    gen = torch.Generator(device="cuda").manual_seed(5)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    rows = []
    dtypes = ["float32"] + (["bfloat16"] if args.bf16 else [])
    for dtype in dtypes:
        for name, b, h, kh, sq, skv, d, causal in SHAPES:
            dt = getattr(torch, dtype)
            q = torch.randn((b, sq, h, d), generator=gen,
                            device="cuda").to(dt).transpose(1, 2)
            k, v = (torch.randn((b, skv, kh, d), generator=gen, device="cuda")
                    .to(dt).transpose(1, 2) for _ in range(2))
            rows.append({
                "shape": name, "dtype": dtype, "variant": kernel.variant(dt, d),
                "src": os.path.abspath(args.src), "card": smi,
                "ms": timed_ms(lambda: kernel.flash_attention_kernel(
                    q, k, v, causal))})
            print(json.dumps(rows[-1]), flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
