"""Serving launcher: a batch of requests through prefill and greedy decode
on one GPU (the port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --smoke --requests 8 --prompt-len 16 --max-new 16

One card, no mesh.  Weights are drawn from a seeded ``torch.Generator`` on
the device: JAX's ``PRNGKey(0)`` stream cannot be replayed in PyTorch, so
these are not the reference's weights (pass ``params``, e.g. from
:func:`repro_torch.models.convert.params_from_reference`, to serve given
ones).  Where the reference prefills by stepping the decode closure over
the prompt (which works for every family), this launcher runs the fused
prefill of the dense family, the only one ported, which is the path
that runs kernel K5.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build
from repro_torch.train.serve import (greedy_sample, make_prefill_step,
                                     make_serve_step)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve_batch(cfg, prompts: np.ndarray, max_new: int, *,
                params=None, seed: int = 0, device=None,
                max_len: Optional[int] = None, log=print) -> Dict[str, Any]:
    """Serve ``prompts`` [B, S]: prefill, then ``max_new - 1`` greedy
    decode steps, ``max_new`` new tokens per request.

    Runs on :func:`repro_torch.runtime.device` (``device`` overrides);
    ``max_len`` (default ``S + max_new``) sizes the KV cache.  Returns the
    tokens [B, max_new] as numpy, the prefill's last-token logits, the
    prefill and decode seconds (host clock, synchronised) and the decode
    throughput."""
    dev = runtime.device(device)
    model = build(cfg)
    b, s = prompts.shape
    max_len = max_len or (s + max_new)
    if params is None:
        params = model.init(seed, device=dev)
    prompt = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
    decode = make_serve_step(model)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(model, max_len)(params, prompt)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits

    pos = torch.full((b,), s, dtype=torch.int32, device=dev)
    token = greedy_sample(logits)
    out = [token]
    t0 = time.perf_counter()
    for _ in range(max_new - 1):
        logits, cache = decode(params, cache, token, pos)
        pos = pos + 1
        token = greedy_sample(logits)
        out.append(token)
    _sync(dev)
    decode_s = time.perf_counter() - t0

    tokens = torch.stack(out, dim=1).cpu().numpy()
    tput = b * (max_new - 1) / max(decode_s, 1e-9)
    log(f"prefill {s} toks x {b} reqs: {prefill_s:.2f}s | "
        f"decode {max_new} toks: {decode_s:.2f}s "
        f"({tput:.1f} tok/s aggregate)")
    return {"tokens": tokens, "prefill_logits": prefill_logits,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "throughput_tok_s": tput}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len)).astype(np.int32)
    out = serve_batch(cfg, prompts, args.max_new, device=args.device)
    print(f"generated shape: {out['tokens'].shape}")


if __name__ == "__main__":
    main()
