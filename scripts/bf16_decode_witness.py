"""bf16 decode against forward, in the port and in the JAX reference, on
the same weights at a model's full width.

For each architecture (default: zamba2-1.2b and xlstm-350m, the two
recurrent families) the config keeps its published widths and dtypes
and is cut to ``--layers`` layers.  The reference's init
(``PRNGKey(0)``) is carried into the port with ``params_from_reference``;
one seeded prompt goes through each package's forward and, one token at
a time, its decode step, in the config's bf16 compute and in float32.
Per package it reports the decode's gap from the forward (max abs and
rms over every position and logit), and each bf16 path's distance from
the same path in float32.  If the port's bf16 decode path were at fault
its gap would outgrow the reference's; if both gaps come from bf16
rounding they are of one size.

Runs on the CPU (both packages):

    PYTHONPATH=src python scripts/bf16_decode_witness.py \\
        [--arch zamba2-1.2b --arch xlstm-350m] [--layers 6] \\
        [--batch 2] [--prompt 32] [--report out.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

#: layers kept by default: one shared-attention application of zamba2
#: (every 6th layer) and one sLSTM of xLSTM (every 4th block) per cut
DEFAULT_LAYERS = {"zamba2-1.2b": 6, "xlstm-350m": 4}


def _stats(a: np.ndarray, b: np.ndarray) -> dict:
    d = a.astype(np.float64) - b.astype(np.float64)
    return {"max_abs": float(np.abs(d).max()),
            "rms": float(np.sqrt((d ** 2).mean()))}


def reference_logits(arch, layers, dtype, params, tokens):
    """The reference's forward logits and its stepped decode logits,
    [B, S, V] each, as float32 numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import build
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              compute_dtype=dtype)
    model = build(cfg)
    full, _ = jax.jit(model.forward)(params, jnp.asarray(tokens))
    b, s = tokens.shape
    cache = model.init_cache(b, s)
    step = jax.jit(model.decode_step)
    pos = jnp.zeros((b,), jnp.int32)
    steps = []
    for t in range(s):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, t]), pos)
        pos = pos + 1
        steps.append(np.asarray(logits, np.float32))
    return np.asarray(full, np.float32), np.stack(steps, axis=1)


def port_logits(arch, layers, dtype, params, tokens):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              compute_dtype=dtype)
    model = build(cfg)
    tok = torch.as_tensor(tokens)
    b, s = tokens.shape
    with torch.no_grad():
        full, _ = model.forward(params, tok)
        cache = model.init_cache(b, s, device="cpu")
        pos = torch.zeros((b,), dtype=torch.int32)
        steps = []
        for t in range(s):
            logits, cache = model.decode_step(params, cache, tok[:, t], pos)
            pos = pos + 1
            steps.append(logits.float().numpy())
    return full.float().numpy(), np.stack(steps, axis=1)


def witness(arch: str, layers: int, batch: int, prompt: int,
            seed: int) -> dict:
    import jax
    from repro.configs import get_config
    from repro.models import build
    from repro_torch.models.convert import params_from_reference
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    params_r = jax.tree.map(np.asarray, jax.jit(build(cfg).init)(
        jax.random.PRNGKey(0)))
    from repro_torch.configs import get_config as p_get_config
    params_p = params_from_reference(
        params_r, dataclasses.replace(p_get_config(arch), n_layers=layers),
        device="cpu")
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    out = {"arch": arch, "layers": layers, "of_layers": cfg.n_layers,
           "d_model": cfg.d_model, "batch": batch, "prompt": prompt}
    for name, fn, params in (("reference", reference_logits, params_r),
                             ("port", port_logits, params_p)):
        t0 = time.perf_counter()
        res = {dtype: fn(arch, layers, dtype, params, tokens)
               for dtype in ("bfloat16", "float32")}
        (bf, bd), (ff, fd) = res["bfloat16"], res["float32"]
        out[name] = {
            "bf16_decode_vs_forward": _stats(bd, bf),
            "float32_decode_vs_forward": _stats(fd, ff),
            "bf16_vs_float32_forward": _stats(bf, ff),
            "bf16_vs_float32_decode": _stats(bd, fd),
            "logit_rms_float32": float(np.sqrt((ff.astype(np.float64) ** 2)
                                               .mean())),
            "seconds": time.perf_counter() - t0}
        out[f"_{name}"] = res
    r, p = out.pop("_reference"), out.pop("_port")
    out["port_vs_reference"] = {
        f"{dtype}_{path}": _stats(p[dtype][i], r[dtype][i])
        for dtype in ("bfloat16", "float32")
        for i, path in enumerate(("forward", "decode"))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="layers kept (default: DEFAULT_LAYERS)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)
    rows = []
    for arch in args.arch or list(DEFAULT_LAYERS):
        rows.append(witness(arch, args.layers or DEFAULT_LAYERS[arch],
                            args.batch, args.prompt, args.seed))
        print(json.dumps(rows[-1]), flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
