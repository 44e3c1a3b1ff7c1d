"""Granite 4.0-H's serving path against its plain reference on the card: a
prompt through ``serve_batch``'s fused prefill, then decode steps through
its cache, each step's logits against the reference's forward over the
prompt and the served tokens at once.

    python3 scripts/granite_hybrid_decode_check.py [--prompt 8192] \
        [--new 16] [--seed 1] [--report decode_check.json]

The weights are the benchmark configuration's
(``perfbench/configs/granite-4.0-h-small.json``, 20 layers at the
published widths), drawn from the seed.  The experts' capacity holds
every assignment (factor E / k) in both, so routing the prompt whole and
a token a step keep the same assignments.  For scale, the reference with
its products in float8 (the benchmark's control) is compared the same
way.  Needs a CUDA card.
"""
import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

CELL = "granite-4.0-h-small.prefill-long32k"


def _compare(got, want):
    """Per step: the widest gap, the reference's spread, whether the
    greedy tokens agree and the served token's gap below the reference's
    best."""
    rows = []
    for g, w in zip(got, want):
        tok = int(g.argmax())
        rows.append({"max_abs": float((g - w).abs().max()),
                     "ref_std": float(w.std()),
                     "same_token": tok == int(w.argmax()),
                     "gap": float(w.max() - w[tok])})
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=int, default=8192)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--report", default=None)
    args = ap.parse_args()

    import torch
    from perfbench import harness
    from perfbench.drivers import common
    from perfbench.reference import decoder
    from perfbench.reference.granite_hybrid import GraniteHybrid
    from perfbench.yardstick import traffic, weights
    from repro_torch.launch import serve
    from repro_torch.models import build

    harness.prepare_env(harness.Path(ROOT))
    dev = harness.pick_device(1, None)
    cell = harness.Cell.load(harness.Path(ROOT), CELL)
    base = cell.port_config()
    e, k = base.moe.n_experts, base.moe.top_k
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=e / k))
    model = build(cfg)
    template = model.init(0, device="meta")
    spec = weights.layout(template)
    W = weights.draw(spec, cell.config["init"], args.seed, dev)
    params = weights.rebuild(template, W)
    prompts = traffic.prompts(args.seed, 0, 1, args.prompt, cfg.vocab_size)

    seen = []
    greedy = serve.greedy_sample

    def recorded(logits):
        seen.append(logits[0].float())
        return greedy(logits)
    serve.greedy_sample = recorded
    try:
        out = serve.serve_batch(cfg, prompts, args.new, params=params,
                                log=print)
    finally:
        serve.greedy_sample = greedy
    del params
    common.free_device()

    model_numbers = dict(cell.config["model"], capacity_factor=e / k)
    seq = torch.as_tensor(
        [list(prompts[0]) + list(out["tokens"][0, :-1])], device=dev)
    last = slice(args.prompt - 1, args.prompt - 1 + args.new)
    report = {"device": torch.cuda.get_device_name(dev),
              "prompt": args.prompt, "new": args.new, "seed": args.seed,
              "prefill_s": out["prefill_s"], "decode_s": out["decode_s"]}
    with decoder.exact_float32():
        for name, mm in (("program", None), ("control_fp8", "fp8")):
            ref = GraniteHybrid(model_numbers)
            want = ref.logits(W, ref.hidden(W, seq)[0, last])
            if mm is None:
                got = seen
            else:
                low = GraniteHybrid(model_numbers, decoder.Matmul(mm))
                got = low.logits(W, low.hidden(W, seq)[0, last])
            report[name] = _compare(got, want)
            del want
            common.free_device()
    for name in ("program", "control_fp8"):
        rows = report[name]
        print(f"{name}: widest gap {max(r['max_abs'] for r in rows):.5g}, "
              f"reference std {rows[0]['ref_std']:.5g}, same token "
              f"{sum(r['same_token'] for r in rows)}/{len(rows)}, mean "
              f"served gap {sum(r['gap'] for r in rows) / len(rows):.5g}")
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
