"""The numbers that decide ``correct``, each held to its limit.

Training: each checked step's loss against the reference's, relative;
and, leaf by leaf, the norm of the first step's clipped gradient and the
norm of the parameters' change over the checked steps, each as the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's (a key's
bias under softmax) move by round-off alone and are left out, by that
rule and not by name.

Serving: the gap by which each served token's logit lies below the
reference's best logit at that position, summed up over the checked
requests by :func:`gap_stats`.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

#: a leaf counts when its reference gradient norm is at least this share
#: of the median leaf's
QUIET_LEAF = 1e-3


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= QUIET_LEAF * med]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Sequence[str]) -> Tuple[float, str]:
    """(the widest gap of norms, its leaf) over ``leaves``."""
    med = statistics.median(ref[k] for k in leaves)
    worst, where = 0.0, ""
    for k in leaves:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, where = gap, k
    return worst, where


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The widest relative gap of the steps' losses."""
    if len(prog) != len(ref):
        return math.inf
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref)]
    return max((g if math.isfinite(g) else math.inf) for g in gaps)


def logit_gaps(ref_logits, tokens) -> List[float]:
    """Per row: the reference's best logit minus its logit of the served
    token (``ref_logits`` [N, V] tensor, ``tokens`` [N])."""
    import torch
    tok = torch.as_tensor(tokens, device=ref_logits.device).long()
    best = ref_logits.max(-1).values
    served = ref_logits.gather(-1, tok[:, None])[:, 0]
    return (best - served).tolist()


def gap_stats(gaps: Sequence[float]) -> Dict[str, float]:
    """The served tokens' gaps summed up: their mean (``logit_gap_mean``),
    90th percentile by nearest rank (``logit_gap_p90``), widest
    (``logit_gap_max``), and the share of tokens that are not the
    reference's best (``mismatch_share``)."""
    ordered = sorted(gaps)
    n = len(ordered)
    return {"logit_gap_mean": sum(ordered) / n,
            "logit_gap_p90": ordered[max(math.ceil(0.9 * n), 1) - 1],
            "logit_gap_max": ordered[-1],
            "mismatch_share": sum(1 for g in ordered if g > 0) / n}


def held(checks: Dict[str, Dict[str, float]]) -> bool:
    """Whether every number is finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def checks(values: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every limit; a number the run did
    not give reads infinite."""
    return {name: {"value": float(values.get(name, math.inf)),
                   "limit": float(limit)}
            for name, limit in limits.items()}

