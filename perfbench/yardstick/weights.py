"""Weights drawn from ``--seed`` on the device, in a few large calls.

The layout (names, shapes, dtypes) comes from a template: the program's
parameter tree on the ``meta`` device, which holds no values.  Every
value is drawn here: one ``torch.randn`` a dtype, on the run's device,
from a ``torch.Generator`` seeded from the run's seed, each leaf a view
of it scaled by its rule in the configuration's ``init`` (by the leaf's
own name: ``{"std": s}`` or ``{"mean": m, "std": s}``).  The same seed
on the same device gives the same values, so the reference draws them
again rather than taking any from the program.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from perfbench.yardstick import traffic

Tree = Any


def leaf_paths(tree: Tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, leaf) of every tensor leaf, in the tree's order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in leaf_paths(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaf_paths(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def rebuild(template: Tree, by_path: Dict[str, torch.Tensor],
            prefix: str = "") -> Tree:
    """``template``'s tree with each leaf taken from ``by_path``."""
    if isinstance(template, dict):
        return {k: rebuild(v, by_path, f"{prefix}{k}.")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(rebuild(v, by_path, f"{prefix}{i}.")
                              for i, v in enumerate(template))
    return by_path[prefix[:-1]]


def layout(template: Tree) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(path, shape, dtype) of every leaf of the template."""
    return [(p, tuple(t.shape), t.dtype) for p, t in leaf_paths(template)]


def draw(spec: List[Tuple[str, Tuple[int, ...], torch.dtype]],
         init: Dict[str, Dict[str, float]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """path -> tensor for every leaf of ``spec``: one normal draw a dtype,
    each leaf a view of it times its ``std`` plus its ``mean``."""
    by_dtype: Dict[torch.dtype, List[Tuple[str, Tuple[int, ...]]]] = {}
    for path, shape, dtype in spec:
        by_dtype.setdefault(dtype, []).append((path, shape))
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted(by_dtype, key=str):
        leaves = by_dtype[dtype]
        total = sum(_numel(s) for _, s in leaves)
        gen = torch.Generator(device=device)
        gen.manual_seed(traffic.derived_seed(seed, "weights",
                                             _DTYPE_CODES[dtype]))
        flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
        off = 0
        for path, shape in leaves:
            n = _numel(shape)
            rule = init[path.rsplit(".", 1)[-1]]
            leaf = flat[off:off + n].view(shape)
            leaf.mul_(float(rule["std"]))
            if rule.get("mean"):
                leaf.add_(float(rule["mean"]))
            out[path] = leaf
            off += n
    return out


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
