"""Deterministic fault injection for the serving tier's chaos paths.

The self-healing machinery of a serving tier — shard retry and
quarantine, the degraded-engine fallback chain
(:mod:`repro_torch.core.devicecost`), worker supervision,
snapshot-restore accounting — only earns its keep if every failure path
can be *exercised*, on CPU CI, repeatably.  Real device
faults cannot be summoned on demand, so the production code carries
cheap named **seams** and this module decides, deterministically, when a
seam misbehaves.

Seams
-----
A seam is one line at a failure-prone boundary::

    faults.check("shards.dispatch", device.id)     # may raise / hang
    out = faults.corrupt("devicecost.fused", out)  # may NaN-poison

With no plan active both calls are a single module-global load plus a
``None`` test — the production steady state pays nothing measurable.
The seams:

=====================  ====================================================
``shards.dispatch``    per-partition device dispatch (key: device id)
``devicecost.fused``   fused scorer output (corrupt -> NaN totals)
``devicecost.banks``   device parameter-bank build (corrupt -> NaN banks)
``memo.restore``       warm-restart snapshot load
``service.worker``     the coalescing worker loop (error -> worker crash)
=====================  ====================================================

Determinism
-----------
A :class:`FaultPlan` carries a seed and a list of :class:`FaultRule`\\ s.
Every ``check``/``corrupt`` increments a per-``(seam, key)`` occurrence
counter; a rule fires either at explicit occurrence indices (``at=``) or
when a hash of ``(seed, seam, key, occurrence)`` falls under ``rate`` —
no global RNG state, so the same plan over the same call sequence fires
identically, and per-device rules stay deterministic even when windows
interleave.  ``max_fires`` bounds a rule (e.g. "corrupt the banks once,
then let the recovery probe succeed").

Usage::

    plan = FaultPlan(seed=7, rules=[
        FaultRule("shards.dispatch", kind="error", rate=0.03),
        FaultRule("shards.dispatch", kind="hang", rate=0.02, hang_s=0.25),
        FaultRule("devicecost.fused", kind="corrupt", rate=0.05),
    ])
    with plan.activate():
        ...drive traffic...
    assert plan.fires() > 0

Exactly one plan may be active per process at a time (the seams are
process-wide by design: the serving worker, shard executor threads and
snapshot restore all cross thread boundaries).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


class FaultInjected(RuntimeError):
    """An injected fault fired at a seam (never raised in production —
    only while a :class:`FaultPlan` is active)."""

    def __init__(self, seam: str, occurrence: int,
                 key=None) -> None:
        at = f"{seam}[{key}]" if key is not None else seam
        super().__init__(f"injected fault at seam {at} "
                         f"(occurrence {occurrence})")
        self.seam = seam
        self.occurrence = occurrence
        self.key = key


#: rule kinds: raise :class:`FaultInjected` / ``time.sleep(hang_s)`` /
#: NaN-poison the value passing through a ``corrupt`` seam
KINDS = ("error", "hang", "corrupt")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """When and how one seam misbehaves.

    ``rate`` fires probabilistically (seed-hashed, not RNG-stateful);
    ``at`` fires at exact per-``(seam, key)`` occurrence indices and
    overrides ``rate``.  ``key`` restricts the rule to checks carrying
    that key (e.g. one device id).  ``max_fires`` caps total fires."""

    seam: str
    kind: str = "error"
    rate: float = 0.0
    at: Optional[Tuple[int, ...]] = None
    key: Optional[object] = None
    hang_s: float = 0.05
    max_fires: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind: {self.kind!r}")
        if self.at is not None:
            object.__setattr__(self, "at", tuple(int(i) for i in self.at))


def _fraction(seed: int, seam: str, key, occurrence: int) -> float:
    """A uniform-[0,1) decision hash — stateless, order-independent."""
    token = f"{seed}:{seam}:{key!r}:{occurrence}".encode()
    digest = hashlib.blake2b(token, digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2.0 ** 64


class FaultPlan:
    """A seeded, deterministic schedule of injected faults (see module
    docstring).  Activate with ``with plan.activate():`` (or ``with
    plan:``); inspect what actually fired via :meth:`fires` /
    :meth:`counts`."""

    def __init__(self, seed: int = 0,
                 rules: Sequence[FaultRule] = ()) -> None:
        self.seed = int(seed)
        self.rules: Tuple[FaultRule, ...] = tuple(rules)
        self._lock = threading.Lock()
        self._occ: Dict[Tuple[str, object], int] = {}
        self._fired: Dict[str, int] = {}
        self._rule_fires: List[int] = [0] * len(self.rules)

    # -- observability ------------------------------------------------------
    def fires(self, seam: Optional[str] = None) -> int:
        """Total injected-fault count (optionally for one seam)."""
        with self._lock:
            if seam is not None:
                return self._fired.get(seam, 0)
            return sum(self._fired.values())

    def counts(self) -> Dict[str, int]:
        """Per-seam fire counts (snapshot)."""
        with self._lock:
            return dict(self._fired)

    def occurrences(self, seam: str, key=None) -> int:
        """How many times a seam (with ``key``) has been checked."""
        with self._lock:
            return self._occ.get((seam, key), 0)

    # -- the decision -------------------------------------------------------
    def _hit(self, seam: str, key, kinds: Tuple[str, ...],
             value=None):
        """One seam crossing: bump the occurrence counter, fire at most
        one matching rule.  Returns the (possibly poisoned) value."""
        hang = None
        with self._lock:
            occ = self._occ.get((seam, key), 0)
            self._occ[(seam, key)] = occ + 1
            for idx, rule in enumerate(self.rules):
                if rule.seam != seam or rule.kind not in kinds:
                    continue
                if rule.key is not None and rule.key != key:
                    continue
                if rule.max_fires is not None \
                        and self._rule_fires[idx] >= rule.max_fires:
                    continue
                if rule.at is not None:
                    fire = occ in rule.at
                else:
                    fire = _fraction(self.seed, seam, key, occ) < rule.rate
                if not fire:
                    continue
                self._rule_fires[idx] += 1
                self._fired[seam] = self._fired.get(seam, 0) + 1
                if rule.kind == "error":
                    raise FaultInjected(seam, occ, key)
                if rule.kind == "hang":
                    hang = rule.hang_s
                else:           # corrupt
                    value = _poison(value)
                break
        if hang is not None:    # sleep OUTSIDE the plan lock
            time.sleep(hang)
        return value

    # -- activation ---------------------------------------------------------
    @contextlib.contextmanager
    def activate(self) -> Iterator["FaultPlan"]:
        global _ACTIVE
        with _ACTIVATION_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("another FaultPlan is already active")
            _ACTIVE = self
        try:
            yield self
        finally:
            with _ACTIVATION_LOCK:
                _ACTIVE = None

    def __enter__(self) -> "FaultPlan":
        self._cm = self.activate()
        return self._cm.__enter__()

    def __exit__(self, *exc) -> None:
        self._cm.__exit__(*exc)


def _poison(value):
    """NaN-fill every float leaf of ``value`` (dict / numpy / torch
    tensor), leaving integer banks (gather indices!) untouched so
    corruption shows up as non-finite *outputs*, not shape/index
    crashes."""
    if value is None:
        return None
    if isinstance(value, dict):
        return {k: _poison(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return value * float("nan") if value.is_floating_point() else value
    dtype = getattr(value, "dtype", None)
    if dtype is not None and np.issubdtype(np.dtype(str(dtype)),
                                           np.floating):
        return value * np.asarray(np.nan, dtype=np.dtype(str(dtype)))
    return value


_ACTIVATION_LOCK = threading.Lock()
_ACTIVE: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    """The currently-activated plan, or ``None`` (the production state)."""
    return _ACTIVE


def check(seam: str, key=None) -> None:
    """A named error/hang seam.  No active plan: one global load plus a
    ``None`` test — effectively compiled out."""
    plan = _ACTIVE
    if plan is not None:
        plan._hit(seam, key, ("error", "hang"))


def corrupt(seam: str, value, key=None):
    """A named corruption seam: the value passes through untouched unless
    an active plan's ``corrupt`` rule fires, in which case every float
    leaf comes back NaN-poisoned (error/hang rules on the same seam fire
    here too)."""
    plan = _ACTIVE
    if plan is None:
        return value
    return plan._hit(seam, key, KINDS, value)
