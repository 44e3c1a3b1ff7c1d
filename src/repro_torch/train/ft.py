"""Fault tolerance for multi-pod runs: heartbeats, straggler detection,
checkpoint/restart, and elastic re-meshing plans (the port's own copy of
``repro/train/ft.py``, which is plain Python).

Designed for thousands of workers: all coordination is through cheap local
state + the shared checkpoint directory (no extra RPC layer), as large
fleets of accelerators are babysat.  Every component is unit-testable on one
host by simulating worker reports.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time tracker; flags workers whose step time deviates.

    Mitigation policy at scale: flagged workers are candidates for (a)
    within-step work-stealing is impossible under SPMD, so (b) the runner
    either drops the worker's pod at the next elastic boundary or restarts
    it from checkpoint — both decisions this class feeds.
    """

    alpha: float = 0.1
    threshold: float = 2.0      # flag if step_time > threshold * fleet EWMA
    ewma: Dict[str, float] = dataclasses.field(default_factory=dict)

    def observe(self, worker: str, step_seconds: float) -> None:
        prev = self.ewma.get(worker)
        self.ewma[worker] = (step_seconds if prev is None
                             else (1 - self.alpha) * prev +
                             self.alpha * step_seconds)

    def fleet_median(self) -> float:
        values = sorted(self.ewma.values())
        if not values:
            return 0.0
        return values[len(values) // 2]

    def stragglers(self) -> List[str]:
        median = self.fleet_median()
        if median <= 0:
            return []
        return [w for w, t in self.ewma.items()
                if t > self.threshold * median]


@dataclasses.dataclass
class HeartbeatMonitor:
    """File-based heartbeats: worker i touches <dir>/hb_<i> each step."""

    directory: str
    timeout_seconds: float = 120.0

    def beat(self, worker: str) -> None:
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"hb_{worker}")
        with open(path, "w") as fh:
            fh.write(str(time.time()))

    def dead_workers(self, expected: Sequence[str]) -> List[str]:
        now = time.time()
        dead = []
        for worker in expected:
            path = os.path.join(self.directory, f"hb_{worker}")
            try:
                with open(path) as fh:
                    last = float(fh.read().strip())
            except (FileNotFoundError, ValueError):
                dead.append(worker)
                continue
            if now - last > self.timeout_seconds:
                dead.append(worker)
        return dead


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Re-mesh decision after pod loss/gain.

    The global batch is preserved by rescaling per-pod batch (keeps the
    optimizer trajectory comparable); restore resharding is handled by
    checkpoint.restore_checkpoint against the new mesh's shardings.
    """

    old_pods: int
    new_pods: int
    pod_shape: Tuple[int, int]
    global_batch: int

    @property
    def per_pod_batch(self) -> int:
        return self.global_batch // max(self.new_pods, 1)

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        if self.new_pods == 1:
            return self.pod_shape
        return (self.new_pods,) + self.pod_shape

    def valid(self) -> bool:
        return self.new_pods >= 1 and \
            self.global_batch % max(self.new_pods, 1) == 0


def plan_elastic_remesh(available_pods: int, pod_shape: Tuple[int, int],
                        global_batch: int, old_pods: int) -> ElasticPlan:
    """Largest power-of-two pod count <= available that divides the batch."""
    pods = 1
    while pods * 2 <= available_pods and \
            global_batch % (pods * 2) == 0:
        pods *= 2
    return ElasticPlan(old_pods, pods, pod_shape, global_batch)


@dataclasses.dataclass
class FaultToleranceManager:
    """Glue: drives heartbeat + straggler checks and restart decisions."""

    heartbeat: HeartbeatMonitor
    stragglers: StragglerDetector
    checkpoint_dir: str
    workers: Sequence[str] = ()

    def on_step(self, worker: str, step_seconds: float) -> None:
        self.heartbeat.beat(worker)
        self.stragglers.observe(worker, step_seconds)

    def health_check(self) -> Dict[str, List[str]]:
        return {"dead": self.heartbeat.dead_workers(self.workers),
                "stragglers": self.stragglers.stragglers()}

    def should_restart(self) -> bool:
        return bool(self.health_check()["dead"])
