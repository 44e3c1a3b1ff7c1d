"""Concurrent what-if serving on the card (the port's twin of the
reference's ``repro/serving``).

A :class:`~repro_torch.serving.service.DesignCalculatorService` is a
long-lived scoring service: it holds the device-resident parameter banks
of its registered hardware profiles plus the packed-frontier/segment
caches, and answers concurrent what-if (design / hardware / workload),
workload-sweep, auto-completion and design-search questions by
coalescing a window of them into one fused scoring call (kernel K0) per
hardware profile.

Requests are admitted through bounded priority lanes (interactive vs
bulk) with optional per-session cost budgets, carry deadlines, and shed
explicitly under overload (:mod:`repro_torch.serving.admission`,
:mod:`repro_torch.serving.lanes`); the service warm-restarts from an
on-disk snapshot of the synthesis memos.  A scoring-shard pool
(:mod:`repro_torch.serving.shards`) partitions each window's product
across its slots — devices named by ``scoring_devices``, one CUDA stream
each — and merges bit-identical totals; failed or timed-out parts retry
on another slot behind a per-slot breaker, non-finite fused results fall
back fused -> fused-flat, then to the grouped oracle on the CPU only
(answers carry the producing ``engine`` tag; on the card such a group
fails with the fused error and the recovery probe rebuilds the banks),
and a supervisor resurrects a crashed worker.
"""
from repro_torch.serving.admission import (BudgetExceeded, DeadlineExceeded,
                                           RejectedError, ServiceError,
                                           ServiceStoppedError,
                                           SessionBudgets, TokenBucket,
                                           WorkerCrashed, request_cost)
from repro_torch.serving.lanes import BULK, INTERACTIVE, LaneScheduler
from repro_torch.serving.service import (DesignCalculatorService,
                                         FusedEngineDown, ServiceSession,
                                         ServiceStats)
from repro_torch.serving.shards import (NonFiniteScore, ScoringShardPool,
                                        ShardTimeout)

__all__ = [
    "DesignCalculatorService", "ServiceSession", "ServiceStats",
    "ServiceError", "RejectedError", "BudgetExceeded", "DeadlineExceeded",
    "ServiceStoppedError", "WorkerCrashed", "FusedEngineDown",
    "TokenBucket", "SessionBudgets",
    "request_cost", "LaneScheduler", "INTERACTIVE", "BULK",
    "ScoringShardPool", "ShardTimeout", "NonFiniteScore",
]
