"""Fused device-resident frontier scoring on a hand-written Triton kernel.

The port's twin of the reference's ``core/devicecost.py``.  An entire
:class:`~repro_torch.core.hardware.HardwareProfile` is packed once into
device-resident *parameter banks* (:class:`DeviceTable`), and a frontier
— parallel ``(model_id, size, weight, tile_segment)`` arrays in the
layout :mod:`repro_torch.core.batchcost` packs — is scored by one kernel
launch that

1. gathers each record's parameters from per-kind stacked banks and
   evaluates all three families branch-free (the canonical 4-feature
   linear basis ``[x, ln x, ln ln x, x ln x]``, a sum of sigmoids, and a
   k=4 inverse-log-distance knn), selecting by kind;
2. reduces records to per-design totals.

**Kernel K0** (:func:`bank_score`, Triton) replaces the reference's
jitted XLA scorer ``bank_predict`` + ``_score_kernel`` / ``_sweep_kernel``
(``repro/core/devicecost.py:328-406``).  Its grid is (design, block of
``_BLOCK_W`` workload rows): a program gathers the bank rows of its
design's records once, evaluates a ``[_BLOCK_W, _BLOCK_R]`` tile of
(workload, record) cells, loops over record blocks only for a design
longer than ``_BLOCK_R``, reduces along records and stores each of its
``(w, design)`` totals once — no read-add-write, no float atomics — so a
score is bit-for-bit reproducible run to run.  The flat frontier form is
the ``W = 1`` case of the same body.  What bounds it on the H100: bytes,
``(4 + 8 W) R`` of ids, sizes and weights (the banks are a few KB and
stay in L1/L2), against a few dozen flops per cell; in practice the
precise ``logf``/``expf`` of libdevice cost several times that count.
The knn top-4 runs in registers, an insertion network over the support
points under the ``WITH_KNN`` constexpr, so profiles without knn models
never pay for it.

:func:`bank_predict` is the plain PyTorch version of the per-record
evaluation (differentiable in ``x``, for the search slice) and
:func:`bank_score_plain` adds the plain segment reduction.  The wrapper
takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.

Layout: K0 reads the real records only.  Each design owns the tiles
between its two per-segment cuts (:func:`segment_cuts`, over the
unpadded tile segments), so the reference's power-of-two pad rows —
weight 0, owned by the last design — are never stored or read, and
dropping them changes no total.  :func:`to_device_sweep` lays a sweep
(or, with ``W = 1``, a frontier) out once: when it holds at most
``_MAX_FUSED_RECORDS`` (workload, record) cells it stays resident on the
device, and every later score is one launch with no host->device copy;
a larger grid stays on the host and streams through in chunks of at
most :func:`sweep_chunk` records, each ending on a design boundary
(:func:`chunk_bounds`).  Bank widths are fixed per process, which makes
a what-if-hardware question a pure parameter-table swap: a new profile
builds new banks of identical shape and reuses the compiled kernel —
:func:`specialisation_count` counts the kernel specialisations asked for
and must not move across a swap.

Several devices: a profile's banks are built once and committed to each
device that scores with them once (:func:`device_table`,
:func:`_banks_on`).  The reference's pmap becomes one K0 launch per part
(:func:`score_parts`): the packed grid is cut into contiguous,
tile-aligned design ranges by its ``split``, each part is scored on its
own device and the totals are joined in order.  ``shard=None`` splits
once a grid clears :func:`shard_threshold`; ``shard=True`` splits on one
device too.  Every path (resident, chunked, split) reduces each design's
records in one float32 pass that starts at the design's first record,
so split totals equal the flat call's bit for bit.

Totals agree with the scalar oracle to <=1e-6 relative (banked float32
evaluation; the segment reduction runs in float32).
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.core import memo
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.memo import MEMO_LOCK
from repro_torch.core.models import _BASES, KNN_SENTINEL, _sigmoid
from repro_torch.kernels import build, counter
from repro_torch.testing import faults

# ---------------------------------------------------------------------------
# Level-2 model-name interning: frontier records refer to models by id.
# Guarded by the shared memo lock: a torn read of (_MODEL_IDS,
# _MODEL_NAMES) under concurrent threads could hand two models one id.
# ---------------------------------------------------------------------------
_MODEL_IDS: Dict[str, int] = {}
_MODEL_NAMES: List[str] = []


def model_id(name: str) -> int:
    mid = _MODEL_IDS.get(name)
    if mid is None:
        with MEMO_LOCK:
            mid = _MODEL_IDS.get(name)
            if mid is None:
                mid = len(_MODEL_NAMES)
                _MODEL_NAMES.append(name)
                _MODEL_IDS[name] = mid
    return mid


def _capture_model_names() -> List[str]:
    with MEMO_LOCK:
        return list(_MODEL_NAMES)


def _restore_model_remap(names: List[str]) -> np.ndarray:
    """old interned id -> live id, re-interning every snapshotted name."""
    return np.asarray([model_id(n) for n in names], dtype=np.int32)


memo.register_snapshot_env("model_ids", _capture_model_names,
                           _restore_model_remap)


KIND_LINEAR, KIND_SIGMOID, KIND_KNN = 0, 1, 2

#: canonical feature positions of each basis' weight vector, in order —
#: e.g. nlogn's basis is [x ln x, x], landing at canonical slots (3, 0)
_CANONICAL_SLOTS = {
    "linear": (0,),
    "log_linear": (0, 1),
    "log_loglog": (0, 1, 2),
    "nlogn": (3, 0),
}

#: fixed per-process bank widths; profiles needing more grow to the next
#: power of two (a width change is one new kernel specialisation)
_SIG_SLOTS = 4
_KNN_SLOTS = 16

#: the device-memory ceiling of one K0 launch, in (workload row, record)
#: cells: a grid this large or smaller is kept resident on the device
#: (8 bytes a cell of float32 sizes and weights, so at most 512 MiB — and
#: 4 GiB for the 8 sweeps the sweep cache holds) and scored in one
#: launch; a larger one streams through in chunks of sweep_chunk records
_MAX_FUSED_RECORDS = 1 << 26

#: records per reduction tile: packing pads every design's record block
#: to a multiple of TILE (pad rows carry weight 0)
TILE = 8

#: K0's tile: _BLOCK_W workload rows x _BLOCK_R records per program step.
#: The main frontier's designs hold 8-40 records (3-4 tiles for 91% of
#: them), so 32 records cover nearly every design in one step; 16 rows
#: keep 4 cells a thread at 4 warps, and W = 64 makes 4 programs a design
_BLOCK_W = 16
_BLOCK_R = 32
_NUM_WARPS = 4

_BANK_KEYS = ("kinds", "lin_w", "lin_y0", "sig_c", "sig_k", "sig_x0",
              "sig_y0", "knn_lx", "knn_y", "xlo", "xhi")


def _pow2(n: int, floor: int) -> int:
    return max(1 << max(n - 1, 0).bit_length(), floor)


@dataclasses.dataclass(frozen=True)
class DeviceTable:
    """One profile's parameter banks, resident on one device.

    ``banks`` holds the tensors the scorer reads; the remaining fields are
    host-side metadata (row validity, interning watermark) used to
    validate frontiers and to decide when a table must be rebuilt.
    """

    profile_name: str
    banks: Dict[str, torch.Tensor]   # kinds/lin_*/sig_*/knn_*/xlo/xhi, [M,...]
    avail: np.ndarray                # bool [M] — rows backed by a fitted model
    n_interned: int                  # len(_MODEL_NAMES) at build time
    sig_slots: int
    knn_slots: int
    has_knn: bool                    # kernel constexpr: skip the top-4 when False
    models_ref: int                  # id() of the models dict banked here
    device: torch.device


def resolve(device: Optional[runtime.DeviceLike] = None) -> torch.device:
    """:func:`repro_torch.runtime.device` with the CUDA index filled in,
    so ``cuda`` and ``cuda:0`` key one layout and one bank replica."""
    dev = runtime.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _publish(dev: torch.device) -> None:
    """Drain this thread's stream on ``dev`` before the tensors it just
    filled enter a memo: the copies from pageable host memory may still
    be in flight, and another scoring slot's stream may read the tensors
    next.  A no-op on the CPU."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def build_table(hw: HardwareProfile, *, sig_slots: int = _SIG_SLOTS,
                knn_slots: int = _KNN_SLOTS,
                device: Optional[runtime.DeviceLike] = None) -> DeviceTable:
    """Pack every fitted model of ``hw`` into stacked device banks."""
    dev = resolve(device)
    for name in hw.models:
        model_id(name)          # rows must exist for every profile model
    needed_sig = max([sig_slots] + [
        len(np.atleast_1d(m.params[key]))
        for m in hw.models.values() for key in ("c", "s1_c")
        if key in m.params])
    needed_knn = max([knn_slots] + [
        len(np.atleast_1d(m.params["x"]))
        for m in hw.models.values() if m.kind == "knn"])
    sig_slots = _pow2(needed_sig, sig_slots)
    knn_slots = _pow2(needed_knn, knn_slots)

    m_rows = _pow2(len(_MODEL_NAMES), 16)
    kinds = np.zeros(m_rows, np.int32)
    lin_w = np.zeros((m_rows, 4), np.float32)
    lin_y0 = np.zeros(m_rows, np.float32)
    sig_c = np.zeros((m_rows, sig_slots), np.float32)
    sig_k = np.ones((m_rows, sig_slots), np.float32)
    sig_x0 = np.zeros((m_rows, sig_slots), np.float32)
    sig_y0 = np.zeros(m_rows, np.float32)
    knn_lx = np.full((m_rows, knn_slots), KNN_SENTINEL, np.float32)
    knn_y = np.zeros((m_rows, knn_slots), np.float32)
    xlo = np.ones(m_rows, np.float32)
    xhi = np.ones(m_rows, np.float32)
    avail = np.zeros(m_rows, bool)

    for name, model in hw.models.items():
        row = _MODEL_IDS[name]
        avail[row] = True
        xlo[row], xhi[row] = model.x_range
        p = model.params
        if model.kind in _BASES:
            for w_val, slot in zip(np.atleast_1d(p["w"]),
                                   _CANONICAL_SLOTS[model.kind]):
                lin_w[row, slot] = w_val
            lin_y0[row] = p["y0"]
        elif model.kind in ("sigmoids", "sigmoids2d"):
            prefix = "s1_" if model.kind == "sigmoids2d" else ""
            kinds[row] = KIND_SIGMOID
            n_sig = len(np.atleast_1d(p[prefix + "c"]))
            sig_c[row, :n_sig] = p[prefix + "c"]
            sig_k[row, :n_sig] = p[prefix + "k"]
            sig_x0[row, :n_sig] = p[prefix + "x0"]
            sig_y0[row] = p[prefix + "y0"]
        elif model.kind == "knn":
            kinds[row] = KIND_KNN
            n_pts = len(p["x"])
            knn_lx[row, :n_pts] = np.log(
                np.asarray(p["x"], np.float32) + 1.0)
            knn_y[row, :n_pts] = p["y"]
        else:
            raise ValueError(f"unbankable model kind: {model.kind}")

    host = {"kinds": kinds, "lin_w": lin_w, "lin_y0": lin_y0,
            "sig_c": sig_c, "sig_k": sig_k, "sig_x0": sig_x0,
            "sig_y0": sig_y0, "knn_lx": knn_lx, "knn_y": knn_y,
            "xlo": xlo, "xhi": xhi}
    banks = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    # chaos seam: a corrupt rule NaN-poisons the float banks (the int
    # gather indices stay intact), surfacing as non-finite fused totals
    # until invalidate_table() forces a clean rebuild
    banks = faults.corrupt("devicecost.banks", banks, key=hw.name)
    _publish(dev)
    return DeviceTable(hw.name, banks, avail, len(_MODEL_NAMES),
                       sig_slots, knn_slots,
                       has_knn=bool((kinds[avail] == KIND_KNN).any()),
                       models_ref=id(hw.models), device=dev)


def device_table(hw: HardwareProfile,
                 device: Optional[runtime.DeviceLike] = None
                 ) -> DeviceTable:
    """The (cached) device table of a profile on ``device``.

    A profile keeps one fitted table, built on the first device that asks
    and rebuilt when stale: when the global model-name interning has
    grown past its watermark, or when the profile's models dict is no
    longer the one that was banked.  Another device gets the same banks
    committed to it once (:func:`_banks_on`).  Bank *shapes* stay fixed
    until a power-of-two boundary crosses, so rebuilds almost never need
    a new kernel specialisation.
    """
    dev = resolve(device)

    def _current(table) -> bool:
        return table is not None and \
            table.n_interned == len(_MODEL_NAMES) and \
            table.models_ref == id(hw.models)

    with MEMO_LOCK:   # consistent staleness check vs concurrent interning
        table = hw._device_table
        current = _current(table)
    if not current:
        # scoring slots that start together build the table once: the
        # first builds (outside the memo lock), the others find it built
        with _TABLE_LOCK:
            with MEMO_LOCK:
                table = hw._device_table
                current = _current(table)
            if not current:
                table = build_table(hw, device=dev)
                with MEMO_LOCK:
                    stale = hw._device_table
                    hw._device_table = table
                    if stale is not None:
                        _BANK_REPLICAS.discard(lambda k, v: v[0] is stale)
    return _banks_on(table, dev)


def invalidate_table(hw: HardwareProfile) -> None:
    """Drop a profile's cached device table and every device's copy of
    it, so the next :func:`device_table` call rebuilds the banks from the
    fitted models (the serving tier's recovery probe relies on this)."""
    with MEMO_LOCK:
        stale = hw._device_table
        hw._device_table = None
        if stale is not None:
            _BANK_REPLICAS.discard(lambda k, v: v[0] is stale)


#: a table's banks committed to another device than the one it was built
#: on: (id(table), device) -> (table, replica).  The value holds the
#: table, so its id cannot be reused while the entry lives, and a rebuilt
#: or invalidated table discards its replicas.
_BANK_REPLICAS = memo.DictCache(maxsize=32, name="device_banks")
#: serialises table builds and replica copies (see device_table)
_TABLE_LOCK = threading.Lock()


def _banks_on(table: DeviceTable, device: torch.device) -> DeviceTable:
    """``table`` with its banks on ``device``: the table itself where it
    was built, else a replica copied once and memoized."""
    if table.device == device:
        return table
    key = (id(table), str(device))
    hit = _BANK_REPLICAS.get(key)
    if hit is not None and hit[0] is table:
        return hit[1]
    with _TABLE_LOCK:
        hit = _BANK_REPLICAS.get(key)
        if hit is not None and hit[0] is table:
            return hit[1]
        replica = dataclasses.replace(
            table, banks={k: v.to(device) for k, v in table.banks.items()},
            device=device)
        _publish(device)
        _BANK_REPLICAS.put(key, (table, replica))
    return replica


# ---------------------------------------------------------------------------
# Plain version of K0: per-record evaluation + segment reduction
# ---------------------------------------------------------------------------
class _Sigmoid(torch.autograd.Function):
    """``_sigmoid`` with the logistic's own derivative, ``s (1 - s)``.

    The chain rule through ``1 / (1 + exp(-z))`` divides inf by inf where
    ``exp(-z)`` overflows (a steep fitted step far below its centre), so
    the gradient would be NaN where the sigmoid is flat; the reference's
    ``jax.nn.sigmoid`` differentiates as ``s (1 - s)``, and so does this.
    The value is ``_sigmoid``'s, bit for bit."""

    @staticmethod
    def forward(ctx, z):
        s = _sigmoid(z)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def bank_predict(banks: Dict[str, torch.Tensor], ids: torch.Tensor,
                 x: torch.Tensor, with_knn: bool) -> torch.Tensor:
    """Per-record model evaluation against stacked parameter banks.

    ``ids`` is ``[R]``; ``x`` is ``[..., R]`` — any number of leading
    batch axes broadcast against the ``[R, ...]`` bank gathers through
    the trailing record dimension, so the flat and the sweep scorers
    share this body and the gathers are issued once per record.
    Differentiable in ``x`` through the linear-basis and sigmoid
    families; knn rows join through a ``topk`` gather whose gradients
    flow through the inverse log-distance weights.
    """
    ids = ids.long()
    x = torch.minimum(torch.maximum(x, banks["xlo"][ids]),
                      banks["xhi"][ids])
    lx = torch.log(x + 1.0)

    lin_w = banks["lin_w"][ids]
    lin = (x * lin_w[:, 0] + lx * lin_w[:, 1]
           + torch.log(lx + 1.0) * lin_w[:, 2] + (x * lx) * lin_w[:, 3]
           + banks["lin_y0"][ids])

    sig_k, sig_x0 = banks["sig_k"][ids], banks["sig_x0"][ids]
    sig_c = banks["sig_c"][ids]
    sig = banks["sig_y0"][ids]
    for j in range(sig_c.shape[1]):
        sig = sig + _Sigmoid.apply(sig_k[:, j] * (lx - sig_x0[:, j])) \
            * sig_c[:, j]

    kind = banks["kinds"][ids]
    y = torch.where(kind == KIND_SIGMOID, sig, lin)
    if with_knn:   # profiles without knn models skip the top-k
        klx = banks["knn_lx"][ids]
        d = torch.abs(lx[..., None] - klx) + 1e-6
        w = torch.where(klx >= KNN_SENTINEL * 0.5, torch.zeros_like(d),
                        1.0 / d)
        wk, idx = torch.topk(w, 4, dim=-1)
        yk = torch.gather(banks["knn_y"][ids].expand(w.shape), -1, idx)
        num = wk[..., 0] * yk[..., 0]
        den = wk[..., 0]
        for j in range(1, 4):
            num = num + wk[..., j] * yk[..., j]
            den = den + wk[..., j]
        knn = num / torch.clamp(den, min=1e-30)
        y = torch.where(kind == KIND_KNN, knn, y)
    return torch.clamp(y, min=0.0)


def bank_score_plain(banks: Dict[str, torch.Tensor], ids: torch.Tensor,
                     sizes: torch.Tensor, weights: torch.Tensor,
                     seg_tiles: torch.Tensor, with_knn: bool
                     ) -> torch.Tensor:
    """Plain PyTorch version of :func:`bank_score`: ``[W, n_seg]`` float32
    totals of the records in ``ids``/``sizes``/``weights`` (``[R]``,
    ``[W, R]``, ``[W, R]``; R a TILE multiple), where design ``s`` owns
    tiles ``seg_tiles[s]:seg_tiles[s + 1]`` (``seg_tiles[0] == 0``); tiles
    past the last cut, such as pad rows, enter no total."""
    y = bank_predict(banks, ids, sizes, with_knn)
    w_axis = sizes.shape[0]
    tiles = (weights * y).reshape(w_axis, -1, TILE).sum(-1)
    n_seg = seg_tiles.shape[0] - 1
    seg_of_tile = torch.repeat_interleave(
        torch.arange(n_seg, device=ids.device),
        (seg_tiles[1:] - seg_tiles[:-1]).long())
    out = torch.zeros((w_axis, n_seg), dtype=torch.float32,
                      device=ids.device)
    return out.index_add_(1, seg_of_tile, tiles[:, :seg_of_tile.shape[0]])


# ---------------------------------------------------------------------------
# Kernel K0 (Triton)
# ---------------------------------------------------------------------------
_K0_LAUNCHES = counter("bank_score")

#: kernel specialisations asked for so far: (with_knn, sig_slots,
#: knn_slots).  The Triton kernel compiles once per key (its int
#: arguments are not specialised), and the plain CPU route keys the same
#: way, so a what-if-hardware swap — same bank widths, same knn flag —
#: must add none.
_SPECIALISATIONS: set = set()


def specialisation_count() -> int:
    with MEMO_LOCK:
        return len(_SPECIALISATIONS)


def _note_specialisation(key: Tuple) -> None:
    with MEMO_LOCK:
        _SPECIALISATIONS.add(key)


#: (specialisation, device) pairs K0 has been launched with: Triton
#: compiles at a pair's first launch, which this lock serialises so two
#: scoring slots starting together never compile one kernel at once
_LAUNCHED: set = set()
_FIRST_LAUNCH_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _k0_kernel():
    """Build the Triton kernel (first use only: importing this module
    must not need Triton).  The kernel body resolves ``tl`` and ``_ld``
    through this module's globals, which is where Triton looks them up."""
    build.use_triton_cache()
    import triton
    import triton.language as tl
    globals()["tl"] = tl
    globals()["_ld"] = build.triton_libdevice()

    @triton.jit(do_not_specialize=["n_w", "stride_w", "n_seg"])
    def bank_score_kernel(kinds_ptr, lin_w_ptr, lin_y0_ptr, sig_c_ptr,
                          sig_k_ptr, sig_x0_ptr, sig_y0_ptr, knn_lx_ptr,
                          knn_y_ptr, xlo_ptr, xhi_ptr,
                          ids_ptr, sizes_ptr, weights_ptr, cuts_ptr,
                          out_ptr, n_w, stride_w, n_seg,
                          WITH_KNN: tl.constexpr, SIG: tl.constexpr,
                          KNN: tl.constexpr, TILE_R: tl.constexpr,
                          BLOCK_W: tl.constexpr, BLOCK_R: tl.constexpr):
        seg = tl.program_id(0)
        w = tl.program_id(1) * BLOCK_W + tl.arange(0, BLOCK_W)
        w_live = w < n_w
        r_lo = tl.load(cuts_ptr + seg) * TILE_R
        r_hi = tl.load(cuts_ptr + seg + 1) * TILE_R
        offs = tl.arange(0, BLOCK_R)
        acc = tl.zeros([BLOCK_W, BLOCK_R], dtype=tl.float32)
        for r0 in range(r_lo, r_hi, BLOCK_R):
            r = r0 + offs
            live = r < r_hi
            # this design's bank rows, gathered once for all BLOCK_W rows
            mid = tl.load(ids_ptr + r, mask=live, other=0)
            kind = tl.load(kinds_ptr + mid, mask=live, other=0)[None, :]
            lo = tl.load(xlo_ptr + mid, mask=live, other=1.0)[None, :]
            hi = tl.load(xhi_ptr + mid, mask=live, other=1.0)[None, :]
            w0 = tl.load(lin_w_ptr + mid * 4, mask=live, other=0.0)
            w1 = tl.load(lin_w_ptr + mid * 4 + 1, mask=live, other=0.0)
            w2 = tl.load(lin_w_ptr + mid * 4 + 2, mask=live, other=0.0)
            w3 = tl.load(lin_w_ptr + mid * 4 + 3, mask=live, other=0.0)
            ly0 = tl.load(lin_y0_ptr + mid, mask=live, other=0.0)
            cell = w_live[:, None] & live[None, :]
            at = w[:, None] * stride_w + r[None, :]
            x = tl.load(sizes_ptr + at, mask=cell, other=1.0)
            wt = tl.load(weights_ptr + at, mask=cell, other=0.0)
            x = tl.where(x < lo, lo, x)
            x = tl.where(x > hi, hi, x)
            lx = _ld.log(x + 1.0)
            lin = (x * w0[None, :] + lx * w1[None, :]
                   + _ld.log(lx + 1.0) * w2[None, :]
                   + (x * lx) * w3[None, :] + ly0[None, :])
            sig = tl.zeros([BLOCK_W, BLOCK_R], dtype=tl.float32) + tl.load(
                sig_y0_ptr + mid, mask=live, other=0.0)[None, :]
            for j in tl.static_range(SIG):
                sc = tl.load(sig_c_ptr + mid * SIG + j, mask=live, other=0.0)
                sk = tl.load(sig_k_ptr + mid * SIG + j, mask=live, other=1.0)
                sx0 = tl.load(sig_x0_ptr + mid * SIG + j, mask=live,
                              other=0.0)
                z = sk[None, :] * (lx - sx0[None, :])
                sig = sig + sc[None, :] / (1.0 + _ld.exp(-z))
            y = tl.where(kind == 1, sig, lin)
            if WITH_KNN:
                # the 4 largest inverse distances, kept sorted (b1 >= b2
                # >= b3 >= b4) while the support points stream past in
                # index order; a strict > keeps the lower index first on
                # a tie, as the plain version's top-k does
                b1 = tl.full([BLOCK_W, BLOCK_R], -1.0, tl.float32)
                b2 = b1
                b3 = b1
                b4 = b1
                y1 = tl.zeros([BLOCK_W, BLOCK_R], dtype=tl.float32)
                y2 = y1
                y3 = y1
                y4 = y1
                for j in tl.static_range(KNN):
                    klx = tl.load(knn_lx_ptr + mid * KNN + j, mask=live,
                                  other=1e9)[None, :]
                    ky = tl.load(knn_y_ptr + mid * KNN + j, mask=live,
                                 other=0.0)[None, :]
                    v = tl.abs(lx - klx) + 1e-6
                    v = tl.where(klx >= 5e8, 0.0, 1.0 / v)
                    c1 = v > b1
                    c2 = v > b2
                    c3 = v > b3
                    c4 = v > b4
                    b4 = tl.where(c3, b3, tl.where(c4, v, b4))
                    y4 = tl.where(c3, y3, tl.where(c4, ky, y4))
                    b3 = tl.where(c2, b2, tl.where(c3, v, b3))
                    y3 = tl.where(c2, y2, tl.where(c3, ky, y3))
                    b2 = tl.where(c1, b1, tl.where(c2, v, b2))
                    y2 = tl.where(c1, y1, tl.where(c2, ky, y2))
                    b1 = tl.where(c1, v, b1)
                    y1 = tl.where(c1, ky, y1)
                num = b1 * y1 + b2 * y2 + b3 * y3 + b4 * y4
                den = b1 + b2 + b3 + b4
                knn = num / tl.where(den < 1e-30, 1e-30, den)
                y = tl.where(kind == 2, knn, y)
            y = tl.where(y < 0.0, 0.0, y)
            acc += tl.where(cell, wt * y, 0.0)
        # this program alone owns these totals: one plain store each
        tl.store(out_ptr + w * n_seg + seg, tl.sum(acc, axis=1),
                 mask=w_live)

    return bank_score_kernel


def bank_score(banks: Dict[str, torch.Tensor], ids: torch.Tensor,
               sizes: torch.Tensor, weights: torch.Tensor,
               seg_tiles: torch.Tensor, with_knn: bool) -> torch.Tensor:
    """Kernel K0: ``[W, n_seg]`` float32 totals (see
    :func:`bank_score_plain` for the contract).  CPU tensors take the
    plain version; CUDA tensors launch the Triton kernel, one launch for
    the whole grid.  ``sizes``/``weights`` may be row slices of a wider
    grid (unit stride along records, a shared row stride)."""
    sig_slots = int(banks["sig_c"].shape[1])
    knn_slots = int(banks["knn_lx"].shape[1])
    _note_specialisation((bool(with_knn), sig_slots, knn_slots))
    dev = ids.device
    if dev.type == "cpu":
        return bank_score_plain(banks, ids, sizes, weights, seg_tiles,
                                with_knn)
    if dev.type != "cuda":
        raise ValueError(f"bank_score runs on cpu or cuda, not {dev}")
    bank_list = [banks[k] for k in _BANK_KEYS]
    for t in bank_list + [ids, sizes, weights, seg_tiles]:
        if t.device != dev:
            raise ValueError(f"bank_score needs every tensor on {dev}")
    for t in bank_list + [ids, seg_tiles]:
        if not t.is_contiguous():
            raise ValueError("bank_score needs contiguous banks, ids and "
                             "segment cuts")
    if ids.dtype != torch.int32 or seg_tiles.dtype != torch.int32 or \
            sizes.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("bank_score takes int32 ids/seg_tiles and float32 "
                        "sizes/weights")
    if sizes.dim() != 2 or sizes.shape != weights.shape or \
            sizes.shape[1] != ids.shape[0] or ids.shape[0] % TILE or \
            sizes.stride() != weights.stride() or \
            (sizes.shape[1] > 1 and sizes.stride(1) != 1):
        raise ValueError("bank_score needs ids [R] and sizes/weights "
                         "[W, R] with R a TILE multiple, unit record "
                         "stride and one row stride")
    w_axis, n_rec = int(sizes.shape[0]), int(sizes.shape[1])
    stride_w = int(sizes.stride(0))
    if w_axis * max(stride_w, n_rec) >= 1 << 31:
        raise ValueError("bank_score indexes in int32: split the grid")
    n_seg = int(seg_tiles.shape[0]) - 1
    if n_seg <= 0 or w_axis == 0 or n_rec == 0:
        return torch.zeros((w_axis, max(n_seg, 0)), dtype=torch.float32,
                           device=dev)
    stream = torch.cuda.current_stream(dev)
    if stream != torch.cuda.default_stream(dev):
        # a scoring slot's own stream reads layouts and banks that other
        # streams allocated: keep their memory from being handed out
        # again until this launch is done with it
        for t in bank_list + [ids, sizes, weights, seg_tiles]:
            t.record_stream(stream)
    # every (w, design) total is stored by its program, empty designs too
    out = torch.empty((w_axis, n_seg), dtype=torch.float32, device=dev)
    grid = (n_seg, -(-w_axis // _BLOCK_W))

    def launch():
        with torch.cuda.device(dev):
            _k0_kernel()[grid](
                *bank_list, ids, sizes, weights, seg_tiles, out, w_axis,
                stride_w, n_seg, WITH_KNN=bool(with_knn), SIG=sig_slots,
                KNN=knn_slots, TILE_R=TILE, BLOCK_W=_BLOCK_W,
                BLOCK_R=_BLOCK_R, num_warps=_NUM_WARPS)

    first = (bool(with_knn), sig_slots, knn_slots, dev)
    if first in _LAUNCHED:
        launch()
    else:
        with _FIRST_LAUNCH_LOCK:
            launch()
            _LAUNCHED.add(first)
    _K0_LAUNCHES.hit()
    return out


# ---------------------------------------------------------------------------
# Layout around K0: real-record cuts, device residency, chunks
# ---------------------------------------------------------------------------
def segment_cuts(tile_segments: np.ndarray, n_segments: int) -> np.ndarray:
    """Per-segment tile cuts over the real records: design ``s`` owns
    tiles ``cuts[s]:cuts[s + 1]`` of the sorted, unpadded
    ``tile_segments`` (a design without records owns none)."""
    return np.searchsorted(np.asarray(tile_segments),
                           np.arange(n_segments + 1),
                           side="left").astype(np.int32)


def sweep_chunk(w_axis: int) -> int:
    """Largest per-chunk record count of a W-workload sweep: keeps
    W x chunk under the device-memory ceiling, cut on tile boundaries so
    no design block is ever split mid-tile."""
    return max((_MAX_FUSED_RECORDS // max(w_axis, 1)) // TILE * TILE,
               TILE)


def chunk_bounds(cuts: np.ndarray, step: int) -> List[Tuple[int, int]]:
    """The ``(first, end)`` tile ranges a grid past the ceiling streams
    through, ``step`` tiles at most: each ends on a design boundary, and
    a design longer than ``step`` tiles gets a chunk of its own.  So a
    chunk holds whole designs, and K0 reduces every design in one pass
    as in the resident layout: chunked, resident and split layouts give
    each design the same float32 total."""
    bounds: List[Tuple[int, int]] = []
    n_tiles = int(cuts[-1]) if len(cuts) else 0
    lo = 0
    while lo < n_tiles:
        hi = int(cuts[np.searchsorted(cuts, lo + step, side="right") - 1])
        if hi <= lo:
            hi = int(cuts[np.searchsorted(cuts, lo, side="right")])
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One host->device copy (the only one a score makes)."""
    return torch.tensor(a, device=dev)


@dataclasses.dataclass(frozen=True)
class DeviceSweep:
    """A ``[W, R]`` grid of records laid out for K0 once (a frontier is
    the ``W = 1`` case).

    ``cuts`` (:func:`segment_cuts`) hold each design's tiles over the
    real records.  When the grid has at most ``_MAX_FUSED_RECORDS``
    cells, ``arrays`` — ids, sizes, weights and cuts — are tensors
    resident on ``device`` and a score is one K0 launch with no copy;
    otherwise they are float32/int32 host arrays that a score streams to
    the device in chunks.  The host ids and tile segments serve the
    availability check and the chunk layout."""

    host_ids: np.ndarray        # int32 [R]
    tile_segments: np.ndarray   # [R // TILE], sorted ascending
    cuts: np.ndarray            # int32 [n_segments + 1]
    arrays: Tuple               # (ids, sizes, weights, cuts)
    n_segments: int
    device: torch.device
    resident: bool

    @property
    def w_axis(self) -> int:
        return int(self.arrays[1].shape[0])


def to_device_sweep(ids, sizes, weights, tile_segments, n_segments: int,
                    device: Optional[runtime.DeviceLike] = None
                    ) -> DeviceSweep:
    """Lay out a sweep (``sizes``/``weights`` ``[W, R]``, ``ids`` ``[R]``,
    TILE-aligned per design, ``tile_segments`` sorted ascending) for K0:
    its real-record cuts, and the grid itself on the device when it fits
    the ceiling."""
    dev = resolve(device)
    host_ids = np.asarray(ids, np.int32)
    tiles = np.asarray(tile_segments)
    cuts = segment_cuts(tiles, n_segments)
    host = (host_ids, np.asarray(sizes, np.float32),
            np.asarray(weights, np.float32), cuts)
    resident = host[1].size <= _MAX_FUSED_RECORDS
    arrays = tuple(_to_device(a, dev) for a in host) if resident else host
    if resident:
        _publish(dev)
    return DeviceSweep(host_ids, tiles, cuts, arrays, n_segments, dev,
                       resident)


def _check_frontier(table: DeviceTable, ids: np.ndarray) -> None:
    if len(ids) and not table.avail[ids].all():
        missing = sorted({_MODEL_NAMES[m] for m in np.unique(ids)
                          if not table.avail[m]})
        raise KeyError(f"profile {table.profile_name!r} has no fitted "
                       f"model for: {missing}")


def _score_chunks(table: DeviceTable, ds: DeviceSweep) -> torch.Tensor:
    """Float64 ``[W, n_segments]`` totals of a grid past the ceiling: one
    K0 launch per :func:`chunk_bounds` chunk, each copied to the device
    and given its designs' cuts."""
    ids, sizes, weights, cuts = ds.arrays
    dev = table.device
    totals = torch.zeros((ds.w_axis, ds.n_segments), dtype=torch.float64,
                         device=dev)
    for t_lo, t_hi in chunk_bounds(cuts, sweep_chunk(ds.w_axis) // TILE):
        seg_lo = int(ds.tile_segments[t_lo])
        seg_hi = int(ds.tile_segments[t_hi - 1]) + 1
        local = np.clip(cuts[seg_lo:seg_hi + 1], t_lo, t_hi) - t_lo
        rows = slice(t_lo * TILE, t_hi * TILE)
        part = bank_score(table.banks, _to_device(ids[rows], dev),
                          _to_device(sizes[:, rows], dev),
                          _to_device(weights[:, rows], dev),
                          _to_device(local.astype(np.int32), dev),
                          table.has_knn)
        totals[:, seg_lo:seg_hi] = part.to(torch.float64)
    return totals


def _launch(table: DeviceTable, ds: DeviceSweep) -> torch.Tensor:
    """Float64 ``[W, n_segments]`` totals of one layout on its device,
    not yet read back: one K0 launch when resident, one per chunk
    otherwise."""
    if ds.resident:
        return bank_score(table.banks, *ds.arrays,
                          table.has_knn).to(torch.float64)
    return _score_chunks(table, ds)


# ---------------------------------------------------------------------------
# Several devices: parts of a grid, one K0 launch each on its own device
# ---------------------------------------------------------------------------
_SHARD_STATE: Dict[str, Optional[int]] = {"override": None}


def shard_devices(home: Optional[runtime.DeviceLike] = None
                  ) -> Tuple[torch.device, ...]:
    """The devices a grid split across devices uses, in part order: every
    visible CUDA device when ``home`` (default the runtime device) is
    CUDA, else ``home`` alone."""
    home = resolve(home)
    if home.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (home,)


def set_shard_threshold(records: Optional[int]) -> None:
    """Override the auto-split cut-over (records of a frontier, cells of
    a sweep); ``None`` restores the default."""
    with MEMO_LOCK:
        _SHARD_STATE["override"] = \
            None if records is None else max(int(records), 1)


def shard_threshold() -> int:
    """Grid size (frontier records / sweep cells) from which
    ``shard=None`` splits across devices: the :func:`set_shard_threshold`
    override, else ``_MAX_FUSED_RECORDS``, which is the reference's
    one-device answer.  The reference's calibration (one launch timed
    against the split on synthetic frontiers) is not ported: no run on
    several cards has measured the split yet, so by default only a grid
    past the resident ceiling, which streams in chunks anyway, splits."""
    override = _SHARD_STATE["override"]
    return _MAX_FUSED_RECORDS if override is None else int(override)


def shard_count(n_designs: int, n_cells: int,
                shard: Optional[bool] = None) -> int:
    """How many design-range parts a grid of ``n_designs`` designs and
    ``n_cells`` (workload, record) cells is scored in, 0 for the flat
    call: ``shard=True`` takes ``min(devices, n_designs)`` parts (one
    part on one device: the split path runs there too), ``shard=None``
    as many once there are two devices and the grid clears
    :func:`shard_threshold`, ``shard=False`` none."""
    if shard is False or n_designs <= 0:
        return 0
    n = max(min(len(shard_devices()), n_designs), 1)
    if shard is True:
        return n
    return n if n > 1 and n_cells >= shard_threshold() else 0


def score_parts(layouts: Sequence[DeviceSweep], hw: HardwareProfile
                ) -> np.ndarray:
    """``[W, n_segments]`` totals of a grid laid out as design-range
    parts (:meth:`repro_torch.core.batchcost.PackedFrontier.split`, each
    part on its own device): every part's K0 launch goes out against the
    banks committed to its device, then all are read back and joined in
    order, so the devices work at once.  Every design lies wholly in one
    part and K0 reduces it in one pass, so the totals equal the flat
    call's bit for bit."""
    pending = []
    for ds in layouts:
        table = device_table(hw, ds.device)
        _check_frontier(table, ds.host_ids)
        pending.append(_launch(table, ds))
    return faults.corrupt("devicecost.fused", np.concatenate(
        [t.cpu().numpy() for t in pending], axis=1))


def score_sweep(ds: DeviceSweep, hw: HardwareProfile,
                shard: Optional[bool] = None) -> np.ndarray:
    """``[W, n_segments]`` totals of a grid laid out by
    :func:`to_device_sweep` (a frontier is the ``W = 1`` sweep) under
    ``hw``: one K0 launch when the grid is resident, else one per chunk.
    One layout is one part on its own device, whatever ``shard`` says:
    the split across devices is cut from the packed grid
    (:meth:`repro_torch.core.batchcost.PackedSweep.score` and
    :meth:`~repro_torch.core.batchcost.PackedFrontier.score`, whose
    ``split`` is the one partition), where each part keeps its own
    layout."""
    del shard
    if ds.n_segments == 0 or ds.w_axis == 0:
        return np.zeros((ds.w_axis, ds.n_segments), np.float64)
    return score_parts([ds], hw)
