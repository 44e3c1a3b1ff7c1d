"""Fused device-resident frontier scoring on a hand-written Triton kernel.

The port's twin of the reference's ``core/devicecost.py``.  An entire
:class:`~repro_torch.core.hardware.HardwareProfile` is packed once into
device-resident *parameter banks* (:class:`DeviceTable`), and a frontier
— parallel ``(model_id, size, weight, tile_segment)`` arrays in the
layout :mod:`repro_torch.core.batchcost` packs — is scored by one kernel
launch per chunk that

1. gathers each record's parameters from per-kind stacked banks and
   evaluates all three families branch-free (the canonical 4-feature
   linear basis ``[x, ln x, ln ln x, x ln x]``, a sum of sigmoids, and a
   k=4 inverse-log-distance knn), selecting by kind;
2. reduces records to per-design totals.

**Kernel K0** (:func:`bank_score`, Triton) replaces the reference's
jitted XLA scorer ``bank_predict`` + ``_score_kernel`` / ``_sweep_kernel``
(``repro/core/devicecost.py:328-406``).  One program owns one design
(segment) whole: it gathers the bank rows of its records once, then
walks every workload row of a ``[W, R]`` sweep against them, so the
flat frontier form is the ``W = 1`` case of the same body.  Totals are
written by their owning program only — no float atomics — so a score is
bit-for-bit reproducible run to run.  What bounds it on the H100: bytes.
Each call must read ``(4 + 8 W) R`` bytes of ids, sizes and weights
(the banks are a few KB and stay in L2), against a few dozen flops per
(record, workload) cell; the design keeps the bank gathers out of the W
loop and reads every size and weight exactly once.  The knn top-4 runs
in registers under the ``WITH_KNN`` constexpr, so profiles without knn
models never pay for it.

:func:`bank_predict` is the plain PyTorch version of the per-record
evaluation (differentiable in ``x``, for the search slice) and
:func:`bank_score_plain` adds the plain segment reduction.  The wrapper
takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.

Shapes are bucketed exactly like the reference — records pad to powers
of two and chunk at ``_MAX_FUSED_RECORDS`` (sweeps at
:func:`sweep_chunk`), and chunk totals accumulate in float64 in the
reference's order.  Bank widths are fixed per process, which makes a
what-if-hardware question a pure parameter-table swap: a new profile
builds new banks of identical shape and reuses the compiled kernel —
:func:`specialisation_count` counts the kernel specialisations asked for
and must not move across a swap.  The reference's multi-device paths
(pmap shards, the shard-threshold calibration, per-device bank replicas)
are not ported yet: ``shard=True`` raises.

Totals agree with the scalar oracle to <=1e-6 relative (banked float32
evaluation; the segment reduction runs in float32).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.core import memo
from repro_torch.core.hardware import HardwareProfile
from repro_torch.core.memo import MEMO_LOCK
from repro_torch.core.models import _BASES, KNN_SENTINEL, _sigmoid
from repro_torch.kernels import counter
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

#: largest fused record-chunk; bigger frontiers accumulate over chunks
_MAX_FUSED_RECORDS = 1 << 18

#: records per reduction tile: packing pads every design's record block
#: to a multiple of TILE (pad rows carry weight 0)
TILE = 8

#: records one K0 program evaluates per step of its loop over its design
_BLOCK_R = 64

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


def build_table(hw: HardwareProfile, *, sig_slots: int = _SIG_SLOTS,
                knn_slots: int = _KNN_SLOTS,
                device: Optional[runtime.DeviceLike] = None) -> DeviceTable:
    """Pack every fitted model of ``hw`` into stacked device banks."""
    dev = runtime.device(device)
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
    return DeviceTable(hw.name, banks, avail, len(_MODEL_NAMES),
                       sig_slots, knn_slots,
                       has_knn=bool((kinds[avail] == KIND_KNN).any()),
                       models_ref=id(hw.models), device=dev)


def device_table(hw: HardwareProfile,
                 device: Optional[runtime.DeviceLike] = None
                 ) -> DeviceTable:
    """The (cached) device table of a profile, rebuilt when stale.

    A table goes stale when the global model-name interning has grown past
    its watermark, when the profile's models dict is no longer the one
    that was banked, or when it lives on another device than the one
    asked for.  Bank *shapes* stay fixed until a power-of-two boundary
    crosses, so rebuilds almost never need a new kernel specialisation.
    """
    dev = runtime.device(device)

    def _current(table) -> bool:
        return table is not None and \
            table.n_interned == len(_MODEL_NAMES) and \
            table.models_ref == id(hw.models) and table.device == dev

    with MEMO_LOCK:   # consistent staleness check vs concurrent interning
        table = hw._device_table
        if _current(table):
            return table
    # build outside the lock; two racing threads may build duplicate
    # (equal) tables, last write wins
    table = build_table(hw, device=dev)
    with MEMO_LOCK:
        hw._device_table = table
        return table


def invalidate_table(hw: HardwareProfile) -> None:
    """Drop a profile's cached device table, so the next
    :func:`device_table` call rebuilds the banks from the fitted models."""
    with MEMO_LOCK:
        hw._device_table = None


# ---------------------------------------------------------------------------
# Plain version of K0: per-record evaluation + segment reduction
# ---------------------------------------------------------------------------
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
        sig = sig + _sigmoid(sig_k[:, j] * (lx - sig_x0[:, j])) * sig_c[:, j]

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
    tiles ``seg_tiles[s]:seg_tiles[s + 1]``."""
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


def _libdevice():
    """Triton's handle on CUDA's libdevice (precise ``expf``/``logf``);
    its import path moved between Triton releases."""
    try:
        from triton.language.extra import libdevice
        return libdevice
    except ImportError:
        pass
    try:
        from triton.language.extra.cuda import libdevice
        return libdevice
    except ImportError:
        import triton.language as tl
        return tl.math


@functools.lru_cache(maxsize=None)
def _k0_kernel():
    """Build the Triton kernel (first use only: importing this module
    must not need Triton).  The kernel body resolves ``tl`` and ``_ld``
    through this module's globals, which is where Triton looks them up."""
    import triton
    import triton.language as tl
    globals()["tl"] = tl
    globals()["_ld"] = _libdevice()

    @triton.jit(do_not_specialize=["n_w", "stride_w", "n_seg"])
    def bank_score_kernel(kinds_ptr, lin_w_ptr, lin_y0_ptr, sig_c_ptr,
                          sig_k_ptr, sig_x0_ptr, sig_y0_ptr, knn_lx_ptr,
                          knn_y_ptr, xlo_ptr, xhi_ptr,
                          ids_ptr, sizes_ptr, weights_ptr, seg_tiles_ptr,
                          out_ptr, n_w, stride_w, n_seg,
                          WITH_KNN: tl.constexpr, SIG: tl.constexpr,
                          KNN: tl.constexpr, TILE_R: tl.constexpr,
                          BLOCK_R: tl.constexpr):
        seg = tl.program_id(0)
        r_lo = tl.load(seg_tiles_ptr + seg) * TILE_R
        r_hi = tl.load(seg_tiles_ptr + seg + 1) * TILE_R
        offs = tl.arange(0, BLOCK_R)
        s_cols = tl.arange(0, SIG)
        k_cols = tl.arange(0, KNN)
        for r0 in range(r_lo, r_hi, BLOCK_R):
            r = r0 + offs
            live = r < r_hi
            mid = tl.load(ids_ptr + r, mask=live, other=0)
            kind = tl.load(kinds_ptr + mid, mask=live, other=0)
            lo = tl.load(xlo_ptr + mid, mask=live, other=1.0)
            hi = tl.load(xhi_ptr + mid, mask=live, other=1.0)
            w0 = tl.load(lin_w_ptr + mid * 4, mask=live, other=0.0)
            w1 = tl.load(lin_w_ptr + mid * 4 + 1, mask=live, other=0.0)
            w2 = tl.load(lin_w_ptr + mid * 4 + 2, mask=live, other=0.0)
            w3 = tl.load(lin_w_ptr + mid * 4 + 3, mask=live, other=0.0)
            ly0 = tl.load(lin_y0_ptr + mid, mask=live, other=0.0)
            s_off = mid[:, None] * SIG + s_cols[None, :]
            sc = tl.load(sig_c_ptr + s_off, mask=live[:, None], other=0.0)
            sk = tl.load(sig_k_ptr + s_off, mask=live[:, None], other=1.0)
            sx0 = tl.load(sig_x0_ptr + s_off, mask=live[:, None],
                          other=0.0)
            sy0 = tl.load(sig_y0_ptr + mid, mask=live, other=0.0)
            if WITH_KNN:
                k_off = mid[:, None] * KNN + k_cols[None, :]
                klx = tl.load(knn_lx_ptr + k_off, mask=live[:, None],
                              other=1e9)
                ky = tl.load(knn_y_ptr + k_off, mask=live[:, None],
                             other=0.0)
            # the bank rows above are gathered once; every workload row
            # of the sweep reuses them
            for wi in range(0, n_w):
                x = tl.load(sizes_ptr + wi * stride_w + r, mask=live,
                            other=1.0)
                wt = tl.load(weights_ptr + wi * stride_w + r, mask=live,
                             other=0.0)
                x = tl.where(x < lo, lo, x)
                x = tl.where(x > hi, hi, x)
                lx = _ld.log(x + 1.0)
                lin = (x * w0 + lx * w1 + _ld.log(lx + 1.0) * w2
                       + (x * lx) * w3 + ly0)
                z = sk * (lx[:, None] - sx0)
                sig = tl.sum(sc / (1.0 + _ld.exp(-z)), axis=1) + sy0
                y = tl.where(kind == 1, sig, lin)
                if WITH_KNN:
                    kw = tl.abs(lx[:, None] - klx) + 1e-6
                    kw = tl.where(klx >= 5e8, 0.0, 1.0 / kw)
                    num = tl.zeros([BLOCK_R], dtype=tl.float32)
                    den = tl.zeros([BLOCK_R], dtype=tl.float32)
                    for _j in tl.static_range(4):
                        best = tl.max(kw, axis=1)
                        first = tl.min(tl.where(kw == best[:, None],
                                                k_cols[None, :], KNN),
                                       axis=1)
                        hit = k_cols[None, :] == first[:, None]
                        yk = tl.sum(tl.where(hit, ky, 0.0), axis=1)
                        num += best * yk
                        den += best
                        kw = tl.where(hit, -1.0, kw)
                    knn = num / tl.where(den < 1e-30, 1e-30, den)
                    y = tl.where(kind == 2, knn, y)
                y = tl.where(y < 0.0, 0.0, y)
                part = tl.sum(tl.where(live, wt * y, 0.0), axis=0)
                # this program alone owns the total: read-add-write in
                # order, no atomics
                dst = out_ptr + wi * n_seg + seg
                tl.store(dst, tl.load(dst) + part)

    return bank_score_kernel


def bank_score(banks: Dict[str, torch.Tensor], ids: torch.Tensor,
               sizes: torch.Tensor, weights: torch.Tensor,
               seg_tiles: torch.Tensor, with_knn: bool) -> torch.Tensor:
    """Kernel K0: ``[W, n_seg]`` float32 totals (see
    :func:`bank_score_plain` for the contract).  CPU tensors take the
    plain version; CUDA tensors launch the Triton kernel."""
    sig_slots = int(banks["sig_c"].shape[1])
    knn_slots = int(banks["knn_lx"].shape[1])
    _note_specialisation((bool(with_knn), sig_slots, knn_slots))
    dev = ids.device
    if dev.type == "cpu":
        return bank_score_plain(banks, ids, sizes, weights, seg_tiles,
                                with_knn)
    if dev.type != "cuda":
        raise ValueError(f"bank_score runs on cpu or cuda, not {dev}")
    tensors = [banks[k] for k in _BANK_KEYS] + [ids, sizes, weights,
                                                seg_tiles]
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("bank_score needs contiguous tensors on "
                             f"{dev}")
    if ids.dtype != torch.int32 or seg_tiles.dtype != torch.int32 or \
            sizes.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("bank_score takes int32 ids/seg_tiles and float32 "
                        "sizes/weights")
    if sizes.dim() != 2 or sizes.shape != weights.shape or \
            sizes.shape[1] != ids.shape[0] or ids.shape[0] % TILE:
        raise ValueError("bank_score needs ids [R] and sizes/weights "
                         "[W, R] with R a TILE multiple")
    w_axis, n_seg = int(sizes.shape[0]), int(seg_tiles.shape[0]) - 1
    out = torch.zeros((w_axis, n_seg), dtype=torch.float32, device=dev)
    if n_seg == 0 or w_axis == 0:
        return out
    kernel = _k0_kernel()
    with torch.cuda.device(dev):
        kernel[(n_seg,)](*tensors, out, w_axis, int(sizes.shape[1]), n_seg,
                         WITH_KNN=bool(with_knn), SIG=sig_slots,
                         KNN=knn_slots, TILE_R=TILE, BLOCK_R=_BLOCK_R,
                         num_warps=4)
    _K0_LAUNCHES.hit()
    return out


# ---------------------------------------------------------------------------
# Chunking, padding and accumulation around K0
# ---------------------------------------------------------------------------
def _pad_records(ids: np.ndarray, sizes: np.ndarray, weights: np.ndarray,
                 tile_segments: np.ndarray, bucket: int
                 ) -> Tuple[np.ndarray, ...]:
    """Pad a tile-aligned record block to ``bucket`` rows (and its tile
    segments to ``bucket // TILE``); pad rows carry weight 0 so they
    contribute exactly nothing.  Pad segments repeat the *last* real
    segment id, keeping the segment order sorted."""
    n = len(ids)
    if n == bucket:
        return (np.asarray(ids, np.int32), np.asarray(sizes, np.float32),
                np.asarray(weights, np.float32),
                np.asarray(tile_segments, np.int32))
    pad = bucket - n
    seg_pad = bucket // TILE - len(tile_segments)
    seg_fill = tile_segments[-1] if len(tile_segments) else 0
    return (np.concatenate([ids, np.zeros(pad, ids.dtype)]).astype(np.int32),
            np.concatenate([sizes, np.ones(pad, sizes.dtype)]
                           ).astype(np.float32),
            np.concatenate([weights, np.zeros(pad, weights.dtype)]
                           ).astype(np.float32),
            np.concatenate([tile_segments,
                            np.full(seg_pad, seg_fill,
                                    tile_segments.dtype)]
                           ).astype(np.int32))


def pad_sweep(ids: np.ndarray, sizes: np.ndarray, weights: np.ndarray,
              tile_segments: np.ndarray, bucket: int
              ) -> Tuple[np.ndarray, ...]:
    """:func:`_pad_records` for sweep layouts: ``sizes``/``weights`` pad
    along their record axis (axis 1), ``ids``/``tile_segments`` stay
    1-D.  Pad ids repeat a REAL model id, so the availability check may
    run on the padded array."""
    n = len(ids)
    if n == bucket:
        return (np.asarray(ids, np.int32), np.asarray(sizes, np.float32),
                np.asarray(weights, np.float32),
                np.asarray(tile_segments, np.int32))
    pad = bucket - n
    w = sizes.shape[0]
    seg_pad = bucket // TILE - len(tile_segments)
    seg_fill = tile_segments[-1] if len(tile_segments) else 0
    pad_id = ids[-1] if n else 0
    return (np.concatenate([ids, np.full(pad, pad_id, ids.dtype)]
                           ).astype(np.int32),
            np.concatenate([sizes, np.ones((w, pad), sizes.dtype)],
                           axis=1).astype(np.float32),
            np.concatenate([weights, np.zeros((w, pad), weights.dtype)],
                           axis=1).astype(np.float32),
            np.concatenate([tile_segments,
                            np.full(seg_pad, seg_fill,
                                    tile_segments.dtype)]
                           ).astype(np.int32))


def sweep_chunk(w_axis: int) -> int:
    """Largest per-chunk record count of a W-workload sweep: keeps
    W x chunk under the fused-record ceiling, cut on tile boundaries so
    no design block is ever split mid-tile."""
    return max((_MAX_FUSED_RECORDS // max(w_axis, 1)) // TILE * TILE,
               TILE)


def to_device_sweep(ids, sizes, weights, tile_segments,
                    device: Optional[runtime.DeviceLike] = None) -> Tuple:
    """Commit padded sweep arrays to the device when they fit one fused
    chunk (a retained sweep then skips every host->device copy on repeat
    scores); multi-chunk sweeps stay host-side, where the chunk loop
    slices them."""
    if len(ids) > sweep_chunk(sizes.shape[0]):
        return ids, sizes, weights, tile_segments
    dev = runtime.device(device)
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (ids, sizes, weights, tile_segments))


def _check_frontier(table: DeviceTable, ids: np.ndarray) -> None:
    if len(ids) and not table.avail[ids].all():
        missing = sorted({_MODEL_NAMES[m] for m in np.unique(ids)
                          if not table.avail[m]})
        raise KeyError(f"profile {table.profile_name!r} has no fitted "
                       f"model for: {missing}")


def _refuse_shard(shard: Optional[bool]) -> None:
    if shard:
        raise NotImplementedError(
            "sharded scoring across several GPUs is not ported yet; "
            "score on one device (shard=None or False)")


def _accumulate(table: DeviceTable, totals: torch.Tensor, ids, sizes,
                weights, host_tiles: np.ndarray) -> None:
    """Score one padded chunk with K0 and add it into ``totals``
    (float64 ``[W, n_segments]``, on the table's device).

    The chunk's tiles belong to the contiguous segment range
    ``host_tiles[0]..host_tiles[-1]``; K0 gets that range's per-segment
    tile offsets (``templatecost.segment_ranges`` with one part per
    segment) and returns one float32 column per segment.  Adding the
    columns into their slice of ``totals`` equals the reference's
    full-width ``totals += out``: every other column would add 0.0."""
    from repro_torch.core.templatecost import segment_ranges  # circular
    dev = table.device
    seg_lo, seg_hi = int(host_tiles[0]), int(host_tiles[-1]) + 1
    n_local = seg_hi - seg_lo
    _, tile_cuts = segment_ranges(host_tiles - seg_lo, n_local, n_local)
    part = bank_score(
        table.banks, torch.as_tensor(ids, device=dev),
        torch.as_tensor(sizes, device=dev),
        torch.as_tensor(weights, device=dev),
        torch.as_tensor(tile_cuts.astype(np.int32), device=dev),
        table.has_knn)
    totals[:, seg_lo:seg_hi] += part.to(torch.float64)


def score_frontier(ids: np.ndarray, sizes: np.ndarray, weights: np.ndarray,
                   tile_segments: np.ndarray, n_segments: int,
                   hw: HardwareProfile,
                   shard: Optional[bool] = None,
                   device: Optional[runtime.DeviceLike] = None
                   ) -> np.ndarray:
    """Per-design totals for packed frontier records.

    Records must be TILE-aligned per design and ``tile_segments`` sorted
    ascending — exactly the layout
    :func:`repro_torch.core.batchcost.pack_frontier` emits.  One K0
    launch per ``_MAX_FUSED_RECORDS`` chunk.  ``device`` picks the
    device (default: :func:`repro_torch.runtime.device`); ``shard=True``
    raises until multi-GPU scoring is ported.
    """
    _refuse_shard(shard)
    if n_segments == 0:
        return np.zeros(0, np.float64)
    table = device_table(hw, device)
    _check_frontier(table, ids)
    totals = torch.zeros((1, n_segments), dtype=torch.float64,
                         device=table.device)
    for lo in range(0, max(len(ids), 1), _MAX_FUSED_RECORDS):
        chunk = slice(lo, lo + _MAX_FUSED_RECORDS)
        tile_chunk = slice(lo // TILE, (lo + _MAX_FUSED_RECORDS) // TILE)
        bucket = _pow2(len(ids[chunk]), 16)
        p_ids, p_sizes, p_weights, p_tiles = _pad_records(
            ids[chunk], sizes[chunk], weights[chunk],
            tile_segments[tile_chunk], bucket)
        _accumulate(table, totals, p_ids, p_sizes[None], p_weights[None],
                    p_tiles)
    return faults.corrupt("devicecost.fused", totals[0].cpu().numpy())


def score_sweep(ids, sizes, weights, tile_segments, n_segments: int,
                hw: HardwareProfile,
                host_ids: Optional[np.ndarray] = None,
                host_tiles: Optional[np.ndarray] = None,
                shard: Optional[bool] = None,
                device: Optional[runtime.DeviceLike] = None) -> np.ndarray:
    """Per-(workload, design) totals for a rectangular sweep.

    ``sizes``/``weights`` are ``[W, R]`` with a shared record layout
    (``ids`` ``[R]``, TILE-aligned per design, ``tile_segments`` sorted
    ascending — the layout :func:`repro_torch.core.batchcost.pack_sweep`
    emits); numpy arrays or (already padded, e.g. via
    :func:`to_device_sweep`) device tensors, in which case pass
    ``host_ids``/``host_tiles`` (host copies) so the availability check
    and the segment layout never pull arrays back from the device.
    Returns ``[W, n_segments]``.  A sweep that fits one chunk is one K0
    launch; a larger one is one launch per :func:`sweep_chunk` records,
    accumulated in float64 in the reference's order.
    """
    _refuse_shard(shard)
    w_axis = int(sizes.shape[0])
    if n_segments == 0 or w_axis == 0:
        return np.zeros((w_axis, n_segments), np.float64)
    table = device_table(hw, device)
    host_ids = np.asarray(ids) if host_ids is None else host_ids
    host_tiles = np.asarray(tile_segments) if host_tiles is None \
        else host_tiles
    _check_frontier(table, host_ids)
    chunk_r = sweep_chunk(w_axis)
    n = len(host_ids)
    totals = torch.zeros((w_axis, n_segments), dtype=torch.float64,
                         device=table.device)
    if n == _pow2(n, 16) and n <= chunk_r:
        # bucket-aligned single chunk — the steady path: PackedSweep
        # hands over cached padded device-resident arrays plus host copies
        _accumulate(table, totals, ids, sizes, weights, host_tiles)
        return faults.corrupt("devicecost.fused", totals.cpu().numpy())
    ids = host_ids
    sizes, weights = np.asarray(sizes), np.asarray(weights)
    tile_segments = host_tiles
    for lo in range(0, max(n, 1), chunk_r):
        chunk = slice(lo, lo + chunk_r)
        tile_chunk = slice(lo // TILE, (lo + chunk_r) // TILE)
        bucket = _pow2(len(ids[chunk]), 16)
        p_ids, p_sizes, p_weights, p_tiles = pad_sweep(
            ids[chunk], sizes[:, chunk], weights[:, chunk],
            tile_segments[tile_chunk], bucket)
        _accumulate(table, totals, p_ids, p_sizes, p_weights, p_tiles)
    return faults.corrupt("devicecost.fused", totals.cpu().numpy())
