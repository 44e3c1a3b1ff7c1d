"""Synthetic sharded token pipeline with background prefetch (the port of
``repro/data/pipeline.py``).

Deterministic per-(step, shard) numpy streams, the reference's own
``SeedSequence``s, so every batch is bit for bit the reference's and the
stream is a pure function of the step (restart-safe).  A Zipf-ish unigram
distribution over the vocab avoids degenerate uniform statistics in the
loss.  Batches are numpy arrays on the host; the trainer moves each to
its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


def synthetic_batch(step: int, batch: int, seq_len: int, vocab: int,
                    seed: int = 0, shard: int = 0, n_shards: int = 1
                    ) -> Dict[str, np.ndarray]:
    """Generate this shard's slice of the global batch for ``step``."""
    per_shard = batch // max(n_shards, 1)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))
    # zipfian unigram over the vocab (clipped) + shifted-copy labels
    z = rng.zipf(1.3, size=(per_shard, seq_len + 1))
    tokens = np.minimum(z, vocab - 1).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def make_batch(cfg: ArchConfig, shape: ShapeConfig, step: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """A full global batch (single-host path): tokens and labels, plus
    ``embeds`` for the audio family (source frames, half the sequence) and
    the VLM (its patches; the text fills the rest of the sequence)."""
    out = synthetic_batch(step, shape.global_batch, shape.seq_len,
                          cfg.vocab_size, seed)
    if cfg.family in ("audio", "vlm"):
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, 7]))
        if cfg.family == "audio":
            src = shape.seq_len // 2
            out = synthetic_batch(step, shape.global_batch, shape.seq_len // 2,
                                  cfg.vocab_size, seed)
            out["embeds"] = rng.standard_normal(
                (shape.global_batch, src, cfg.d_model)).astype(np.float32)
        else:
            txt = max(shape.seq_len - cfg.n_patches, 1)
            out = synthetic_batch(step, shape.global_batch, txt,
                                  cfg.vocab_size, seed)
            out["embeds"] = rng.standard_normal(
                (shape.global_batch, cfg.n_patches,
                 cfg.d_model)).astype(np.float32)
    return out


class DataPipeline:
    """Background-prefetching iterator over ``(step, batch)`` from
    ``start_step`` on; :meth:`close` stops and joins its thread."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, *,
                 seed: int = 0, start_step: int = 0, prefetch: int = 2):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        batch = None
        while not self._stop.is_set():
            if batch is None:
                batch = make_batch(self.cfg, self.shape, step, self.seed)
            try:
                self._queue.put((step, batch), timeout=0.1)
            except queue.Full:
                continue
            step += 1
            batch = None

    def __iter__(self) -> Iterator[Tuple[int, Dict]]:
        return self

    def __next__(self) -> Tuple[int, Dict]:
        return self._queue.get()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
