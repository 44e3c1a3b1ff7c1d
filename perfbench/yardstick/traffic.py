"""Traffic drawn from ``--seed``: token ids and prompt lengths.

Token ids are a Zipf(1.3) unigram over the vocabulary, clipped to its
last id, with labels the ids shifted by one (frozen from the port's
``data/pipeline.py``).  Every stream is a numpy generator seeded by a
``SeedSequence`` of the run's seed, the stream's code and an index, so a
seed gives the same inputs on every machine and any whole number is a
seed.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

#: stream codes: one per kind of draw, so that no two draws share a stream
STREAMS = {"train": 1, "prompts": 2, "lengths": 3, "warm": 4, "weights": 5,
           "sample": 6}

ZIPF_A = 1.3


def seed_words(seed: int, stream: str, index: int = 0) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) % (1 << 64), STREAMS[stream],
                                   int(index)])


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed_words(seed, stream, index))


def derived_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for a ``torch.Generator``, from the run's seed."""
    lo, hi = seed_words(seed, stream, index).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def zipf_tokens(r: np.random.Generator, rows: int, length: int,
                vocab: int) -> np.ndarray:
    """[rows, length] int32 ids: Zipf(1.3) clipped to ``vocab - 1``."""
    z = r.zipf(ZIPF_A, size=(rows, length))
    return np.minimum(z, vocab - 1).astype(np.int32)


def train_batch(seed: int, step: int, rows: int, seq: int, vocab: int
                ) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch: ``tokens`` and ``labels`` [rows, seq], the
    labels the tokens shifted by one."""
    t = zipf_tokens(rng(seed, "train", step), rows, seq + 1, vocab)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def prompts(seed: int, index: int, rows: int, length: int, vocab: int,
            stream: str = "prompts") -> np.ndarray:
    """Batch ``index``'s prompts [rows, length]."""
    return zipf_tokens(rng(seed, stream, index), rows, length, vocab)


def length_block(seed: int, block: int, lengths: Sequence[int],
                 per_block: Sequence[int]) -> List[int]:
    """Block ``block`` of the length schedule: each length ``per_block``
    times, in an order drawn from the seed.  Every seed sends the same
    multiset of lengths a block, so seeds change the order of the work
    and not its amount."""
    block_lengths = [int(n) for n, c in zip(lengths, per_block)
                     for _ in range(int(c))]
    order = rng(seed, "lengths", block).permutation(len(block_lengths))
    return [block_lengths[i] for i in order]


def length_schedule(seed: int, lengths: Sequence[int],
                    per_block: Sequence[int]) -> Iterator[List[int]]:
    """The blocks of :func:`length_block`, one after the other."""
    block = 0
    while True:
        yield length_block(seed, block, lengths, per_block)
        block += 1


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the
    ceil(q n)-th smallest value."""
    ordered = sorted(values)
    k = max(int(np.ceil(q * len(ordered))), 1)
    return float(ordered[k - 1])
