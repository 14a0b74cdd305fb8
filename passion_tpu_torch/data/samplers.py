"""Index samplers for composing epoch streams (reference ``data/sampler.py``;
a copy of ``passion_tpu/data/samplers.py``).

The reference ships four samplers no driver imports (SURVEY §2.7-4 calls the
module vestigial, and its ``RandomSampler`` even contains an unexercised
``np.random.RandomSatate`` typo at sampler.py:80).  They are still public
API, so we provide working equivalents — pure numpy, no torch, every one
seeded through an explicit ``np.random.Generator`` so streams are
reproducible and checkpointable (the same per-(seed, epoch) discipline as
:mod:`passion_tpu_torch.data.loader`):

* :class:`RandomCycleIter`  — sampler.py:10-26: endless shuffled cycling
  over a finite index set, reshuffling at each wrap.
* :class:`MSampler`         — sampler.py:29-54: multi-source batch
  interleaving; slot ``i`` of every batch always draws from the source that
  owns slot ``i`` (sources sized by ``batch_sizes``), yielding
  ``(source, index)`` pairs.
* :class:`CycleSampler`     — sampler.py:57-72: a fixed-length stream of
  ``num_samples`` indices drawn by cycling one shuffled range.
* :class:`RandomSampler`    — sampler.py:75-92: one random permutation per
  epoch with get/set-state checkpointing (fixed here: the reference's state
  never influenced its output because the permutation came from torch while
  the state belonged to the broken numpy RNG).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


class RandomCycleIter:
    """Endless iterator over ``data``; reshuffles each time it wraps.

    Matches sampler.py:10-26 semantics: the FIRST pass reshuffles
    immediately (the reference initializes ``i = len - 1`` so the very first
    ``next`` triggers a shuffle).
    """

    def __init__(self, data: Sequence[int], *,
                 rng: Optional[np.random.Generator] = None,
                 seed: Optional[int] = None):
        self._data = np.asarray(list(data))
        if self._data.size == 0:
            raise ValueError("RandomCycleIter needs a non-empty index set")
        self._rng = rng if rng is not None else np.random.default_rng(seed)
        self._i = self._data.size - 1

    def __iter__(self) -> "RandomCycleIter":
        return self

    def __next__(self) -> int:
        self._i += 1
        if self._i == self._data.size:
            self._i = 0
            self._rng.shuffle(self._data)
        return int(self._data[self._i])


class MSampler:
    """Multi-source batch interleaver (sampler.py:29-54).

    ``batch_sizes[k]`` slots of every conceptual batch draw from source
    ``k`` (which has ``sizes[k]`` items).  Iterating yields
    ``(source_id, index_within_source)`` pairs in slot order, for
    ``num_samples`` total draws.
    """

    def __init__(self, batch_sizes: Sequence[int], sizes: Sequence[int],
                 num_samples: Optional[int] = None,
                 num_iters: Optional[int] = None,
                 seed: Optional[int] = None):
        if len(batch_sizes) != len(sizes):
            raise ValueError("batch_sizes and sizes must align per source")
        self.batch_size = int(sum(batch_sizes))
        # slot -> source ownership table, exactly the reference's layout:
        # the first batch_sizes[0] slots belong to source 0, and so on.
        self._slot_source = np.repeat(
            np.arange(len(batch_sizes)), np.asarray(batch_sizes, dtype=int))
        if num_samples is not None:
            self.num_samples = int(num_samples)
        elif num_iters is not None:
            self.num_samples = int(num_iters) * self.batch_size
        else:
            self.num_samples = int(sum(sizes))
        root = np.random.default_rng(seed)
        self._iters = [
            RandomCycleIter(range(n), rng=np.random.default_rng(root.integers(2**63)))
            for n in sizes
        ]

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        for i in range(self.num_samples):
            src = int(self._slot_source[i % self.batch_size])
            yield src, next(self._iters[src])

    def __len__(self) -> int:
        return self.num_samples


class CycleSampler:
    """Fixed-length index stream by cycling one shuffled range
    (sampler.py:57-72)."""

    def __init__(self, size: int, num_samples: Optional[int] = None,
                 num_epochs: int = 0, seed: Optional[int] = None):
        self.num_samples = int(num_samples) if num_samples else size * num_epochs
        self._iter = RandomCycleIter(range(size), seed=seed)

    def __iter__(self) -> Iterator[int]:
        for _ in range(self.num_samples):
            yield next(self._iter)

    def __len__(self) -> int:
        return self.num_samples


class RandomSampler:
    """One fresh permutation of the data source per epoch (sampler.py:75-92).

    Unlike the reference — whose ``get_state``/``set_state`` were dead knobs
    on a mistyped RNG while the actual permutation came from torch's global
    stream — the permutation here is a pure function of the generator state,
    so ``set_state(get_state())`` replays the stream exactly (the same
    resume-determinism contract as engine/checkpoint.py).
    """

    def __init__(self, data_source: Sequence, state=None,
                 seed: Optional[int] = None):
        self.data_source = data_source
        self._rng = np.random.default_rng(seed)
        if state is not None:
            self.set_state(state)

    def __iter__(self) -> Iterator[int]:
        return iter(self._rng.permutation(len(self.data_source)).tolist())

    def __len__(self) -> int:
        return len(self.data_source)

    def get_state(self):
        return self._rng.bit_generator.state

    def set_state(self, state) -> None:
        self._rng.bit_generator.state = state
