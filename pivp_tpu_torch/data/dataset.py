"""Processed robot-push dataset: map.csv loader, train/val split, and a
host-side batcher that yields time-major batches.

The port's own copy (numpy only) of `pivp_tpu/data/dataset.py`, with the
artifact contract of the reference ETL: a `map.csv` with header
`id, img_bitmap_path, img_np_path, action_np_path, state_np_path,
img_bitmap_pred_path, img_np_pred_path`, per-sequence
`image_batch_j.npy` (T, 64, 64, 3 float32 in [0,1]) and
`action_batch_j.npy` / `state_batch_j.npy` (T, 1, 5). Batches are
NHWC and time-major (T, B, ...); an epoch-permuted index stream gives
the semantics of chainer's SerialIterator (shuffled, without
replacement, repeating). `lazy_sequences` reads each sequence from disk
when a batch gathers it, so host memory holds one batch, not the data
set.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray]


def load_map_csv(data_dir: str) -> List[List[str]]:
    path = os.path.join(data_dir, "map.csv")
    rows: List[List[str]] = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            rows.append(row)
    if len(rows) <= 1:
        raise ValueError(f"No file map found in {path}")
    return rows


def load_sequences(data_dir: str,
                   limit: Optional[int] = None) -> Arrays:
    """Load every sequence referenced by map.csv into RAM (the dataset is
    small: 264 sequences x 10 x 64x64x3). Returns
    (images (N, T, H, W, C), actions (N, T, A), states (N, T, S))."""
    rows = load_map_csv(data_dir)[1:]
    if limit:
        rows = rows[:limit]
    images, actions, states = [], [], []
    for row in rows:
        images.append(np.load(os.path.join(data_dir, row[2]))
                      .astype(np.float32))
        actions.append(_squeeze_mid(np.load(os.path.join(data_dir, row[3]))
                                    .astype(np.float32)))
        states.append(_squeeze_mid(np.load(os.path.join(data_dir, row[4]))
                                   .astype(np.float32)))
    return (np.stack(images), np.stack(actions), np.stack(states))


def _squeeze_mid(x: np.ndarray) -> np.ndarray:
    """(T, 1, D) -> (T, D): the reference stores a singleton batch axis
    (make_dataset.py:78-81) squeezed at collation (train_model.py:64-66)."""
    return x[:, 0, :] if x.ndim == 3 and x.shape[1] == 1 else x


class LazySequences:
    """Array-like view over per-sequence .npy files that reads rows on
    demand (one plain file read per gathered sequence).

    `load_sequences` holds the whole data set in RAM, which caps its
    size at host memory. This view has exactly the operations the
    training pipeline uses (`len` / `.shape[0]`, contiguous slicing for
    the train/val split, fancy-index row gathers for batching), so it
    stands in for any of the three arrays while holding only the current
    batch in memory."""

    def __init__(self, paths: List[str], squeeze: bool = False):
        if not paths:
            raise ValueError("Empty dataset")
        self._paths = list(paths)
        self._squeeze = squeeze
        first = self._load(0)
        self.shape = (len(self._paths),) + first.shape
        self.dtype = first.dtype

    def _load(self, i: int) -> np.ndarray:
        # Each file is one sequence and is read whole.
        x = np.load(self._paths[i]).astype(np.float32, copy=False)
        return _squeeze_mid(x) if self._squeeze else x

    def __len__(self) -> int:
        return len(self._paths)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            view = LazySequences.__new__(LazySequences)
            view._paths = self._paths[idx]
            view._squeeze = self._squeeze
            view.shape = (len(view._paths),) + self.shape[1:]
            view.dtype = self.dtype
            return view
        idx = np.asarray(idx)
        if idx.ndim == 0:
            return self._load(int(idx))
        return np.stack([self._load(int(i)) for i in idx])


def lazy_sequences(data_dir: str, limit: Optional[int] = None) -> Arrays:
    """The deferred-read counterpart of `load_sequences`: three
    LazySequences views with the same map.csv contract. Peak host memory
    is one batch, not the data set."""
    rows = load_map_csv(data_dir)[1:]
    if limit:
        rows = rows[:limit]
    return (  # type: ignore[return-value]
        LazySequences([os.path.join(data_dir, r[2]) for r in rows]),
        LazySequences([os.path.join(data_dir, r[3]) for r in rows],
                      squeeze=True),
        LazySequences([os.path.join(data_dir, r[4]) for r in rows],
                      squeeze=True),
    )


def train_val_split(arrays: Arrays, split: float = 0.95
                    ) -> Tuple[Arrays, Arrays]:
    """Leading-fraction split, same as train_model.py:836-845."""
    n = arrays[0].shape[0]
    idx = int(np.floor(split * n))
    train = tuple(a[:idx] for a in arrays)
    val = tuple(a[idx:] for a in arrays)
    return train, val  # type: ignore[return-value]


def to_time_major(images: np.ndarray, actions: np.ndarray,
                  states: np.ndarray) -> Arrays:
    """(B, T, ...) -> (T, B, ...) — the collation contract of
    concat_examples (train_model.py:51-71), minus its NCHW roll."""
    return (np.ascontiguousarray(np.swapaxes(images, 0, 1)),
            np.ascontiguousarray(np.swapaxes(actions, 0, 1)),
            np.ascontiguousarray(np.swapaxes(states, 0, 1)))


class EpochBatcher:
    """Shuffled, without-replacement, repeating batch stream (semantics of
    chainer SerialIterator(repeat=True, shuffle=True) at
    train_model.py:914). Tracks epoch boundaries for the epoch-level
    bookkeeping the reference training loop does (965-979).

    Partial final batches are padded by wrapping to the start of the next
    permutation so every batch has the same shape.
    """

    def __init__(self, arrays: Arrays, batch_size: int, seed: int = 0):
        self.arrays = arrays
        self.batch_size = batch_size
        self.n = arrays[0].shape[0]
        if self.n == 0:
            raise ValueError("Empty dataset")
        self._rng = np.random.RandomState(seed)
        self._perm = self._rng.permutation(self.n)
        self._pos = 0
        self.epoch = 0
        self.is_new_epoch = False

    def next_indices(self) -> np.ndarray:
        """Advance one batch and return its (batch_size,) sequence
        indices — the shuffle/epoch bookkeeping without the gather."""
        idx = np.empty((self.batch_size,), np.int64)
        filled = 0
        self.is_new_epoch = False
        while filled < self.batch_size:
            take = min(self.batch_size - filled, self.n - self._pos)
            idx[filled:filled + take] = \
                self._perm[self._pos:self._pos + take]
            filled += take
            self._pos += take
            if self._pos >= self.n:
                self._perm = self._rng.permutation(self.n)
                self._pos = 0
                self.epoch += 1
                self.is_new_epoch = True
        return idx

    def seek(self, num_batches: int) -> None:
        """Fast-forward the shuffle/epoch state as if `num_batches`
        batches had been drawn, without touching the data.

        Used for deterministic resume: a restored run seeks to the
        checkpointed step count and then draws exactly the batches the
        uninterrupted run would have (tested bit-identical to replaying
        `next_indices`). Only the permutation RNG advances — O(epochs
        crossed), not O(rows gathered)."""
        if num_batches < 0:
            raise ValueError(f"cannot seek backwards ({num_batches})")
        consumed = self._pos + num_batches * self.batch_size
        # next_indices regenerates the permutation the moment _pos
        # reaches n (even mid-batch), so the number of regenerations is
        # exactly the number of n-boundaries the row stream crosses.
        for _ in range(consumed // self.n):
            self._perm = self._rng.permutation(self.n)
            self.epoch += 1
        self._pos = consumed % self.n
        self.is_new_epoch = False

    def next(self) -> Arrays:
        idx = self.next_indices()
        images, actions, states = self.arrays
        return to_time_major(images[idx], actions[idx], states[idx])

    def __iter__(self) -> Iterator[Arrays]:
        while True:
            yield self.next()


def eval_batches(arrays: Arrays, batch_size: int
                 ) -> Iterator[Tuple[Arrays, int]]:
    """One pass over the validation set, yielding ((imgs, acts, stas),
    n_valid). The final partial batch is padded by repeating the last
    sequence (every batch has one shape); `n_valid` is the number of
    REAL rows — consumers must mask columns >= n_valid out of per-sample
    metrics so padded duplicates never bias validation statistics."""
    images, actions, states = arrays
    n = images.shape[0]
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        sel = np.arange(start, end)
        if end - start < batch_size:
            pad = np.full((batch_size - (end - start),), end - 1, np.int64)
            sel = np.concatenate([sel, pad])
        yield (to_time_major(images[sel], actions[sel], states[sel]),
               end - start)
