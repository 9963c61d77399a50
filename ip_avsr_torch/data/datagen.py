"""Padded datasets of variable-length sequences, as numpy on the host.

Copies of ip_avsr_tpu/data/datagen.py's ``compute_integral_len``,
``PaddedDataset`` and ``BucketedDataset``, the datasets the trainer draws its
batches from: each frame-major stream ``(sum_T, D)`` is packed once into a
dense ``(N, T_max, D)`` array, a batch is one fancy-index gather, zero
padding to the split's (or bucket's) max T, a uint8 mask and the first
frame's target per sequence.  With the same ``RandomState`` they give the
JAX package's batches bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def compute_integral_len(lengths):
    """Exclusive prefix sums of sequence lengths (frame offsets per sequence)."""
    lengths = np.asarray(lengths).reshape(-1).astype(np.int64)
    out = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=out[1:])
    return out.tolist()


class BucketedDataset:
    """Length-bucketed variant of :class:`PaddedDataset`.

    Sequences are grouped by length into a few padded shapes; ``boundaries``
    are inclusive upper bounds, and sequences longer than the last one are
    truncated to it.  By default the boundaries are the 50/75/100th
    percentiles of the lengths.
    """

    def __init__(self, streams: Sequence[np.ndarray], y, seqlens, boundaries=None):
        seqlens = np.asarray(seqlens).reshape(-1).astype(np.int64)
        if boundaries is None:
            qs = np.percentile(seqlens, [50, 75, 100]).astype(np.int64)
            boundaries = sorted(set(int(q) for q in qs))
        self.boundaries = list(boundaries)
        if self.boundaries != sorted(set(self.boundaries)):
            raise ValueError(
                f"bucket boundaries must be ascending and unique "
                f"(searchsorted assignment): {self.boundaries}")
        self.buckets = []
        self.bucket_video_idxs = []
        assignments = np.searchsorted(self.boundaries, np.minimum(
            seqlens, self.boundaries[-1]))
        offsets = np.asarray(compute_integral_len(seqlens))
        y = np.asarray(y).reshape(-1) if y is not None else None
        for b, bound in enumerate(self.boundaries):
            vid_idxs = np.nonzero(assignments == b)[0]
            self.bucket_video_idxs.append(vid_idxs)
            if len(vid_idxs) == 0:
                self.buckets.append(None)
                continue
            sub_streams = []
            for X in streams:
                X = np.asarray(X)
                frames = np.concatenate(
                    [X[offsets[i] : offsets[i] + min(int(seqlens[i]), bound)]
                     for i in vid_idxs])
                sub_streams.append(frames)
            sub_lens = np.minimum(seqlens[vid_idxs], bound)
            sub_y = (np.concatenate([
                np.full(min(int(seqlens[i]), bound), y[offsets[i]])
                for i in vid_idxs]) if y is not None else None)
            self.buckets.append(PaddedDataset(sub_streams, sub_y, sub_lens,
                                              max_timesteps=bound))

    @property
    def n(self):
        return sum(len(v) for v in self.bucket_video_idxs)

    def padded_frame_fraction(self):
        """Fraction of batch tensor frames that are padding."""
        total, valid = 0, 0
        for ds in self.buckets:
            if ds is None:
                continue
            total += ds.n * ds.max_timesteps
            valid += int(ds.seqlens.sum())
        return 1.0 - valid / total if total else 0.0

    def epoch_batches(self, batchsize, shuffle=True, rng=None, pad_to=None):
        """Iterate one epoch: batches from each bucket (bucket order
        shuffled), each of that bucket's (pad_to or batchsize, bound, D)
        shape."""
        rng = np.random if rng is None else rng
        pad_to = int(pad_to or batchsize)
        jobs = []
        for b, ds in enumerate(self.buckets):
            if ds is None:
                continue
            order = rng.permutation(ds.n) if shuffle else np.arange(ds.n)
            for start in range(0, ds.n, batchsize):
                jobs.append((b, order[start : start + batchsize]))
        if shuffle:
            job_order = rng.permutation(len(jobs))
        else:
            job_order = np.arange(len(jobs))
        for j in job_order:
            b, idxs = jobs[j]
            streams, y, mask = self.buckets[b].gather(idxs, pad_to=pad_to)
            yield b, streams, y, mask, idxs


class PaddedDataset:
    """Dense view of a multi-stream padded sequence dataset: every stream
    packed once into ``(N, T_max, D)``, batches gathered by index, with zero
    padding to the global max T, a uint8 mask and the first frame's target."""

    def __init__(self, streams: Sequence[np.ndarray], y, seqlens, max_timesteps=None):
        self.seqlens = np.asarray(seqlens).reshape(-1).astype(np.int64)
        self.n = len(self.seqlens)
        self.max_timesteps = int(max_timesteps or self.seqlens.max())
        offsets = np.asarray(compute_integral_len(self.seqlens))
        self.dense = []
        for X in streams:
            X = np.asarray(X)
            d = np.zeros((self.n, self.max_timesteps, X.shape[-1]), dtype=X.dtype)
            for i in range(self.n):
                l = min(int(self.seqlens[i]), self.max_timesteps)
                d[i, :l] = X[offsets[i] : offsets[i] + l]
            self.dense.append(d)
        self.y = np.asarray(y).reshape(-1)[offsets].astype(np.int32) if y is not None else None
        t = np.arange(self.max_timesteps)
        self.mask = (t[None, :] < self.seqlens[:, None]).astype(np.uint8)

    def gather(self, idxs, pad_to=None):
        """Return (streams, y, mask) for the given sequence indices, the batch
        axis zero-padded to ``pad_to`` when given (padded rows have an
        all-zero mask, so they add nothing to a masked loss)."""
        idxs = np.asarray(idxs)
        streams = [d[idxs] for d in self.dense]
        y = self.y[idxs] if self.y is not None else None
        mask = self.mask[idxs]
        if pad_to is not None and len(idxs) < pad_to:
            pad = pad_to - len(idxs)
            streams = [np.concatenate([s, np.zeros((pad,) + s.shape[1:], s.dtype)]) for s in streams]
            mask = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:], mask.dtype)])
            if y is not None:
                y = np.concatenate([y, np.zeros((pad,), y.dtype)])
        return streams, y, mask

    def epoch_batches(self, batchsize, shuffle=True, rng=None, drop_remainder=False,
                      pad_partial=True):
        """Iterate one epoch of batches of ``(streams, y, mask, idxs)``."""
        rng = np.random if rng is None else rng
        order = rng.permutation(self.n) if shuffle else np.arange(self.n)
        for start in range(0, self.n, batchsize):
            idxs = order[start : start + batchsize]
            if len(idxs) < batchsize:
                if drop_remainder:
                    return
                if pad_partial:
                    streams, y, mask = self.gather(idxs, pad_to=batchsize)
                    yield streams, y, mask, idxs
                    return
            streams, y, mask = self.gather(idxs)
            yield streams, y, mask, idxs
