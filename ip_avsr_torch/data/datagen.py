"""Batches of variable-length sequences, as numpy on the host.

The port's copy of ip_avsr_tpu/data/datagen.py.  The datasets the trainer
draws its batches from, ``PaddedDataset`` and ``BucketedDataset``: each
frame-major stream ``(sum_T, D)`` is packed once into a dense
``(N, T_max, D)`` array, a batch is one fancy-index gather, zero padding to
the split's (or bucket's) max T, a uint8 mask and the first frame's target
per sequence.  The reference's generators (utils/datagen.py):
``gen_lstm_seq_random``, ``gen_lstm_batch_random``, ``gen_lstm_batch_seq``,
``gen_seq_batch_from_idx``, the file-backed ``gen_batch_from_file`` and
``gen_file_batch_from_idx`` (an unreadable shard gives a zero sequence, as
in the reference), and ``batch_iterator``.  With the same ``RandomState``
every one gives the JAX package's batches bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ip_avsr_torch.io.matio import load_mat_file


def compute_integral_len(lengths):
    """Exclusive prefix sums of sequence lengths (frame offsets per sequence)."""
    lengths = np.asarray(lengths).reshape(-1).astype(np.int64)
    out = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=out[1:])
    return out.tolist()


def _pack_batch(X, y, seqlen, integral_lens, idxs, max_timesteps, dtype=None):
    feature_len = X.shape[1]
    bsize = len(idxs)
    dtype = X.dtype if dtype is None else dtype
    X_batch = np.zeros((bsize, max_timesteps, feature_len), dtype=dtype)
    y_batch = np.zeros((bsize,), dtype="uint8")
    mask = np.zeros((bsize, max_timesteps), dtype="uint8")
    for i, idx in enumerate(idxs):
        start = integral_lens[idx]
        l = int(seqlen[idx])
        X_batch[i, :l] = X[start : start + l]
        if y is not None:
            y_batch[i] = y[start]
        mask[i, :l] = 1
    return X_batch, y_batch, mask


def gen_lstm_seq_random(X, y, seqlen, rng=None):
    """Infinite iterator of single random (seq_X, seq_y) sequences.

    Mirrors utils/datagen.py:67-89: a fresh permutation of the videos each
    pass, yielding one unpadded frame-major sequence (and its per-frame
    targets) at a time.
    """
    rng = np.random if rng is None else rng
    X = np.asarray(X)
    y = np.asarray(y).reshape(-1)
    seqlen = np.asarray(seqlen).reshape(-1).astype(np.int64)
    integral_lens = compute_integral_len(seqlen)
    while True:
        for video_idx in rng.permutation(len(seqlen)):
            start = integral_lens[video_idx]
            end = start + int(seqlen[video_idx])
            yield X[start:end], y[start:end]


def gen_lstm_batch_random(X, y, seqlen, batchsize=30, shuffle=True, rng=None):
    """Infinite iterator of shuffled video-level batches.

    Yields ``(X_batch, y_batch, mask, batch_video_idxs)`` where X_batch is
    (B, T_max, D) zero-padded, y_batch holds the first-frame target of each
    sequence, and mask marks valid frames.  The final partial batch of each
    pass is yielded smaller (reference semantics), then the permutation resets.
    """
    rng = np.random if rng is None else rng
    seqlen = np.asarray(seqlen).reshape(-1).astype(np.int64)
    max_timesteps = int(np.max(seqlen))
    no_videos = len(seqlen)
    integral_lens = compute_integral_len(seqlen)

    order = rng.permutation(no_videos) if shuffle else np.arange(no_videos)
    start = 0
    while True:
        end = start + batchsize
        if end >= no_videos:
            idxs = order[start:]
            reset = True
        else:
            idxs = order[start:end]
            reset = False
        # float32 pinned: .mat corpora load as float64, which would double
        # host->device bytes against the float32 batches every other
        # generator and dataset emits
        X_batch, y_batch, mask = _pack_batch(X, y, seqlen, integral_lens,
                                             idxs, max_timesteps,
                                             dtype="float32")
        if reset:
            order = rng.permutation(no_videos) if shuffle else np.arange(no_videos)
            start = 0
        else:
            start = end
        yield X_batch, y_batch, mask, idxs


def gen_lstm_batch_seq(X, y, seqlen, batchsize=30):
    """Infinite iterator of *sequential* (unshuffled) fixed-size batches.

    The batch tensor always has ``batchsize`` rows; a trailing partial pass
    leaves the unused rows zero (reference semantics, utils/datagen.py:156-208).
    """
    seqlen = np.asarray(seqlen).reshape(-1).astype(np.int64)
    max_timesteps = int(np.max(seqlen))
    no_videos = len(seqlen)
    integral_lens = compute_integral_len(seqlen)
    start = 0
    while True:
        end = start + batchsize
        if end > no_videos:
            idxs = np.arange(start, no_videos)
            reset = True
        else:
            idxs = np.arange(start, end)
            reset = False
        feature_len = X.shape[1]
        X_batch = np.zeros((batchsize, max_timesteps, feature_len), dtype="float32")
        y_batch = np.zeros((batchsize,), dtype="uint8")
        mask = np.zeros((batchsize, max_timesteps), dtype="uint8")
        packed_X, packed_y, packed_m = _pack_batch(
            X, y, seqlen, integral_lens, idxs, max_timesteps, dtype="float32"
        )
        X_batch[: len(idxs)] = packed_X
        y_batch[: len(idxs)] = packed_y
        mask[: len(idxs)] = packed_m
        start = 0 if reset else end
        yield X_batch, y_batch, mask


# alias with reference naming (utils/datagen.py:256 duplicates gen_lstm_batch_seq)
sequence_batch_iterator = gen_lstm_batch_seq


def gen_seq_batch_from_idx(data, idxs, seqlens, integral_lens, max_timesteps):
    """Pack a secondary stream using the batch indices of the primary stream.

    Mirrors utils/datagen.py:219-229.
    """
    data = np.asarray(data)
    feature_len = data.shape[-1]
    X_batch = np.zeros((len(idxs), max_timesteps, feature_len), dtype=data.dtype)
    for i, seq_id in enumerate(idxs):
        l = int(seqlens[seq_id])
        start = integral_lens[seq_id]
        X_batch[i, :l] = data[start : start + l]
    return X_batch


def gen_batch_from_file(X, y, seqlen, feature_len, batchsize=30, shuffle=True,
                        datafieldname="dataMatrix", rng=None):
    """Like :func:`gen_lstm_batch_random` but lazily loads each sequence from a
    per-video ``.mat`` file path. Mirrors utils/datagen.py:5-64 (unreadable
    files degrade to a zero sequence)."""
    rng = np.random if rng is None else rng
    seqlen = np.asarray(seqlen).reshape(-1).astype(np.int64)
    len_X = len(seqlen)
    max_timesteps = int(np.max(seqlen))
    order = rng.permutation(len_X) if shuffle else np.arange(len_X)
    start = 0
    while True:
        end = start + batchsize
        if len_X - start > batchsize:
            idxs = order[start:end]
            reset = False
        else:
            idxs = order[start:]
            reset = True
        bsize = len(idxs)
        X_batch = np.zeros((bsize, max_timesteps, feature_len), dtype="float32")
        y_batch = np.zeros((bsize,), dtype="uint8")
        mask = np.zeros((bsize, max_timesteps), dtype="uint8")
        for i, video_idx in enumerate(idxs):
            try:
                data = load_mat_file(X[video_idx])[datafieldname].astype("float32")
            except (ValueError, OSError, KeyError) as err:
                # missing/corrupt/renamed shard degrades to a zero sequence
                # (reference semantics utils/datagen.py:44-48) instead of a
                # FileNotFoundError killing the infinite training iterator
                print(f"Error reading file: {X[video_idx]}, {err}")
                data = np.zeros((max_timesteps, feature_len), dtype="float32")
            vidlen = int(seqlen[video_idx])
            X_batch[i, : len(data)] = data[:max_timesteps]
            y_batch[i] = y[video_idx]
            mask[i, :vidlen] = 1
        if reset:
            order = rng.permutation(len_X) if shuffle else np.arange(len_X)
            start = 0
        else:
            start = end
        yield X_batch, y_batch, mask, idxs


def gen_file_batch_from_idx(files, idxs, seqlens, max_timesteps, feature_len,
                            datafieldname="dataMatrix"):
    """File-backed analogue of :func:`gen_seq_batch_from_idx`.
    Mirrors utils/datagen.py:232-253."""
    X_batch = np.zeros((len(idxs), max_timesteps, feature_len), dtype="float32")
    for i, seq_id in enumerate(idxs):
        try:
            data = load_mat_file(files[seq_id])[datafieldname].astype("float32")
        except (ValueError, OSError, KeyError) as err:
            print(f"Error reading file: {files[seq_id]}, {err}")
            data = np.zeros((max_timesteps, feature_len), dtype="float32")
        X_batch[i, : len(data)] = data[:max_timesteps]
    return X_batch


def batch_iterator(X, y, batchsize=128, rng=None):
    """Infinite iterator of shuffled fixed-shape (non-sequence) batches.

    Mirrors utils/datagen.py:311-342 minus its ``start += end`` cursor bug
    (SURVEY.md flags that quirk as not-to-reproduce): here every example of a
    pass is visited exactly once before the permutation resets.
    """
    rng = np.random if rng is None else rng
    n = len(X)
    order = rng.permutation(n)
    start = 0
    while True:
        end = start + batchsize
        if end >= n:
            idxs = order[start:]
            reset = True
        else:
            idxs = order[start:end]
            reset = False
        batch_X = np.zeros((batchsize,) + X.shape[1:], dtype=X.dtype)
        batch_y = np.zeros((batchsize,) + y.shape[1:], dtype=y.dtype)
        batch_X[: len(idxs)] = X[idxs]
        batch_y[: len(idxs)] = y[idxs]
        if reset:
            order = rng.permutation(n)
            start = 0
        else:
            start = end
        yield batch_X, batch_y


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
