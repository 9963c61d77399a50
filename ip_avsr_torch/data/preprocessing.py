"""Host-side (NumPy) feature preprocessing: the port's copy of
ip_avsr_tpu/data/preprocessing.py, function for function.

Behavioral parity targets (reference: lzuwei/ip-avsr):
  * ``deltas``                    — utils/preprocessing.py:17  (lfilter semantics)
  * ``create_split_index``        — utils/preprocessing.py:54
  * ``split_videolen``            — utils/preprocessing.py:77
  * ``split_seq_data``            — utils/preprocessing.py:111
  * ``resize_images``             — utils/preprocessing.py:195 (scipy imresize semantics)
  * ``normalize_input``           — utils/preprocessing.py:218
  * ``featurewise_normalize_sequence`` — utils/preprocessing.py:245
  * ``sequencewise_mean_image_subtraction`` — utils/preprocessing.py:260
  * ``zigzag`` / ``fill_zigzag``  — utils/preprocessing.py:280,341
  * ``compute_dct_features``      — utils/preprocessing.py:417
  * ``concat_first_second_deltas``— utils/preprocessing.py:465
  * ``reorder_data``              — utils/preprocessing.py:492
  * ``compute_diff_images``       — utils/preprocessing.py:506
  * ``zca_whiten``                — utils/preprocessing.py:520
  * ``factorize``                 — utils/preprocessing.py:534
  * ``embed_temporal_info``       — utils/preprocessing.py:559
  * ``force_align`` / ``multistream_force_align`` — utils/preprocessing.py:607,673

Every function is pure NumPy and SciPy and runs on the host, before the
Trainer, as in the JAX package; each gives that package's result bit for bit
(the reference's quirks included, documented inline).  ``zigzag_indices``
is the one copy in ``ops/dct.py``.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.fftpack as fft
from numpy.lib.stride_tricks import sliding_window_view

from ip_avsr_torch.ops.dct import zigzag_indices


# ---------------------------------------------------------------------------
# Delta (derivative) features
# ---------------------------------------------------------------------------

def deltas(x: np.ndarray, w: int = 9, pad_mode: str = "python_ref") -> np.ndarray:
    """Linear-slope delta coefficients of a feature-major sequence.

    ``x`` has one row per feature and one column per timestep; the output has
    the same shape.  The filter is the *unnormalized* regression slope

        out[:, t] = sum_{o=1..h} o * (x[:, t+o] - x[:, t-o]),   h = w // 2

    over an edge-padded sequence, matching the reference's
    ``lfilter(arange(h, -h-1, -1), 1, xx)[:, 2h:2h+T]`` computation
    (utils/preprocessing.py:17-51).

    pad_mode:
      * ``"python_ref"`` — pad the front with column index 1 (the *second*
        column).  This reproduces a quirk of the reference Python port, whose
        front pad uses ``x[:, 1]``; the features consumed in training were
        produced with this convention, so it is the parity default.
      * ``"matlab"`` — pad the front with the first column, matching
        ``dbn/deltas.m:107-132`` (and the back with the last column, as both do).
    """
    x = np.asarray(x)
    num_rows, num_cols = x.shape
    hlen = w // 2
    if hlen == 0:
        return np.zeros_like(x)

    if pad_mode == "python_ref":
        front_col = x[:, min(1, num_cols - 1)]
    elif pad_mode == "matlab":
        front_col = x[:, 0]
    else:
        raise ValueError(f"unknown pad_mode: {pad_mode!r}")

    front = np.repeat(front_col[:, None], hlen, axis=1)
    back = np.repeat(x[:, -1][:, None], hlen, axis=1)
    padded = np.concatenate([front, x, back], axis=1)

    # windows[r, t, k] = padded[r, t + k], k in [0, 2h]; coefficient k - h
    windows = sliding_window_view(padded, 2 * hlen + 1, axis=1)
    weights = np.arange(-hlen, hlen + 1, dtype=padded.dtype)
    return windows @ weights


def concat_first_second_deltas(X: np.ndarray, vidlenvec, w: int = 9) -> np.ndarray:
    """Append 1st and 2nd order deltas per sequence (time-major input).

    Mirrors utils/preprocessing.py:465-489: each sequence (a contiguous slab of
    rows of ``X``) gets [x, delta(x), delta(delta(x))] concatenated on the
    feature axis.  Output dtype is float64 like the reference (fresh ``np.zeros``).
    """
    X = np.asarray(X)
    feature_len = X.shape[1]
    out = np.zeros((X.shape[0], feature_len * 3))
    start = 0
    for vidlen in vidlenvec:
        end = start + int(vidlen)
        seq = X[start:end].T  # (D, T)
        first = deltas(seq, w)
        second = deltas(first, w)
        out[start:end, :feature_len] = seq.T
        out[start:end, feature_len:2 * feature_len] = first.T
        out[start:end, 2 * feature_len:] = second.T
        start = end
    return out


# ---------------------------------------------------------------------------
# Dataset splitting
# ---------------------------------------------------------------------------

def create_split_index(data_len: int, vid_len_vec, iter_vec) -> np.ndarray:
    """Boolean frame-level train mask: iterations 1 and 2 are training.

    Mirrors utils/preprocessing.py:54-74.
    """
    vid_len_vec = np.asarray(vid_len_vec).reshape(-1).astype(np.int64)
    iter_vec = np.asarray(iter_vec).reshape(-1)
    is_train = (iter_vec == 1) | (iter_vec == 2)
    index = np.repeat(is_train, vid_len_vec)
    out = np.zeros((data_len,), dtype=bool)
    out[: len(index)] = index
    return out


def split_videolen(videolen_vec, iter_vec):
    """Partition per-video lengths into (train, test) by iteration id.

    Mirrors utils/preprocessing.py:77-85.
    """
    videolen_vec = list(videolen_vec)
    train, test = [], []
    for length, it in zip(videolen_vec, iter_vec):
        (train if it in (1, 2) else test).append(length)
    return train, test


def split_seq_data(X, y, subjects, video_lens, train_ids, val_ids, test_ids):
    """Three-way split of frame-major data by *subject id*.

    ``subjects`` maps each video to a subject; frames of all videos belonging
    to subjects in ``train_ids``/``val_ids`` go to train/val, everything else
    to test.  Returns
    ``(train_X, train_y, train_vidlens, train_subjects, val_..., test_...)``.

    Behavior parity with utils/preprocessing.py:111-177, implemented with a
    vectorized per-video membership lookup instead of the reference's
    subject-run accumulation loop.
    """
    X = np.asarray(X)
    y = np.asarray(y).reshape(-1)
    subjects = np.asarray(subjects).reshape(-1)
    video_lens = np.asarray(video_lens).reshape(-1).astype(np.int64)

    frame_subjects = np.repeat(subjects, video_lens)
    train_set = np.isin(subjects, np.asarray(list(train_ids)))
    val_set = np.isin(subjects, np.asarray(list(val_ids)))
    test_set = ~(train_set | val_set)
    f_train = np.repeat(train_set, video_lens)
    f_val = np.repeat(val_set, video_lens)
    f_test = np.repeat(test_set, video_lens)
    assert len(frame_subjects) == len(X), "video_lens must sum to len(X)"

    def pick(f_mask, v_mask):
        return (X[f_mask], y[f_mask], video_lens[v_mask], subjects[v_mask])

    return pick(f_train, train_set) + pick(f_val, val_set) + pick(f_test, test_set)


# ---------------------------------------------------------------------------
# Image resizing (scipy.misc.imresize semantics)
# ---------------------------------------------------------------------------

def _bytescale(data: np.ndarray) -> np.ndarray:
    """Linearly rescale to uint8 [0, 255] (old scipy ``bytescale`` behavior)."""
    if data.dtype == np.uint8:
        return data
    cmin, cmax = float(data.min()), float(data.max())
    cscale = cmax - cmin
    if cscale == 0:
        cscale = 1
    scale = 255.0 / cscale
    return ((data - cmin) * scale + 0.5).astype(np.uint8)


def resize_img(img, orig_dim=(60, 80), dim=(30, 40), reshape=True, order="F"):
    """Resize one image, reproducing deprecated ``scipy.misc.imresize``:
    bytescale to uint8, PIL bilinear resize, return uint8 array.

    Mirrors utils/preprocessing.py:180-192.
    """
    from PIL import Image

    img = np.asarray(img)
    if reshape:
        img = img.reshape(orig_dim, order=order)
    byte_img = _bytescale(img)
    # PIL size is (width, height)
    resized = Image.fromarray(byte_img, mode="L").resize(
        (dim[1], dim[0]), resample=Image.BILINEAR
    )
    return np.array(resized, dtype=np.uint8)


def resize_images(images, orig_dim=(60, 80), dim=(30, 40), reshape=True, order="F"):
    """Resize a matrix of flattened images. Mirrors utils/preprocessing.py:195-215.

    Note the reference re-flattens resized images in C order regardless of the
    input packing order; we keep that convention.
    """
    images = np.asarray(images)
    if reshape:
        out = np.zeros((images.shape[0], dim[0] * dim[1]))
    else:
        out = np.zeros((images.shape[0], dim[0], dim[1]))
    for i, img in enumerate(images):
        r = resize_img(img, orig_dim, dim, reshape, order)
        out[i] = r.reshape((dim[0] * dim[1],)) if reshape else r
    return out


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def normalize_input(inputs, centralize=True, quantize=False):
    """Samplewise normalization, in place, mirroring utils/preprocessing.py:218-242.

    ``centralize``: per-sample zero mean / unit std. ``quantize``: rescale each
    sample to [0, 1].  Mutates and returns ``inputs`` (reference behavior).
    """
    inputs = np.asarray(inputs)
    if centralize:
        flat = inputs.reshape(len(inputs), -1)
        mean = flat.mean(axis=1).reshape((-1,) + (1,) * (inputs.ndim - 1))
        centered = inputs - mean
        std = centered.reshape(len(inputs), -1).std(axis=1)
        std = std.reshape((-1,) + (1,) * (inputs.ndim - 1))
        inputs[...] = centered / std
    if quantize:
        flat = inputs.reshape(len(inputs), -1)
        mn = flat.min(axis=1).reshape((-1,) + (1,) * (inputs.ndim - 1))
        mx = flat.max(axis=1).reshape((-1,) + (1,) * (inputs.ndim - 1))
        inputs[...] = (inputs - mn) / (mx - mn)
    return inputs


def featurewise_normalize_sequence(inputs):
    """Featurewise z-normalization; returns (normalized, mean, std).

    Mirrors utils/preprocessing.py:245-257 (std computed *after* mean removal).
    """
    inputs = np.asarray(inputs)
    feature_means = inputs.mean(axis=0)
    inputs = inputs - feature_means
    feature_std = inputs.std(axis=0)
    inputs = inputs / feature_std
    return inputs, feature_means, feature_std


def sequencewise_mean_image_subtraction(inputs, seqlens, axis=0):
    """Subtract each sequence's mean image from its frames.

    Mirrors utils/preprocessing.py:260-277 (note the reference divides the
    per-sequence *sum* by len using the input dtype, so integer inputs floor).
    """
    inputs = np.asarray(inputs)
    out = np.zeros(inputs.shape, inputs.dtype)
    start = 0
    for length in seqlens:
        length = int(length)
        end = start + length
        seq = inputs[start:end]
        mean_image = np.sum(seq, axis, inputs.dtype) / length
        out[start:end] = seq - mean_image
        start = end
    return out


# ---------------------------------------------------------------------------
# Zigzag DCT features
# ---------------------------------------------------------------------------

def zigzag(X: np.ndarray) -> np.ndarray:
    """Zigzag-scan a 2D array into 1D. Mirrors utils/preprocessing.py:280-338."""
    X = np.asarray(X)
    return X.ravel()[zigzag_indices(X.shape)]


def fill_zigzag(shape) -> np.ndarray:
    """Fill a 2D array with 1..N in zigzag order. Mirrors utils/preprocessing.py:341-399."""
    out = np.empty(shape[0] * shape[1], dtype=int)
    out[zigzag_indices(shape)] = np.arange(1, out.size + 1)
    return out.reshape(shape)


def compute_dct_features(X, image_shape, no_coeff=30, method="zigzag"):
    """DCT-II features of flattened images. Mirrors utils/preprocessing.py:417-462.

    Reference quirk preserved: the DCT is the *1-D* orthonormal DCT along the
    flattened pixel axis (not a 2-D DCT); ``zigzag`` then reads coefficients
    1..no_coeff (skipping the DC term) from the coefficient vector reshaped to
    ``image_shape``.
    """
    X = np.asarray(X)
    X_dct = fft.dct(X, norm="ortho")

    if method == "zigzag":
        order = zigzag_indices(image_shape)[1 : no_coeff + 1]
        return X_dct[:, order].astype(X_dct.dtype)
    if method == "rel_variance":
        X_dct = X_dct[:, 1:]
        std = (X_dct - X_dct.mean(axis=0)).std(axis=0)
        idxs = np.argsort(std)[::-1][:no_coeff]
        return X_dct[:, idxs]
    if method == "variance":
        X_dct = X_dct[:, 1:]
        idxs = np.argsort(X_dct.std(axis=0))[::-1][:no_coeff]
        return X_dct[:, idxs]
    if method == "energy":
        X_dct = X_dct[:, 1:]
        idxs = np.argsort(np.abs(X_dct).sum(axis=0))[::-1][:no_coeff]
        return X_dct[:, idxs]
    raise NotImplementedError(
        "method not implemented, use 'zigzag', 'variance', 'rel_variance' or 'energy'"
    )


# ---------------------------------------------------------------------------
# Pixel packing, diff images, whitening
# ---------------------------------------------------------------------------

def reorder_data(X, shape, orig_order="f", desired_order="c"):
    """Repack flattened 2D data between Fortran and C pixel orders.

    Mirrors utils/preprocessing.py:492-503.  The DBNF encoders were trained on
    F-ordered images; loading their weights against C-ordered pixels silently
    destroys accuracy, so runners call this first.
    """
    d1, d2 = shape
    X = np.asarray(X)
    return X.reshape((-1, d1, d2), order=orig_order).reshape((-1, d1 * d2), order=desired_order)


def compute_diff_images(X, vidlenvec):
    """First-order temporal difference images per sequence, with the first
    diff duplicated at t=0. Mirrors utils/preprocessing.py:506-517."""
    X = np.asarray(X)
    out = np.zeros(X.shape, dtype=X.dtype)
    start = 0
    for length in vidlenvec:
        length = int(length)
        end = start + length
        d = np.diff(X[start:end], 1, 0)
        out[start] = d[0]
        out[start + 1 : end] = d
        start = end
    return out


def zca_whiten(inputs):
    """ZCA whitening. Mirrors utils/preprocessing.py:520-525, including its
    quirk that the middle factor is the elementwise ``1/sqrt(diag(S)+eps)`` of
    the *dense* diagonal matrix (off-diagonal entries become ``1/sqrt(eps)``
    instead of zero) — reproduced verbatim since downstream features depend
    on it."""
    inputs = np.asarray(inputs)
    sigma = inputs @ inputs.T / inputs.shape[1]
    U, S, _ = np.linalg.svd(sigma)
    epsilon = 0.1
    middle = 1.0 / np.sqrt(np.diag(S) + epsilon)
    zca = U @ middle @ U.T
    return zca @ inputs


def apply_zca_whitening(X):
    for i, img in enumerate(X):
        X[i] = zca_whiten(img.reshape((1, -1)))
    return X


# ---------------------------------------------------------------------------
# Temporal re-sampling
# ---------------------------------------------------------------------------

def factorize(inputs, targets, input_len, multipleof, axis_to_delete=0, rng=None):
    """Randomly drop frames so each sequence length is a multiple of
    ``multipleof``. Mirrors utils/preprocessing.py:534-556, except the
    default ``axis_to_delete`` is 0 (drop frame ROWS): the reference
    defaults to None — which makes np.delete FLATTEN 2-D inputs, silently
    corrupting the data — and then never uses that default (every reference
    call site passes 0 explicitly, e.g. oulu/prepare_data.py:168)."""
    rng = np.random if rng is None else rng
    inputs = np.asarray(inputs)
    if inputs.ndim < 2:
        inputs = inputs.reshape((-1, 1))
    input_len = np.asarray(input_len)
    idx_to_remove = []
    curr = 0
    for length in input_len:
        length = int(length)
        remainder = length % multipleof
        idx_to_remove += rng.permutation(np.arange(curr, curr + length))[:remainder].tolist()
        curr += length
    new_len = input_len - (input_len % multipleof)
    return (
        np.delete(inputs, idx_to_remove, axis=axis_to_delete),
        np.delete(np.asarray(targets), idx_to_remove, axis=axis_to_delete),
        new_len,
    )


def embed_temporal_info(X, targets, X_len, window, step):
    """Stack a sliding temporal window of frames into each output feature row,
    downsampling time by ``step``. Mirrors utils/preprocessing.py:559-604
    (Python-2 integer division reproduced with ``//``).

    Preconditions the reference leaves implicit (violations crash it with
    opaque numpy errors — negative np.repeat, IndexError, broadcast
    mismatches): every length must be a multiple of ``step`` (run
    :func:`factorize` first, as the reference mains do) and the padding
    count ``window - step + ceil(step/2)`` must be non-negative.  Checked
    here with explicit errors instead.
    """
    X = np.asarray(X)
    targets = np.asarray(targets)
    X_len = np.asarray(X_len)
    repeats_chk = int(window - step + math.ceil(step / 2.0))
    if repeats_chk < 0:
        raise ValueError(
            f"embed_temporal_info: window={window} too small for step={step} "
            f"(edge padding {repeats_chk} would be negative); need "
            f"window >= step - ceil(step/2)")
    bad = X_len % step
    if np.any(bad):
        raise ValueError(
            f"embed_temporal_info: sequence lengths {X_len[bad != 0]} are "
            f"not multiples of step={step}; factorize() the data first "
            f"(oulu/prepare_data.py:168 pipeline order)")
    # EVEN steps: the reference's symmetric padding under-provisions the
    # right edge by exactly one frame (last window's slice overruns and
    # numpy's broadcast raises — verified against the reference formula for
    # every even step), so it can never have produced results to match.
    # One extra edge-replicated frame on the right makes even steps work
    # with the natural semantics; odd steps are bit-identical to the
    # reference.
    extra_right = 1 - step % 2
    embedsize = X.shape[-1] * (window * 2 + 1)
    total = int(np.sum(X_len)) // step
    res = np.zeros((total, embedsize), dtype=X.dtype)
    res_targets = np.zeros((total,), dtype=targets.dtype)
    curr = 0
    out_i = 0
    repeats = int(window - step + math.ceil(step / 2.0))
    for length in X_len:
        length = int(length)
        seq = X[curr : curr + length]
        seq_target = targets[curr : curr + length]
        seq = np.concatenate(
            [np.repeat(seq[:1], repeats, axis=0), seq,
             np.repeat(seq[-1:], repeats + extra_right, axis=0)],
            axis=0,
        )
        pos = repeats + step // 2
        while pos - repeats < length:
            res[out_i] = seq[pos - window : pos + window + 1].reshape((-1,))
            res_targets[out_i] = seq_target[0]
            pos += step
            out_i += 1
        curr += length
    return res, res_targets, X_len // step


# ---------------------------------------------------------------------------
# Multi-stream alignment
# ---------------------------------------------------------------------------

def force_align(x1, x2, mode="fill"):
    """Force-align two (X, targets, lens) streams to equal per-sequence lengths
    by repeating each shorter sequence's last frame.

    Mirrors utils/preprocessing.py:607-661 including its quirk that when
    stream 2 is shorter, the repeated element is read at offset ``l1 - 1``
    into stream 2 (an index arithmetic bug in the reference; preserved for
    output parity — note it can only matter when l1 < l2, the other branch).
    """
    (a, a_t, a_lens), (b, b_t, b_lens) = x1, x2
    aligned = multistream_force_align([(a, a_t, np.array(a_lens)), (b, b_t, np.array(b_lens))], mode=mode)
    return aligned[0], aligned[1]


def multistream_force_align(orig_streams, mode="fill"):
    """Force-align N (X, targets, lens) streams per sequence by last-frame
    repetition up to the longest stream. Mirrors utils/preprocessing.py:673-712."""
    if mode != "fill":
        raise NotImplementedError("only mode='fill' is implemented (as in the reference)")
    n_streams = len(orig_streams)
    inputs = [np.asarray(s[0]) for s in orig_streams]
    targets = [np.asarray(s[1]) for s in orig_streams]
    lens = [np.asarray(s[2]).reshape(-1).astype(np.int64).copy() for s in orig_streams]

    n_seqs = len(lens[0])
    # target length for each sequence = max over streams
    max_lens = np.max(np.stack([l for l in lens], axis=0), axis=0)

    new_inputs = [[] for _ in range(n_streams)]
    new_targets = [[] for _ in range(n_streams)]
    offsets = [0] * n_streams
    for i in range(n_seqs):
        target_len = int(max_lens[i])
        for j in range(n_streams):
            l = int(lens[j][i])
            start = offsets[j]
            seq = inputs[j][start : start + l]
            seq_t = targets[j][start : start + l]
            copies = target_len - l
            new_inputs[j].append(seq)
            new_targets[j].append(seq_t)
            if copies > 0:
                new_inputs[j].append(np.repeat(seq[-1:], copies, axis=0))
                new_targets[j].append(np.repeat(seq_t[-1:], copies, axis=0))
            offsets[j] += l
        for j in range(n_streams):
            lens[j][i] = target_len
    return [
        (np.concatenate(new_inputs[j]), np.concatenate(new_targets[j]), lens[j])
        for j in range(n_streams)
    ]


def extract_stream_elements(streams):
    """Unzip a list of (input, target, lens) tuples into three lists.
    Mirrors utils/preprocessing.py:664-670."""
    return tuple([list(tup) for tup in zip(*streams)])
