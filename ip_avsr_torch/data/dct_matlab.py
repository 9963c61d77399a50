"""MATLAB-toolbox DCT feature extraction (true 2-D DCT); the port's copy of
ip_avsr_tpu/data/dct_matlab.py, on the host in numpy and scipy.

Parity targets:
  * ``compute_dct_feat`` — dbn/computeDCTfeat.m:34-45: per-frame 2-D DCT
    (MATLAB ``dct2``), zigzag scan, keep coefficients 2..N+1 (skip DC).
    Note this differs from the Python-side features
    (utils/preprocessing.py:417-434 / data/preprocessing.compute_dct_features),
    which apply a 1-D DCT to the flattened pixels; both are provided.
  * ``compute_dct_feat_and_deltas`` — dbn/computeDCTfeatAndDeltas.m:78-83:
    DCT features + deltas(w=9) + deltas(deltas) concatenated -> D*3, using
    the MATLAB delta padding (first column).
"""

from __future__ import annotations

import numpy as np
import scipy.fftpack as fft

from ip_avsr_torch.data.preprocessing import deltas
from ip_avsr_torch.ops.dct import zigzag_indices


def dct2(image: np.ndarray) -> np.ndarray:
    """2-D orthonormal DCT-II (MATLAB dct2): DCT along rows then columns."""
    return fft.dct(fft.dct(image, norm="ortho", axis=0), norm="ortho", axis=1)


def compute_dct_feat(X: np.ndarray, image_shape, no_coeff: int = 30,
                     order: str = "F") -> np.ndarray:
    """(N, H*W) flattened images -> (N, no_coeff) 2-D-DCT zigzag features.

    ``order`` is the pixel packing of the flattened images ('F' for
    MATLAB-written data).
    """
    X = np.asarray(X)
    zz = zigzag_indices(image_shape)[1 : no_coeff + 1]
    out = np.empty((len(X), no_coeff), dtype=np.float64)
    for i, row in enumerate(X):
        coeffs = dct2(row.reshape(image_shape, order=order))
        out[i] = coeffs.ravel()[zz]
    return out


def compute_dct_feat_and_deltas(X: np.ndarray, image_shape, vidlen_vec,
                                no_coeff: int = 30, w: int = 9,
                                order: str = "F") -> np.ndarray:
    """DCT features with 1st and 2nd order deltas appended per sequence
    (dbn/computeDCTfeatAndDeltas.m:78-83; MATLAB delta padding)."""
    feats = compute_dct_feat(X, image_shape, no_coeff, order)
    out = np.zeros((len(feats), no_coeff * 3))
    start = 0
    for l in np.asarray(vidlen_vec).reshape(-1):
        l = int(l)
        seq = feats[start : start + l].T  # (D, T)
        d1 = deltas(seq, w, pad_mode="matlab")
        d2 = deltas(d1, w, pad_mode="matlab")
        out[start : start + l] = np.concatenate([seq, d1, d2], axis=0).T
        start += l
    return out
