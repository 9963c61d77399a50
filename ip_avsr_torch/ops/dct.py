"""Zigzag DCT features as one matrix product.

Mirrors ip_avsr_tpu/ops/dct.py: orthonormal DCT-II along the FLATTENED pixel
axis (length N = rows * cols), then the zigzag scan of the coefficient plane,
keeping coefficients 1..no_coeff (the DC term is skipped).

PyTorch has no DCT, and only ``no_coeff`` of the N coefficients are kept, so
the features are ``X @ basis`` with ``basis`` (N, no_coeff) holding exactly
the gathered DCT-II columns:

    basis[n, j] = s_k * cos(pi * (2n + 1) * k / (2N)),  k = zigzag[j + 1],
    s_0 = sqrt(1/N), s_k = sqrt(2/N) for k > 0.

The basis is built once per (shape, count, device) in float64 and rounded to
float32.  :func:`dct2_ortho`, the whole transform along the last axis, is
the product with the full (N, N) matrix, built the same way and cached per
(N, dtype, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def zigzag_indices(shape) -> np.ndarray:
    """Flat indices of a (rows, cols) array in JPEG zigzag traversal order.

    Diagonal d = r + c is walked top-to-bottom when d is odd and
    bottom-to-top when d is even."""
    rows, cols = shape
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    d = r + c
    key = np.where(d % 2 == 1, r, -r)
    return np.lexsort((key.ravel(), d.ravel()))


def _dct_columns(n_pix: int, k: np.ndarray) -> np.ndarray:
    """(n_pix, len(k)) float64 columns k of the orthonormal DCT-II matrix."""
    n = np.arange(n_pix, dtype=np.float64)[:, None]
    scale = np.where(k == 0, np.sqrt(1.0 / n_pix), np.sqrt(2.0 / n_pix))
    return scale * np.cos(np.pi * (2.0 * n + 1.0) * k[None, :] / (2.0 * n_pix))


def dct_feature_basis_np(image_shape, no_coeff: int) -> np.ndarray:
    """(N, no_coeff) float64 columns of the orthonormal DCT-II matrix for
    the zigzag coefficients 1..no_coeff."""
    n_pix = int(image_shape[0]) * int(image_shape[1])
    k = zigzag_indices(image_shape)[1: no_coeff + 1].astype(np.float64)
    return _dct_columns(n_pix, k)


@functools.lru_cache(maxsize=8)
def _dct_matrix(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The whole (n, n) DCT-II matrix, built in float64 and cast to
    ``dtype`` on ``device``, cached (it is never written)."""
    basis = _dct_columns(n, np.arange(n, dtype=np.float64))
    return torch.as_tensor(basis, dtype=dtype, device=device)


def dct2_ortho(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis, as ``x @ D`` with ``D`` the
    cached (n, n) basis of ``x``'s dtype and device."""
    return torch.matmul(x, _dct_matrix(int(x.shape[-1]), x.dtype, x.device))


@functools.lru_cache(maxsize=8)
def dct_feature_basis(image_shape, no_coeff: int, device) -> torch.Tensor:
    """The float32 basis on ``device``, cached (it is never written)."""
    basis = dct_feature_basis_np(tuple(image_shape), no_coeff)
    return torch.as_tensor(basis, dtype=torch.float32, device=device)


def compute_dct_features_device(X: torch.Tensor, image_shape, no_coeff: int = 30,
                                basis=None) -> torch.Tensor:
    """(N, H*W) flattened images -> (N, no_coeff) zigzag DCT features, with
    the given ``basis`` or the cached one."""
    if basis is None:
        basis = dct_feature_basis(tuple(image_shape), int(no_coeff), X.device)
    return torch.matmul(X, basis)
