"""Shared helpers (the subset of ``varnet_tpu/utils/helpers.py`` the port
needs; ``pair_mats``, ``rel_l2_error`` and ``cartesian_grid`` are copied
verbatim, pure NumPy)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def matmul_precision_scope():
    """Scoped full-f32 matmuls: TF32 off for CUDA matmuls and cuDNN, the
    previous flags restored after the scope.

    TF32 keeps about three decimal digits, the same trap as the TPU MXU's
    bf16 default that put a ~5e-3 floor under accuracy.
    """
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def pair_mats(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cartesian pairing of two point sets (reference UF.pairMats).

    Given ``a`` of shape [Na, da] and ``b`` of shape [Nb, db], returns the
    [Na * Nb, da + db] array of all row pairs, with ``b`` varying slowest:
    row (j * Na + i) = concat(a[i], b[j]).  Used to pair a spatial grid with
    a time grid (space-time training points) and with MOR parameter samples.
    """
    a = np.atleast_2d(np.asarray(a, dtype=np.float64))
    b = np.atleast_2d(np.asarray(b, dtype=np.float64))
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("pair_mats expects 2-D arrays")
    na, nb = a.shape[0], b.shape[0]
    a_rep = np.tile(a, (nb, 1))
    b_rep = np.repeat(b, na, axis=0)
    return np.hstack([a_rep, b_rep])


def rel_l2_error(pred, true, eps: float = 1e-30) -> float:
    """Relative L2 error ||pred - true|| / ||true|| (reference UF error norm)."""
    pred = np.asarray(pred, dtype=np.float64).ravel()
    true = np.asarray(true, dtype=np.float64).ravel()
    denom = np.linalg.norm(true)
    return float(np.linalg.norm(pred - true) / (denom + eps))


def cartesian_grid(lows, highs, counts):
    """Uniform tensor-product grid.

    Returns (nodes [prod(counts), dim], axes list of 1-D arrays, spacing [dim]).
    ``counts`` are node counts per dimension (>= 2).
    """
    lows = np.atleast_1d(np.asarray(lows, dtype=np.float64))
    highs = np.atleast_1d(np.asarray(highs, dtype=np.float64))
    counts = np.atleast_1d(np.asarray(counts, dtype=np.int64))
    axes = [np.linspace(lo, hi, int(n)) for lo, hi, n in zip(lows, highs, counts)]
    spacing = (highs - lows) / (counts - 1)
    mesh = np.meshgrid(*axes, indexing="ij")
    nodes = np.stack([m.ravel() for m in mesh], axis=-1)
    return nodes, axes, spacing
