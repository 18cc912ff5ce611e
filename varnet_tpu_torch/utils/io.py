"""Theta npz interchange (the subset of ``varnet_tpu/utils/io.py`` the port
needs).  The flat ``{prefix}l{i}_w`` / ``{prefix}l{i}_b`` npz format is the
one the persisted benchmark thetas use, so a theta trained by either
package loads into the other."""

from __future__ import annotations

import os

import numpy as np
import torch

# B [3, 128] of the pinned contaminant net (benchmarks/results/theta_contaminant_causal.npz):
# the JAX package's draw at seed 0, F = 128, scales (0.5, 2.0), n_in = 3, carried as an array
# because a torch.Generator cannot reproduce jax.random's numbers.
CONTAMINANT_CAUSAL_FOURIER_B = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "contaminant_causal_fourier_b.npy")


def save_theta_npz(path: str, theta, prefix: str = "") -> None:
    """Persist an MLP parameter list ``[{'w','b'}, ...]`` (NumPy arrays or
    torch tensors) as a flat npz."""
    np.savez(path, **theta_npz_dict(theta, prefix))


def theta_npz_dict(theta, prefix: str = "") -> dict:
    """The flat key->array dict for ``save_theta_npz``."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    return {
        f"{prefix}l{i}_{k}": host(v)
        for i, layer in enumerate(theta)
        for k, v in layer.items()
    }


def load_theta_npz(path, prefix: str = ""):
    """Inverse of :func:`save_theta_npz`: a list of ``{'w', 'b'}`` NumPy
    arrays.  ``path`` may be a filename or an already-opened ``NpzFile``."""
    z = np.load(path) if isinstance(path, (str, os.PathLike)) else path
    n_layers = sum(
        1 for f in z.files
        if f.startswith(f"{prefix}l") and f.endswith("_w")
        and f[len(prefix):].count("_") == 1
    )
    return [
        {"w": z[f"{prefix}l{i}_w"], "b": z[f"{prefix}l{i}_b"]}
        for i in range(n_layers)
    ]
