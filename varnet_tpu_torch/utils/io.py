"""Observation CSVs, theta npz interchange and the improve-only theta guard
(the port of ``varnet_tpu/utils/io.py``).  The flat ``{prefix}l{i}_w`` /
``{prefix}l{i}_b`` npz format is the one the persisted benchmark thetas use, and
the ``<path>.score.json`` sidecar the one both packages' guards read, so a theta
trained by either package loads into the other and either guard protects it.
Checkpoints do not cross between the packages (``train/checkpoint.py``): theta
does, as an npz."""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

# B [3, 128] of the pinned contaminant net (benchmarks/results/theta_contaminant_causal.npz):
# the JAX package's draw at seed 0, F = 128, scales (0.5, 2.0), n_in = 3, carried as an array
# because a torch.Generator cannot reproduce jax.random's numbers.
CONTAMINANT_CAUSAL_FOURIER_B = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "contaminant_causal_fourier_b.npy")

# The JAX package's seed-0 initial theta of the 2-D Burgers front recipe
# (``benchmarks/burgers_accuracy.py --two-d``: n_in 3, w32x3), so the port's Adam stage can
# start where the published run started.
BURGERS_FRONT_2D_JAX_INIT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "burgers_front_2d_jax_init.npz")


def point_data_from_arrays(coords, values, mask=None):
    """Wrap raw arrays as PointData (coords [N, c], values [N])."""
    from ..fem.assembly import PointData   # fem imports utils: bound at call time

    coords = np.atleast_2d(np.asarray(coords, dtype=np.float64))
    values = np.asarray(values, dtype=np.float64).reshape(coords.shape[0])
    if mask is None:
        mask = np.ones(coords.shape[0])
    return PointData(coords=coords, values=values, mask=np.asarray(mask, float))


def load_observations_csv(
    path: str,
    coord_cols: Optional[Sequence[int]] = None,
    value_col: int = -1,
    delimiter: str = ",",
    skip_header: int = 1,
):
    """Load observation points from a CSV of rows [x, y, (t,) u].

    coord_cols: column indices of the network inputs (default: all but
    ``value_col``)."""
    raw = np.atleast_2d(np.genfromtxt(path, delimiter=delimiter, skip_header=skip_header))
    n_cols = raw.shape[1]
    v = value_col % n_cols
    if coord_cols is None:
        coord_cols = [c for c in range(n_cols) if c != v]
    return point_data_from_arrays(raw[:, list(coord_cols)], raw[:, v])


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


def persist_theta_if_better(path, theta, rel_l2, prefix: str = "", write_fn=None,
                            note: Optional[str] = None, verbose: bool = True) -> bool:
    """Overwrite a persisted benchmark theta ONLY on improvement.

    The accuracy pins re-score the ``benchmarks/results/theta_*.npz`` files, so
    a re-run that lands under a pin's bound but above the pinned error must
    never replace the file.  The comparison score lives in a
    ``<path>.score.json`` sidecar (``rel_l2``, ``date``, ``note``) written with
    every persist, the JAX package's format.  Decision table:

    - no existing file            -> write + sidecar, return True
    - sidecar says worse or equal -> skip, return False
    - sidecar says better         -> write + update sidecar, return True
    - existing file, NO sidecar   -> SKIP (a pin of unknown score) unless
      ``VARNET_FORCE_THETA=1`` is set

    ``rel_l2`` must be the score the WRITTEN parameters re-score to.
    ``write_fn(path)`` overrides the default ``save_theta_npz``."""
    path = os.fspath(path)
    side = path + ".score.json"
    rel_l2 = float(rel_l2)
    force = os.environ.get("VARNET_FORCE_THETA", "0") == "1"
    if os.path.exists(path) and not force:
        if not os.path.exists(side):
            if verbose:
                print(f"[persist_theta] REFUSING to overwrite {path}: no score sidecar "
                      f"(a pin of unknown quality); new score {rel_l2:.3e} recorded "
                      "nowhere; set VARNET_FORCE_THETA=1 to force", flush=True)
            return False
        with open(side) as f:
            old = json.load(f).get("rel_l2")
        if old is not None and rel_l2 >= float(old):
            if verbose:
                print(f"[persist_theta] keeping {os.path.basename(path)}: pinned "
                      f"{float(old):.3e} <= new {rel_l2:.3e}", flush=True)
            return False
    if write_fn is None:
        save_theta_npz(path, theta, prefix)
    else:
        write_fn(path)
    rec = {"rel_l2": rel_l2, "date": time.strftime("%Y-%m-%d")}
    if note:
        rec["note"] = note
    with open(side, "w") as f:
        json.dump(rec, f, indent=2)
    if verbose:
        print(f"[persist_theta] wrote {os.path.basename(path)} (rel-L2 {rel_l2:.3e})",
              flush=True)
    return True
