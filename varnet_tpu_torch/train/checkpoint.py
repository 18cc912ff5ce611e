"""Checkpoint / resume: the PyTorch port of ``varnet_tpu/train/checkpoint.py``.

The same folder layout as the JAX package: step N is the directory
``ckpt_<N:010d>/`` with its ``ckpt_<N:010d>.meta.json`` sidecar beside it, and
one ``config.json`` (the problem / discretization fingerprint) per folder; the
newest ``keep`` steps are kept.  The state (``{"theta": [...], "opt_state":
{...}}`` of tensors, ints, floats and strings) is one ``torch.save`` file in the
step directory.  Each step directory is written under a temporary name and
renamed into place (``os.replace``), and the JSON files likewise, so a crash
during a save leaves the newest complete checkpoint readable, as Orbax's
atomic finalisation does for the JAX package.

A folder of the JAX package's Orbax checkpoints cannot be read here (Orbax is a
JAX library): ``load_checkpoint`` says so, and theta crosses between the
packages as a ``.npz`` (``utils/io.py``: ``save_theta_npz`` / ``load_theta_npz``).
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

STATE_FILE = "state.pt"
# files an Orbax (JAX package) checkpoint directory holds, any one of which marks it
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "_sharding", "d",
                  "checkpoint")


class ForeignCheckpointError(ValueError):
    """The step directory was not written by ``varnet_tpu_torch`` (an Orbax
    checkpoint of the JAX package)."""


def _step_dir(folder: str, step: int) -> str:
    return os.path.join(os.path.abspath(folder), f"ckpt_{step:010d}")


def _write_json(path: str, obj) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, default=_json_default)
    os.replace(tmp, path)


def save_checkpoint(
    folder: str,
    step: int,
    state: Dict[str, Any],
    config: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Write checkpoint ``ckpt_<step>`` under ``folder``; prune old ones."""
    folder = os.path.abspath(folder)
    os.makedirs(folder, exist_ok=True)
    path = _step_dir(folder, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    if config is not None:
        _write_json(os.path.join(folder, "config.json"), config)
    # keep the newest ``keep`` checkpoints (and their meta sidecars)
    for old in list_checkpoint_steps(folder)[:-keep]:
        shutil.rmtree(_step_dir(folder, old), ignore_errors=True)
        meta = _step_dir(folder, old) + ".meta.json"
        if os.path.exists(meta):
            os.remove(meta)
    return path


def list_checkpoint_steps(folder: str):
    """The step numbers of the complete checkpoints under ``folder``, sorted
    (a temporary directory of an interrupted save is not one)."""
    folder = os.path.abspath(folder)
    if not os.path.isdir(folder):
        return []
    steps = []
    for name in os.listdir(folder):
        if name.startswith("ckpt_") and os.path.isdir(os.path.join(folder, name)):
            try:
                steps.append(int(name[len("ckpt_"):]))
            except ValueError:
                pass
    return sorted(steps)


def _structure(tree):
    """A comparable signature of a state tree: keys, lengths, tensor shapes
    and dtypes, strings by value, other leaves by type."""
    if isinstance(tree, dict):
        return tuple(sorted((str(k), _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return ("list",) + tuple(_structure(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), str(tree.dtype))
    if isinstance(tree, str):
        return ("str", tree)
    return type(tree).__name__


def load_checkpoint(
    folder: str,
    target: Dict[str, Any],
    step: Optional[int] = None,
    map_location=None,
) -> Tuple[Dict[str, Any], int]:
    """Restore the latest (or given-step) checkpoint.  Returns (state, step).

    ``target`` gives the expected structure: ``"theta"`` (a parameter list)
    and optionally ``"opt_state"`` (``Optimizer.state_dict()`` of a fresh
    optimizer).  Tensors load onto ``map_location`` (a checkpoint written on
    the card loads on the CPU and the other way round).  If the stored
    optimizer state does not fit the target's (another optimizer or
    schedule), the parameters alone are restored, with a warning, and the
    target's optimizer state is returned: the reference's semantics of
    rebuilding the graph and restoring the weights.  Stored parameters of
    other shapes, and a corrupt file, raise."""
    steps = list_checkpoint_steps(folder)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {folder}")
    step = steps[-1] if step is None else int(step)
    if step not in steps:
        raise FileNotFoundError(f"no checkpoint for step {step} under {folder}")
    path = _step_dir(folder, step)
    state_file = os.path.join(path, STATE_FILE)
    if not os.path.exists(state_file):
        if any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
            raise ForeignCheckpointError(
                f"{path} is an Orbax checkpoint of the JAX package (varnet_tpu), which "
                "varnet_tpu_torch cannot read; carry theta across as an .npz instead: "
                "save_theta_npz(path, vn.theta) on the JAX side, then "
                "vn.theta = load_theta_npz(path) here (varnet_tpu_torch.utils.io)")
        raise FileNotFoundError(f"{path} holds no {STATE_FILE}")
    stored = torch.load(state_file, map_location=map_location, weights_only=True)
    theta = stored["theta"]
    if _structure(theta) != _structure(target["theta"]):
        raise ValueError(f"checkpoint {path}: stored parameters have another structure "
                         f"than the target's ({_structure(theta)} vs "
                         f"{_structure(target['theta'])})")
    state = dict(target)
    state["theta"] = theta
    if "opt_state" in target:
        got = stored.get("opt_state")
        if got is not None and _structure(got) == _structure(target["opt_state"]):
            state["opt_state"] = got
        else:
            warnings.warn(
                "stored optimizer state does not match the target structure "
                f"({'absent' if got is None else got.get('name', 'other')} vs "
                f"{target['opt_state'].get('name')}); restored parameters only, "
                "optimizer state is fresh",
                stacklevel=2,
            )
    return state, step


def save_meta(folder: str, step: int, meta: Dict[str, Any]) -> str:
    """The small JSON sidecar of a checkpoint step (the seed of a train
    checkpoint, lam and loss of an LM one)."""
    p = _step_dir(folder, step) + ".meta.json"
    _write_json(p, meta)
    return p


def load_meta(folder: str, step: int) -> Optional[Dict[str, Any]]:
    p = _step_dir(folder, step) + ".meta.json"
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def load_config(folder: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(os.path.abspath(folder), "config.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
