"""High-level orchestrator: the ``VarNet`` class.

PyTorch counterpart of ``varnet_tpu/api.py``: same constructor and
``train`` / ``refine_lm`` / ``evaluate`` / ``compute_error`` /
``refine_tests`` / ``train_adaptive`` call shapes, one explicit device.  Fixed
data is assembled once on the host, moved to the device and kept there; the
fused residual's data layout is prepared once per ``train`` call.  On a CUDA
device the Adam step's interior residual runs through the hand-written kernels
of ``ops/fused_residual.py`` (K1/K2; K2-FF for a net behind a Fourier-feature
embedding; K4, the precoeff residual, for exact BC/IC and per-node test
tables; K3, the jacobian-panel residual, for nonlinear advection: viscous
Burgers, ``ADPDE(nl_adv=b)``), and the value + jacobian evaluation of the LM refinement and of the
Adam general path through those of ``ops/value_and_jac.py`` (K5 forward and
backward, K6 JVP; K7/K8 with the embedding); on the CPU through their plain
versions.  ``train`` and ``refine_lm`` checkpoint into a case folder
(``train/checkpoint.py``), resume from it with global step numbering, and retry
transient device faults (``train/fault.py``), as the JAX package's do.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import shutil
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .fem.adaptive import refine_fixed
from .fem.assembly import FixedData, _pad_axis0, build_fixed_data, pad_points, pad_quad
from .fem.hardbc import HardBC, HardQuad, hard_transform, tables_to
from .models.mlp import (
    ff_apply,
    ff_value_and_jac,
    init_mlp,
    leaf_segments,
    make_fourier_features,
    make_input_scaling,
    mlp_apply,
    mlp_value_and_jac,
    params_from_jax,
    ravel_params,
)
from .ops import value_and_jac as vj
from .ops.fused_residual import prepare_residual_coeffs, prepare_residual_data
from .ops.residual import support_volume, weak_residual
from .problems.adpde import ADPDE, NeumannBC, RobinBC
from .train.checkpoint import (
    list_checkpoint_steps,
    load_checkpoint,
    load_config,
    load_meta,
    save_checkpoint,
    save_meta,
)
from .train.fault import is_transient_device_error
from .train.gauss_newton import LMState, make_lm_step, make_residual_fn
from .train.loss import make_loss_fn
from .train.optim import OptimizerConfig, make_optimizer
from .train.trainer import TrainResult, make_train_step, split_batches, split_rows
from .utils.helpers import matmul_precision_scope, rel_l2_error

# quadrature points per host call of the exact-BC table build: chunks small
# enough for the caches, built by a few threads (NumPy releases the GIL in its
# array operations); the tables are per point, so chunking changes no value
HARD_TABLE_CHUNK = 1 << 16
HARD_TABLE_THREADS = 8


class VarNet:
    """Variational PDE solver: neural trial function + weak-form loss.

      pde:          ADPDE problem definition
      layer_width:  hidden-layer widths of the MLP trial function
      disc_num:     spatial elements per dimension (int or per-dim seq)
      b_disc_num:   boundary points per segment edge
      t_disc_num:   time elements (time-dependent problems only)
      integ_p_num:  Gauss-Legendre points per dim per element
      test_order:   1 = hat test space (the reference's); 2 = quadratic
                    Lagrange test space (per-node [K, nQ] test tables)
      activation:   'tanh' | 'sigmoid'
      seed:         seed of the ``torch.Generator`` that draws the initial net
      device:       torch device of the fixed data, parameters and training;
                    'cuda' raises when no GPU is present (no fallback)
      optimizer:    OptimizerConfig (Adam by default)
      input_scaling: inputs scaled onto [-1, 1] from the domain bounds (the
                    JAX package's default); False feeds raw coordinates to
                    every path (fused residual, general path, BC/IC
                    penalties, LM residual, ``evaluate``)
      fourier_features: F > 0 puts a fixed random-Fourier-feature embedding
                    [sin | cos](2 pi x B) (B [n_in, F]) in front of the MLP,
                    whose input width becomes 2F
      fourier_scale: std of B, a sequence of stds (multi-scale basis, F
                    split across them) or their string form "0.5,2.0"
      fourier_b:    an explicit B [n_in, F] (e.g. the JAX package's draw,
                    which a ``torch.Generator`` cannot reproduce); no draw is
                    made then

      hard_bc:      exact Dirichlet-BC/IC imposition (``fem/hardbc.py``): the
                    trial function is G + tau(t) D(x) net(x, t), the BC/IC
                    penalty rows drop out and only the interior weak residual
                    trains.  A plain net's residual folds the ansatz into K4's
                    precomputed coefficients; with an embedding, or with
                    ``use_fused_residual=False``, it takes the general path;
                    ``refine_lm`` always takes the value + jacobian path
      fused_precoeff: the precoeff residual (K4) for shared [nQ] tables too;
                    it is selected anyway for exact BC and per-node tables
                    (order 2, adaptively refined hats)
      fused_directional: the directional residual kernels (K1/K2, K2-FF, K4);
                    False takes the jacobian-panel residual K3 (1 + n_in
                    panels).  A nonlinear problem (``pde.nl_adv``) forces
                    False unless ``fused_precoeff``: its term u (b . grad u)
                    is bilinear in u and grad u, which one direction cannot
                    carry.  Exact BC with nonlinear advection takes the
                    general path, as in the JAX package.  The argument is
                    kept for parity with the JAX constructor: for a linear
                    problem False computes the same residual as True, on
                    K3 in place of the directional kernels.

      use_fused_residual: interior residual through the fused residual
                    (kernel on CUDA, plain version on CPU); False takes the
                    general value + jacobian path
      use_pallas:   the value + jacobian evaluation of ``refine_lm`` and of
                    the Adam general path through ``ops/value_and_jac.py``
                    (kernels K5/K6 or K7/K8 on CUDA, their plain versions on
                    CPU); "auto" = on a CUDA device.  False takes
                    ``mlp_value_and_jac`` (``ff_value_and_jac``) under
                    autograd.  (The JAX package's name for its Pallas kernels.)
    """

    def __init__(
        self,
        pde: ADPDE,
        layer_width: Sequence[int] = (20, 20),
        disc_num=20,
        b_disc_num: int = 10,
        t_disc_num: Optional[int] = None,
        integ_p_num: int = 2,
        test_order: int = 1,
        activation: str = "tanh",
        seed: int = 0,
        device="cuda",
        optimizer: Optional[OptimizerConfig] = None,
        use_fused_residual: bool = True,
        use_pallas="auto",
        input_scaling: bool = True,
        fourier_features: Optional[int] = None,
        fourier_scale=0.5,
        fourier_b=None,
        hard_bc: bool = False,
        fused_precoeff: bool = False,
        fused_directional: bool = True,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VarNet(device='cuda'): no CUDA device is available")
        if fused_precoeff and not fused_directional:
            raise ValueError("fused_precoeff=True requires fused_directional=True")
        self.pde = pde
        # the constant Burgers direction b (None: a linear problem); its term is
        # bilinear in (u, grad u), so only the jacobian-panel residual K3 carries it
        self.nl_vec = getattr(pde, "nl_adv", None)
        self.fused_directional = bool(fused_directional)
        if self.nl_vec is not None and not fused_precoeff:
            self.fused_directional = False
        self.layer_width = tuple(int(w) for w in layer_width)
        self.disc_num = disc_num
        self.b_disc_num = int(b_disc_num)
        self.t_disc_num = None if t_disc_num is None else int(t_disc_num)
        self.integ_p_num = int(integ_p_num)
        self.test_order = int(test_order)
        self.activation = activation
        self.seed = int(seed)
        self.optimizer_cfg = optimizer or OptimizerConfig()
        self.use_fused_residual = bool(use_fused_residual)
        self.fused_precoeff = bool(fused_precoeff)
        self.use_pallas = (self.device.type == "cuda" if use_pallas == "auto"
                           else bool(use_pallas))
        self.has_react = not (
            pde.react is None
            or (np.isscalar(pde.react) and float(pde.react) == 0.0)
        )
        # exact BC/IC: the host-side transform builder; its tables are built at
        # the (padded) quad coords when a run needs them (_hard_tables)
        # the flux penalty and the LM flux rows are not ported: refuse rather
        # than train a problem without its Neumann/Robin conditions
        if any(isinstance(g, (NeumannBC, RobinBC)) for g in pde.bcs):
            raise NotImplementedError(
                "Neumann/Robin flux rows are not ported to varnet_tpu_torch yet, in penalty "
                "or hard_bc mode (the loss's flux penalty and the LM residual's flux rows)")
        self.hard = None
        if hard_bc:
            self.hard = HardBC(pde)
        self._hard_cache = None
        self.hard_table_seconds = 0.0
        self.fixed: FixedData = build_fixed_data(
            pde, disc_num, b_disc_num=self.b_disc_num, t_disc_num=self.t_disc_num,
            integ_p_num=self.integ_p_num, pad_multiple=1, test_order=self.test_order,
        )
        self.static = self.fixed.static
        gen = torch.Generator().manual_seed(self.seed)
        # the embedding is drawn before the net, as the JAX package splits its key
        self.fourier_b = None
        n_in = self.static.n_inputs
        if fourier_b is not None:
            b_mat = torch.as_tensor(np.asarray(fourier_b), dtype=torch.float32)
            if b_mat.ndim != 2 or b_mat.shape[0] != n_in or (
                    fourier_features is not None and b_mat.shape[1] != int(fourier_features)):
                raise ValueError(f"fourier_b must be [{n_in}, F], got {tuple(b_mat.shape)}")
            self.fourier_b = b_mat.to(self.device)
        elif fourier_features is not None:
            self.fourier_b = make_fourier_features(gen, n_in, int(fourier_features),
                                                   fourier_scale).to(self.device)
        net_in = n_in if self.fourier_b is None else 2 * self.fourier_b.shape[1]
        self.theta = init_mlp(gen, net_in, self.layer_width, device=self.device)
        self.input_scaling = bool(input_scaling)
        self.scale = self.shift = None
        if self.input_scaling:
            self.scale, self.shift = make_input_scaling(
                self.static.input_lo, self.static.input_hi, device=self.device)
        self.opt_state = None   # the optimizer state of the last load_model
        self.train_result: Optional[TrainResult] = None

    @property
    def fourier_bt(self) -> Optional[torch.Tensor]:
        """2 pi B^T [F, n_in] in f32, as the JAX package hands it to its kernels."""
        if self.fourier_b is None:
            return None
        return ((2.0 * math.pi) * self.fourier_b.T).contiguous()

    def _apply_fn(self):
        """u_theta at points: ``mlp_apply`` or, with an embedding, ``ff_apply``."""
        if self.fourier_b is None:
            return mlp_apply
        return functools.partial(ff_apply, self.fourier_b)

    def _value_and_jac(self, kernel: bool):
        """(u, du/dx) evaluation: through the kernels' autograd Function
        (K5/K6, or K7/K8 with an embedding) when ``kernel``, else the plain
        matmul chain."""
        if self.fourier_b is None:
            return vj.value_and_jac if kernel else mlp_value_and_jac
        return functools.partial(vj.ff_value_and_jac if kernel else ff_value_and_jac,
                                 self.fourier_b)

    @property
    def _per_node_tables(self) -> bool:
        """True when the quad carries per-node N/dN/w tables: the order-2 test
        space or an adaptively refined (mixed-scale) hat space."""
        return self.test_order != 1 or self.fixed.quad.tables_per_node

    @property
    def _precoeff_selected(self) -> bool:
        """The precoeff residual (K4) is in play: asked for, exact BC (its
        coefficients absorb the affine ansatz), or per-node test tables of a
        plain net on the directional layout of a linear problem (the table
        kernels K1/K2 take shared [nQ] tables only)."""
        return (self.fused_precoeff or self.hard is not None
                or (self._per_node_tables and self.fused_directional
                    and self.fourier_b is None and self.nl_vec is None))

    @property
    def _fused_kind(self) -> Optional[str]:
        """The Adam step's interior residual: 'precoeff' (K4), 'dir' (K1/K2 or
        K2-FF), 'jac' (K3, the jacobian-panel layout: nonlinear advection or
        ``fused_directional=False``) or None (the general value + jacobian
        path), gated as the JAX package's ``_fused_residual_hook``: exact BC
        folds into K4 only (directional, plain net, linear problem); the
        nonlinear term rides K3 only (no embedding, no precoeff fold); a
        Fourier-feature net takes the directional layout only, without the
        precoeff fold or per-node tables; per-node tables need the fold."""
        if not self.use_fused_residual:
            return None
        precoeff = self._precoeff_selected
        embedded = self.fourier_b is not None
        if (self.hard is not None
                and (not self.fused_directional or embedded or self.nl_vec is not None)):
            return None
        if self.nl_vec is not None and (embedded or precoeff):
            return None
        if embedded and (not self.fused_directional or precoeff or self._per_node_tables):
            return None
        if self._per_node_tables and not precoeff:
            return None
        if not self.fused_directional:
            return "jac"
        return "precoeff" if precoeff else "dir"

    def _hard_tables(self, quad_h) -> Optional[HardQuad]:
        """The exact-BC tables (host f64) at the coords of ``quad_h``, a
        ``pad_quad`` of ``self.fixed.quad``: built at the real rows once per
        test space (in chunks, on a few threads) and padded as ``pad_quad``
        pads, by repeating row 0.  ``hard_table_seconds`` holds the build's
        wall time."""
        if self.hard is None:
            return None
        if self._hard_cache is None or self._hard_cache[0] is not self.fixed:
            t0 = time.perf_counter()
            real = int(self.fixed.quad.mask.sum())
            coords = np.asarray(self.fixed.quad.coords)[:real]
            rows = max(1, HARD_TABLE_CHUNK // coords.shape[1])
            workers = max(1, min(HARD_TABLE_THREADS, os.cpu_count() or 1))
            with ThreadPoolExecutor(workers) as pool:
                parts = list(pool.map(self.hard.tables,
                                      [coords[i:i + rows] for i in range(0, real, rows)]))
            hq = HardQuad(*(None if parts[0][f] is None
                            else np.concatenate([p[f] for p in parts])
                            for f in range(len(HardQuad._fields))))
            self._hard_cache = (self.fixed, hq)
            self.hard_table_seconds = time.perf_counter() - t0
        k = quad_h.coords.shape[0]
        return HardQuad(*(None if a is None else _pad_axis0(a, k) for a in self._hard_cache[1]))

    # ------------------------------------------------------------------ #
    # training

    def _to_device(self, arrays):
        """A QuadData / PointData of host arrays as f32 tensors on the device."""
        return type(arrays)(*(torch.from_numpy(np.array(a, dtype=np.float32)).to(self.device)
                              for a in arrays))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(
        self,
        epoch_num: int,
        weight: Optional[Sequence[float]] = None,
        batch_num: int = 1,
        save_freq: int = 500,
        folderpath: Optional[str] = None,
        resume: bool = False,
        verbose: bool = True,
        error_disc: int = 64,
        error_times: int = 5,
        target_error: Optional[float] = None,
        max_retries: int = 0,
        retry_backoff: float = 30.0,
    ) -> TrainResult:
        """Run the training loop (reference ``VarNet.train``).

        weight:      (w_int, w_bc[, w_ic]) loss weights
        batch_num:   interior mini-batches per epoch
        save_freq:   report / checkpoint period (epochs)
        folderpath:  case directory for the checkpoints (``ckpt_<epoch>/`` with
                     theta and the optimizer state, a meta sidecar with the
                     seed, ``config.json``), the JSONL training log and
                     train_result.json
        resume:      restore the newest checkpoint of ``folderpath`` first;
                     ``epoch_num`` then counts the TOTAL epochs (global epoch
                     semantics, as ``refine_lm``): a checkpoint at step >=
                     ``epoch_num`` makes the call a no-op that restores theta
                     and leaves the folder alone, so a recovery loop can re-run
                     the same command; an empty folder starts fresh
        target_error: optional early-stop threshold on rel-L2 error
        max_retries: on a transient device fault (``train/fault.py``),
                     re-enter the loop up to this many times, resuming from
                     the newest checkpoint when ``folderpath`` is set
        retry_backoff: seconds to sleep before each retry

        Matmuls outside the kernel run with TF32 off (exact f32), as the
        kernel does on the CUDA cores.
        """
        if resume and folderpath is None:
            raise ValueError("resume=True requires folderpath (nothing to resume from)")

        def newest():
            steps = list_checkpoint_steps(folderpath) if folderpath else []
            return steps[-1] if steps else 0

        # global-epoch accounting: checkpoints this call writes land in (start,
        # target]; ``pre`` tells them from stale ones already in the folder (a
        # fresh resume=False run never resumes from those, it restarts)
        pre = newest()
        start = pre if resume else 0
        target = max(int(epoch_num), start) if resume else start + int(epoch_num)
        st = {"epochs": target - start, "resume": resume}
        if resume and target == start:
            if verbose:
                print(f"[varnet] resume: {start} epochs already complete "
                      f"(budget {int(epoch_num)}), skipping training")
            self._restore_theta(folderpath)
            self.train_result = TrainResult()
            return self.train_result

        def attempt_fn():
            with matmul_precision_scope():
                return self._train_impl(st["epochs"], weight, int(batch_num), save_freq,
                                        folderpath, st["resume"], verbose, error_disc,
                                        error_times, target_error)

        def on_fault(_attempt):
            now = newest()
            trust = now > pre or (resume and now == pre)
            if trust and now >= target:
                return TrainResult()   # faulted after the final checkpoint: done
            if trust:
                st["resume"], st["epochs"] = True, target - max(now, start)
                return f"resuming from epoch {max(now, start)} in {folderpath}"
            st["resume"], st["epochs"] = False, int(epoch_num)
            return "restarting from in-memory state (no checkpoint yet)"

        return self._retry_transient(attempt_fn, on_fault, max_retries, retry_backoff,
                                     verbose, label="", include_oom=False)

    def _retry_transient(self, attempt_fn, on_fault, max_retries, retry_backoff, verbose,
                         label, include_oom):
        """Shared transient-fault retry loop: runs ``attempt_fn()``; on a
        transient device error (``train/fault.py``) frees the allocator's
        cache and calls ``on_fault(attempt)`` to reposition state for the next
        attempt; it returns a description, or a terminal ``TrainResult`` when
        the checkpoints show the work already done.  Program errors and sticky
        CUDA errors propagate at once."""
        attempt = 0
        while True:
            try:
                return attempt_fn()
            except RuntimeError as err:
                if attempt >= int(max_retries) or not is_transient_device_error(
                        err, include_oom=include_oom):
                    raise
                fault = f"{type(err).__name__}: {str(err).splitlines()[0][:200]}"
            # out of the except block the traceback's frames, and the tensors
            # they hold, are released: collect them and return the cache
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            attempt += 1
            outcome = on_fault(attempt)
            if isinstance(outcome, TrainResult):
                return outcome
            if verbose:
                print(f"[varnet{label}] transient device fault (retry {attempt}/"
                      f"{int(max_retries)}, {fault}): {outcome} after "
                      f"{float(retry_backoff):.0f}s", flush=True)
            if retry_backoff > 0:
                time.sleep(float(retry_backoff))

    def _train_impl(self, epoch_num, weight, batch_num, save_freq, folderpath, resume,
                    verbose, error_disc, error_times, target_error):
        td = self.static.time_dependent
        if weight is None:
            weight = (1.0, 1.0) + ((1.0,) if td else ())
        w_full = [float(w) for w in weight] + [0.0] * (3 - len(weight))

        quad_h = pad_quad(self.fixed.quad, batch_num)
        quad_d = self._to_device(quad_h)
        bc_d = self._to_device(pad_points(self.fixed.bc, 1))
        ic_d = None if self.fixed.ic is None else self._to_device(pad_points(self.fixed.ic, 1))
        kind = self._fused_kind

        loss_fn = make_loss_fn(self.static, activation=self.activation,
                               has_react=self.has_react, fused=kind is not None,
                               device=self.device, input_scaling=self.input_scaling,
                               value_and_jac=self._value_and_jac(self.use_pallas),
                               apply_fn=self._apply_fn(), hard_mode=self.hard is not None,
                               nl_vec=self.nl_vec)
        # one host f64 table build serves the K4 fold or the general path's tables
        hard_h = self._hard_tables(quad_h)
        if batch_num == 1:
            quads, hards = quad_d, hard_h
        else:
            quads = split_batches(quad_d, batch_num)
            hards = [None] * batch_num if hard_h is None else split_rows(hard_h, batch_num)

        def prepare(q, hq):
            # the fused kernel's data layout, ONCE per train call (not per step)
            if kind == "precoeff":
                return prepare_residual_coeffs(q, self.scale, self.shift, time_dependent=td,
                                               has_react=self.has_react, hard=hq,
                                               device=self.device)
            if kind == "dir":
                return prepare_residual_data(q, self.scale, self.shift, time_dependent=td,
                                             has_react=self.has_react, device=self.device,
                                             fourier_bt=self.fourier_bt)
            if kind == "jac":
                return prepare_residual_data(q, self.scale, self.shift, time_dependent=td,
                                             has_react=self.has_react, device=self.device,
                                             nl_vec=self.nl_vec, jacobian=True)
            return None

        def hard_tensors(hq):
            # the general path's tables (the fused path has them folded in)
            return None if hq is None or kind is not None else tables_to(hq, self.device)

        if batch_num == 1:
            prepared, hard_d = prepare(quads, hards), hard_tensors(hards)
        else:
            prepared = [prepare(q, h) for q, h in zip(quads, hards)]
            hard_d = [hard_tensors(h) for h in hards]

        theta = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
                 for layer in self._params(None)]
        optimizer = make_optimizer(self.optimizer_cfg,
                                   [layer[k] for layer in theta for k in ("w", "b")])
        start_epoch = 0
        if resume:
            try:
                state, step = load_checkpoint(
                    folderpath, {"theta": theta, "opt_state": optimizer.state_dict()},
                    map_location=self.device)
            except FileNotFoundError:
                # nothing persisted yet (the previous attempt died before its
                # first checkpoint): start fresh, so a recovery loop progresses
                state, step = None, 0
                if verbose:
                    print(f"[varnet] resume: no checkpoints in {folderpath} yet, "
                          "starting fresh")
            if state is not None:
                with torch.no_grad():   # in place: the leaves keep requires_grad
                    for layer, stored in zip(theta, state["theta"]):
                        for k in ("w", "b"):
                            layer[k].copy_(stored[k])
                optimizer.load_state_dict(state["opt_state"])
                start_epoch = step
                if verbose:
                    print(f"[varnet] resumed from epoch {step} in {folderpath}")
        step_fn = make_train_step(loss_fn, optimizer, batch_num=batch_num)

        result = TrainResult()
        log_path = None
        if folderpath is not None:
            os.makedirs(folderpath, exist_ok=True)
            log_path = os.path.join(folderpath, "train_log.jsonl")
        n_real_quad = self.static.n_test * self.static.n_quad_per_test
        t_start = None          # set after the first (warm-up) step
        timed_epochs = 0
        report_overhead = 0.0   # host + eval time excluded from throughput
        for epoch in range(start_epoch + 1, start_epoch + epoch_num + 1):
            aux = step_fn(theta, quads, bc_d, ic_d, w_full, prepared, hard_d)
            if t_start is None:
                self._sync()
                t_start = time.perf_counter()
            else:
                timed_epochs += 1
            last = epoch == start_epoch + epoch_num
            if epoch % int(save_freq) == 0 or last:
                # drain the queued device work first so it counts as training time
                self._sync()
                t_rep = time.perf_counter()
                aux_host = {k: float(v) for k, v in aux.items()}
                err = self.compute_error(theta, disc=error_disc, n_times=error_times)
                elapsed = time.perf_counter() - t_start
                result.epochs.append(epoch)
                result.losses.append(aux_host)
                result.errors.append(err if err is not None else float("nan"))
                result.wall_times.append(elapsed)
                if verbose:
                    err_s = f"{err:.3e}" if err is not None else "n/a"
                    print(f"[varnet] epoch {epoch:7d}  loss {aux_host['loss']:.4e}"
                          f"  int {aux_host['loss_int']:.3e}  bc {aux_host['loss_bc']:.3e}"
                          + (f"  ic {aux_host['loss_ic']:.3e}" if "loss_ic" in aux_host else "")
                          + f"  relL2 {err_s}  ({elapsed:.1f}s)", flush=True)
                if log_path is not None:
                    with open(log_path, "a") as f:
                        f.write(json.dumps({"epoch": epoch, "err": err, **aux_host}) + "\n")
                    self._save(folderpath, epoch, theta, {"seed": self.seed}, optimizer)
                report_overhead += time.perf_counter() - t_rep
                if target_error is not None and err is not None and err < target_error:
                    if verbose:
                        print(f"[varnet] target error {target_error:.1e} reached")
                    break

        self._sync()
        total_time = time.perf_counter() - t_start - report_overhead if t_start else 0.0
        result.total_steps = timed_epochs * batch_num
        result.steps_per_sec = result.total_steps / total_time if total_time > 0 else 0.0
        result.quad_evals_per_sec = (
            timed_epochs * n_real_quad / total_time if total_time > 0 else 0.0)
        self.theta = [{k: v.detach() for k, v in layer.items()} for layer in theta]
        self.train_result = result
        if folderpath is not None:
            with open(os.path.join(folderpath, "train_result.json"), "w") as f:
                json.dump(result.as_dict(), f, indent=2)
        return result

    # ------------------------------------------------------------------ #
    # Levenberg-Marquardt refinement

    def refine_lm(
        self,
        steps: int = 100,
        weight: Optional[Sequence[float]] = None,
        cg_iters: int = 50,
        save_freq: int = 10,
        verbose: bool = True,
        error_disc: int = 64,
        error_times: int = 5,
        lam0: float = 1e-3,
        target_error: Optional[float] = None,
        matmul_precision: Optional[str] = "highest",
        k_chunks: int = 1,
        folderpath: Optional[str] = None,
        cg_segment: int = 0,
        resume: bool = False,
        max_retries: int = 0,
        retry_backoff: float = 30.0,
        precond: int = 0,
        precond_mode: str = "leaf",
    ) -> TrainResult:
        """Levenberg-Marquardt refinement (matrix-free Gauss-Newton + CG; see
        ``train/gauss_newton.py``), the reference ``VarNet.refine_lm``.  Start
        from an Adam-trained state.

        steps:       LM iterations; cg_iters CG iterations each
        weight:      (w_int, w_bc[, w_ic]) loss weights
        save_freq:   report period (iterations): loss, lam and rel-L2
        lam0:        initial damping
        k_chunks:    interior evaluated in that many checkpointed chunks of the
                     test-function axis (bounds the reverse pass's memory)
        cg_segment:  CG in segments of that many iterations, re-linearized
                     per segment (0: one linearization per step)
        precond:     Hutchinson probes of the Jacobi preconditioner (0: plain
                     CG); precond_mode 'leaf' (per-leaf means) or 'diag'
        target_error: early stop once rel-L2 falls below it

        On the kernel path (``use_pallas``) J v runs K6 and J^T w K5's
        backward (K8 and K7's backward with a Fourier-feature embedding), with
        exact BC, per-node test tables and nonlinear advection too (the JAX
        package's LM takes the value + jacobian kernels there as well).

        Fault recovery (checkpoint-restart):

        folderpath:  LM checkpoints (theta; lam and loss in the meta sidecar)
                     go to its ``lm/`` subfolder at each report iteration,
                     numbered globally across resumed runs, apart from the
                     epoch-numbered ones of ``train``; a fresh run
                     (``resume=False``) clears a stale ``lm/``
        resume:      restore the newest LM checkpoint (theta and lam) and
                     continue toward ``steps`` TOTAL iterations
        max_retries: on a transient device fault (``train/fault.py``, out of
                     memory included), resume from the newest checkpoint up
                     to this many times, with the allocator's cache freed and
                     ``k_chunks`` doubled each retry.  Program errors
                     propagate, and so do sticky CUDA errors (illegal address,
                     launch failure, ECC), after which the process's context
                     is dead: the checkpoints then serve a cross-process
                     ``resume=True``, as does a hung card.
        retry_backoff: seconds to sleep before each retry
        """
        if resume and folderpath is None:
            raise ValueError("resume=True requires folderpath (nothing to resume from)")
        lm_folder = None if folderpath is None else os.path.join(folderpath, "lm")
        st = {"steps": int(steps), "lam": float(lam0), "k": int(k_chunks), "offset": 0}

        def restore():
            st["offset"], lam_meta = self._restore_theta(lm_folder)
            if lam_meta is not None:
                st["lam"] = float(lam_meta)
            st["steps"] = int(steps) - st["offset"]

        def done():
            result = TrainResult()
            result.total_steps = int(steps)
            return result

        if resume:
            restore()
            if verbose and st["offset"]:
                print(f"[varnet/lm] resumed from LM step {st['offset']} in {lm_folder} "
                      f"(lam {st['lam']:.1e})")
            if st["steps"] <= 0:
                return done()
        elif lm_folder is not None and list_checkpoint_steps(lm_folder):
            shutil.rmtree(lm_folder)
            if verbose:
                print(f"[varnet/lm] cleared stale LM checkpoints in {lm_folder} (fresh "
                      "run; pass resume=True to continue them instead)")

        def attempt_fn():
            with matmul_precision_scope(matmul_precision):
                return self._refine_lm_impl(
                    st["steps"], weight, int(cg_iters), int(save_freq), verbose, error_disc,
                    error_times, st["lam"], target_error, st["k"], int(cg_segment),
                    int(precond), precond_mode, lm_folder, st["offset"])

        def on_fault(_attempt):
            if lm_folder is not None:
                restore()
            else:
                st["steps"] = int(steps)
            if st["steps"] <= 0:
                return done()   # faulted after the final checkpoint
            st["k"] *= 2
            return (f"resuming from LM step {st['offset']} with k_chunks {st['k']}, "
                    f"lam {st['lam']:.1e}")

        return self._retry_transient(attempt_fn, on_fault, max_retries, retry_backoff,
                                     verbose, label="/lm", include_oom=True)

    def _refine_lm_impl(self, steps, weight, cg_iters, save_freq, verbose, error_disc,
                        error_times, lam0, target_error, k_chunks, cg_segment, precond,
                        precond_mode, folderpath=None, step_offset=0) -> TrainResult:
        td = self.static.time_dependent
        if weight is None:
            weight = (1.0, 1.0) + ((1.0,) if td else ())
        w_full = [float(w) for w in weight] + [0.0] * (4 - len(weight))
        if not td:
            w_full = [w_full[0], w_full[1], 0.0, w_full[2]]

        quad_h = pad_quad(self.fixed.quad, k_chunks)
        quad_d = self._to_device(quad_h)
        bc_d = self._to_device(pad_points(self.fixed.bc, 1))
        ic_d = None if self.fixed.ic is None else self._to_device(pad_points(self.fixed.ic, 1))
        hard_h = self._hard_tables(quad_h)
        hard_d = None if hard_h is None else tables_to(hard_h, self.device)
        res_fn = make_residual_fn(
            self.static, activation=self.activation, k_chunks=k_chunks,
            value_and_jac=self._value_and_jac(self.use_pallas),
            has_react=self.has_react, device=self.device,
            input_scaling=self.input_scaling, apply_fn=self._apply_fn(),
            hard_mode=self.hard is not None, nl_vec=self.nl_vec)
        theta0 = self._params(None)
        flat0, unravel = ravel_params(theta0)

        def closure(flat):
            return res_fn(unravel(flat), quad_d, bc_d, ic_d, w_full, hard=hard_d)

        lm_step = make_lm_step(closure, cg_iters=cg_iters, cg_segment=cg_segment,
                               precond=precond, leaf_segments=leaf_segments(theta0),
                               precond_mode=precond_mode)
        with torch.no_grad():
            r0 = closure(flat0)
        state = LMState(flat=flat0,
                        lam=torch.tensor(lam0, dtype=torch.float32, device=self.device),
                        loss=torch.dot(r0, r0))

        result = TrainResult()
        t_start = None
        for it in range(1, steps + 1):
            state = lm_step(state)
            if t_start is None:
                self._sync()
                t_start = time.perf_counter()
            if it % save_freq == 0 or it == steps:
                theta_now = unravel(state.flat)
                loss, lam = float(state.loss), float(state.lam)
                err = self.compute_error(theta_now, disc=error_disc, n_times=error_times)
                it_g = step_offset + it
                result.epochs.append(it_g)
                result.losses.append({"loss": loss, "lam": lam})
                result.errors.append(err if err is not None else float("nan"))
                result.wall_times.append(time.perf_counter() - t_start)
                if verbose:
                    err_s = f"{err:.3e}" if err is not None else "n/a"
                    print(f"[varnet/lm] it {it_g:5d}  loss {loss:.4e}  lam {lam:.1e}"
                          f"  relL2 {err_s}  ({result.wall_times[-1]:.1f}s)", flush=True)
                if folderpath is not None:
                    # lam in the sidecar makes the restart exact: a resumed run
                    # re-enters with the damping it stopped at
                    self._save(folderpath, it_g, theta_now,
                               {"lam": lam, "loss": loss, "phase": "lm"})
                if target_error is not None and err is not None and err < target_error:
                    if verbose:
                        print(f"[varnet/lm] target {target_error:.1e} reached")
                    break
        self.theta = [{k: v.detach().clone() for k, v in layer.items()}
                      for layer in unravel(state.flat)]
        result.total_steps = step_offset + steps
        self.train_result = result
        return result

    # ------------------------------------------------------------------ #
    # persistence

    def config_dict(self) -> Dict[str, Any]:
        """The problem / discretization fingerprint stored beside checkpoints
        (``config.json``): the JAX package's keys, with the same values for
        the same problem."""
        return {
            "layer_width": list(self.layer_width),
            "disc_num": self.disc_num if np.isscalar(self.disc_num) else list(self.disc_num),
            "b_disc_num": self.b_disc_num,
            "t_disc_num": self.t_disc_num,
            "integ_p_num": self.integ_p_num,
            "test_order": self.test_order,
            "activation": self.activation,
            "n_inputs": self.static.n_inputs,
            "n_test": self.static.n_test,
            "time_dependent": self.static.time_dependent,
            "hard_bc": self.hard is not None,
            "param_count": int(sum(np.prod(v.shape) for layer in self.theta
                                   for v in layer.values())),
        }

    def _save(self, folderpath, step, theta, meta, optimizer=None):
        """One checkpoint (theta, the optimizer's state when given), its meta
        sidecar and ``config.json``."""
        state = {"theta": [{k: v.detach().clone() for k, v in layer.items()}
                           for layer in theta]}
        if optimizer is not None:
            state["opt_state"] = optimizer.state_dict()
        save_checkpoint(folderpath, step, state, config=self.config_dict())
        save_meta(folderpath, step, meta)

    def _restore_theta(self, folderpath):
        """Load the newest checkpoint's theta into ``self.theta``.  Returns
        ``(step, lam)``: the step (0 when the folder holds none) and lam from
        its meta sidecar (None for a checkpoint of ``train``).  The
        params-only restore is deliberate here, so its warning is silenced.
        A ``train`` checkpoint's meta holds the constructor seed: the port
        keeps no training-time generator (the LM probes' is seeded afresh)."""
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message="stored optimizer state")
                state, step = load_checkpoint(folderpath, {"theta": self._params(None)},
                                              map_location=self.device)
        except FileNotFoundError:
            return 0, None
        self.theta = state["theta"]
        meta = load_meta(folderpath, step)
        return int(step), None if meta is None else meta.get("lam")

    def load_model(self, folderpath: str, step: Optional[int] = None) -> int:
        """Restore theta (and the optimizer state, kept in ``opt_state``) from a
        case folder (reference ``VarNet.loadModel``); the stored config's
        ``layer_width``, ``n_inputs``, ``activation`` and ``time_dependent``
        must match this instance's.  Returns the step."""
        stored = load_config(folderpath)
        if stored is not None:
            ours = self.config_dict()
            for k in ("layer_width", "n_inputs", "activation", "time_dependent"):
                if stored.get(k) != ours[k]:
                    raise ValueError(f"checkpoint config mismatch on '{k}': "
                                     f"{stored.get(k)} != {ours[k]}")
        theta = self._params(None)
        optimizer = make_optimizer(self.optimizer_cfg,
                                   [layer[k] for layer in theta for k in ("w", "b")])
        state, step = load_checkpoint(folderpath, {"theta": theta,
                                                   "opt_state": optimizer.state_dict()},
                                      step, map_location=self.device)
        self.theta = state["theta"]
        self.opt_state = state["opt_state"]
        return step

    # ------------------------------------------------------------------ #
    # evaluation

    def _params(self, theta):
        """theta (None = current; torch tensors or a JAX-layout NumPy list) as
        tensors on the device."""
        theta = self.theta if theta is None else theta
        if isinstance(theta[0]["w"], torch.Tensor):
            return [{k: v.detach().to(self.device) for k, v in layer.items()}
                    for layer in theta]
        return params_from_jax(theta, device=self.device)

    def evaluate(self, x: np.ndarray, t: Optional[np.ndarray] = None,
                 mu: Optional[np.ndarray] = None, theta: Any = None,
                 chunk: int = 1 << 20) -> np.ndarray:
        """u_theta at points (reference ``VarNet.evaluate``), the net in exact
        f32; with exact BC the ansatz A + B n is applied on the host in f64.

        x: [P, d]; t: scalar or [P] (time-dependent problems);
        mu: [P, n_mor] or [n_mor] (parametric problems).  Large point sets
        are evaluated in chunks of ``chunk`` points."""
        coords = self._make_coords(x, t, mu)
        net = self._params(theta)
        apply = self._apply_fn()
        outs = []
        with torch.no_grad(), matmul_precision_scope():
            for s in range(0, coords.shape[0], chunk):
                block = torch.as_tensor(coords[s:s + chunk], dtype=torch.float32,
                                        device=self.device)
                u = apply(net, block, self.activation, self.scale, self.shift)
                outs.append(u.double().cpu().numpy())
        u = np.concatenate(outs) if outs else np.zeros(0)
        return u if self.hard is None else self._hard_combine(coords, u)

    def _hard_combine(self, coords: np.ndarray, u: np.ndarray) -> np.ndarray:
        """The exact-BC ansatz A + B u applied to raw net outputs on the host,
        in f64 (the transform fields involve user callables)."""
        a, b = self.hard.value_AB(coords)
        return a + b * u

    def _make_coords(self, x, t, mu) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        cols = [x]
        if self.static.time_dependent:
            if t is None:
                raise ValueError("time-dependent problem: t required")
            t = np.broadcast_to(np.asarray(t, dtype=np.float64), (x.shape[0],))
            cols.append(t[:, None])
        if self.static.n_mor:
            if mu is None:
                mu = self.pde.mor.samples[0]
            mu = np.asarray(mu, dtype=np.float64)
            if mu.ndim == 1:
                mu = np.broadcast_to(mu[None, :], (x.shape[0], mu.shape[0]))
            cols.append(mu)
        return np.concatenate(cols, axis=-1)

    def compute_error(self, theta: Any = None, disc: int = 64,
                      n_times: int = 5) -> Optional[float]:
        """Relative L2 error vs the exact solution on a (disc+1)^d grid (x
        ``n_times`` time slices); None when the problem has no ``c_ex``."""
        if self.pde.c_ex is None:
            return None
        pts, mask = self.pde.domain.grid_in_domain(
            (disc + 1,) * self.pde.dim if self.pde.dim > 1 else disc + 1
        )
        pts = pts[mask]
        mu0 = self.pde.mor.samples[0] if self.pde.mor is not None else None
        mu_b = (None if mu0 is None
                else np.broadcast_to(mu0[None, :], (pts.shape[0], mu0.shape[0])))
        if not self.static.time_dependent:
            return rel_l2_error(self.evaluate(pts, None, mu0, theta),
                                self.pde.eval_exact(pts, None, mu_b))
        t0, t1 = self.pde.t_interval
        preds, exacts = [], []
        for tv in np.linspace(t0, t1, int(n_times)):
            tcol = np.full(pts.shape[0], tv)
            preds.append(self.evaluate(pts, tcol, mu0, theta))
            exacts.append(self.pde.eval_exact(pts, tcol, mu_b))
        return rel_l2_error(np.concatenate(preds), np.concatenate(exacts))

    # ------------------------------------------------------------------ #
    # adaptive test spaces

    def test_residuals(self, theta: Any = None, chunk: int = 16384,
                       matmul_precision: Optional[str] = None) -> np.ndarray:
        """Per-test-function weak-residual densities r_k -> [n_test] (reference
        ``VarNet.test_residuals``): the support-volume-normalized residual the
        training loss squares, so ``sum(r**2) / n_test == loss_int``.  Through
        the plain value + jacobian path, in chunks of ``chunk`` test functions
        (a one-shot diagnostic); the refinement indicator of ``refine_tests``."""
        return self._residual_densities(self.fixed.quad, self.static.n_test, theta, chunk,
                                        matmul_precision)

    def _residual_densities(self, quad, k_real, theta, chunk, matmul_precision):
        """``test_residuals`` against any quadrature layout (the train mesh's
        or a finer probe mesh's, ``residual_adequacy``)."""
        net = self._params(theta)
        d, td, n_in = self.static.n_space, self.static.time_dependent, self.static.n_inputs
        vj_fn = self._value_and_jac(False)
        need_u = self.has_react or self.nl_vec is not None
        nl = (None if self.nl_vec is None
              else torch.as_tensor(np.asarray(self.nl_vec), dtype=torch.float32,
                                   device=self.device))
        per_node = quad.tables_per_node
        chunk = max(1, min(int(chunk), k_real))
        out = np.empty(k_real, dtype=np.float64)

        def dev(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(self.device)

        with torch.no_grad(), matmul_precision_scope(matmul_precision or "highest"):
            for lo in range(0, k_real, chunk):
                sl = slice(lo, min(lo + chunk, k_real))
                coords_c = np.asarray(quad.coords[sl]).astype(np.float32)
                c, nq = coords_c.shape[0], coords_c.shape[1]
                tbls = [dev(a[sl] if per_node else a) for a in (quad.N, quad.dN, quad.w)]
                u, du = vj_fn(net, dev(coords_c).reshape(c * nq, n_in), self.activation,
                              self.scale, self.shift)
                grad_u = du[:, :d].reshape(c, nq, d)
                u_t = du[:, d].reshape(c, nq) if td else None
                u = u.reshape(c, nq)
                if self.hard is not None:
                    # tables at the f32 coords, as the JAX package builds them here
                    hq = tables_to(self.hard.tables(coords_c), self.device)
                    u, grad_u, u_t = hard_transform(u, grad_u, u_t, hq)
                r = weak_residual(grad_u, *tbls, dev(quad.kappa[sl]), dev(quad.vel[sl]),
                                  dev(quad.src[sl]), u_t, u=u if need_u else None,
                                  react=dev(quad.react[sl]) if self.has_react else None,
                                  nl_vec=nl)
                out[sl] = (r / support_volume(tbls[2])).double().cpu().numpy()
        return out

    def residual_adequacy(self, theta: Any = None, refine: int = 2,
                          integ_p_num: Optional[int] = None, threshold: float = 10.0,
                          chunk: int = 16384, probe_n: Optional[int] = None,
                          probe_seed: int = 0, matmul_precision: Optional[str] = None,
                          verbose: bool = True) -> dict:
        """Guard against residual-consistent wrong solutions (reference
        ``VarNet.residual_adequacy``): re-score the residual densities on an
        independent probe test mesh ``refine`` x finer per dimension (space
        and time).  A converged solution gives a probe/train RMS ratio near 1;
        ratio > ``threshold`` flags a test space too coarse for the net.
        ``probe_n`` caps the probe at a seeded random subset of test classes."""
        f = int(refine)
        if f < 2:
            raise ValueError("refine must be >= 2 (an identical probe "
                             "mesh cannot detect underdetermination)")
        disc = self.disc_num
        probe_disc = [int(v) * f for v in disc] if np.ndim(disc) else int(disc) * f
        probe_t = None if self.t_disc_num is None else int(self.t_disc_num) * f
        probe_fixed = build_fixed_data(
            self.pde, probe_disc, b_disc_num=self.b_disc_num, t_disc_num=probe_t,
            integ_p_num=int(integ_p_num or self.integ_p_num), pad_multiple=1,
            test_order=self.test_order, max_test=probe_n, subsample_seed=probe_seed)
        r_train = self.test_residuals(theta, chunk=chunk, matmul_precision=matmul_precision)
        r_probe = self._residual_densities(probe_fixed.quad, probe_fixed.static.n_test, theta,
                                           chunk, matmul_precision)
        train_rms = float(np.sqrt(np.mean(r_train ** 2)))
        probe_rms = float(np.sqrt(np.mean(r_probe ** 2)))
        ratio = probe_rms / max(train_rms, 1e-300)
        out = {
            "train_rms": train_rms,
            "probe_rms": probe_rms,
            "ratio": ratio,
            "flagged": bool(ratio > threshold),
            "threshold": float(threshold),
            "train_mesh": f"disc={disc} tdisc={self.t_disc_num} n_test={self.static.n_test}",
            "probe_mesh": f"disc={probe_disc} tdisc={probe_t} "
                          f"n_test={probe_fixed.static.n_test}",
            "probe_n": probe_n,
        }
        if verbose:
            state = ("FLAGGED: probe residual >> train residual — the train test space "
                     "likely underdetermines the solution (aliasing); densify "
                     "disc/t_disc/integ or refine_tests before trusting the fit"
                     if out["flagged"] else "ok")
            print(f"[varnet/adequacy] train_rms {train_rms:.3e}  probe_rms {probe_rms:.3e}"
                  f"  ratio {ratio:.1f}  {state}", flush=True)
        return out

    def refine_tests(self, frac: float = 0.1, threshold: Optional[float] = None,
                     factor: int = 2, theta: Any = None, verbose: bool = True) -> dict:
        """Residual-driven adaptive refinement of the hat test space (reference
        ``VarNet.refine_tests``, ``fem/adaptive.py``): flag the test functions
        whose |residual density| is in the top ``frac`` quantile (or >=
        ``threshold``) and add the factor-times-finer hats inside their
        supports.  The refined quad carries per-node tables, so later
        ``train`` calls of a plain net run the precoeff residual (K4)."""
        r = self.test_residuals(theta)
        a = np.abs(r)
        if threshold is None:
            if not 0.0 < float(frac) <= 1.0:
                raise ValueError("frac must be in (0, 1]")
            threshold = float(np.quantile(a, 1.0 - float(frac)))
        flags = a >= threshold
        self.fixed, info = refine_fixed(self.pde, self.fixed, flags, self.integ_p_num,
                                        factor=factor)
        self.static = self.fixed.static
        info["threshold"] = float(threshold)
        if verbose:
            print(f"[varnet/adapt] flagged {info['n_flagged']} (|r| >= {threshold:.3e}), "
                  f"added {info['n_added']} finer hats -> n_test {info['n_test']}")
        return info

    def train_adaptive(self, epoch_num: int, rounds: int = 2, frac: float = 0.2,
                       factor: int = 2, weight: Optional[Sequence[float]] = None,
                       folderpath: Optional[str] = None, verbose: bool = True,
                       **train_kwargs) -> TrainResult:
        """Alternating train / ``refine_tests`` schedule (reference
        ``VarNet.train_adaptive``): ``epoch_num`` split over ``rounds + 1``
        stages with a refinement between consecutive stages; the merged
        history carries each refinement's info on the stage's last loss record.
        With ``folderpath`` each stage checkpoints into its own ``stage<K>/``
        subfolder: refinement changes the problem's shape, so the stages are
        separate checkpoint lineages."""
        stages = int(rounds) + 1
        per = max(1, int(epoch_num) // stages)
        merged = TrainResult()
        offset = 0
        for s in range(stages):
            fp = None if folderpath is None else os.path.join(folderpath, f"stage{s}")
            res = self.train(epoch_num=per, weight=weight, folderpath=fp, verbose=verbose,
                             **train_kwargs)
            merged.epochs.extend(e + offset for e in res.epochs)
            merged.losses.extend(res.losses)
            merged.errors.extend(res.errors)
            last_wall = merged.wall_times[-1] if merged.wall_times else 0.0
            merged.wall_times.extend(w + last_wall for w in res.wall_times)
            merged.total_steps += res.total_steps
            merged.quad_evals_per_sec = res.quad_evals_per_sec
            merged.steps_per_sec = res.steps_per_sec
            offset += per
            if s < stages - 1:
                info = self.refine_tests(frac=frac, factor=factor, verbose=verbose)
                if merged.losses:
                    merged.losses[-1] = dict(merged.losses[-1], refined=info["n_added"],
                                             n_test=info["n_test"])
        self.train_result = merged
        return merged
