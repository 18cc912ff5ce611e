"""High-level orchestrator: the ``VarNet`` class (flagship subset).

PyTorch counterpart of ``varnet_tpu/api.py``: same constructor and
``train`` / ``refine_lm`` / ``evaluate`` / ``compute_error`` call shapes, one
explicit device.  Fixed data is assembled once on the host, moved to the device
and kept there; the fused residual's data layout is prepared once per ``train``
call.  On a CUDA device the Adam step's interior residual runs through the
hand-written kernels of ``ops/fused_residual.py`` (K1/K2, or K2-FF for a net
behind a Fourier-feature embedding), and the value + jacobian evaluation of the
LM refinement and of the Adam general path through those of
``ops/value_and_jac.py`` (K5 forward and backward, K6 JVP; K7/K8 with the
embedding); on the CPU through their plain versions.
"""

from __future__ import annotations

import functools
import json
import math
import os
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .fem.assembly import FixedData, build_fixed_data, pad_points, pad_quad
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
from .ops.fused_residual import prepare_residual_data
from .problems.adpde import ADPDE
from .train.gauss_newton import LMState, make_lm_step, make_residual_fn
from .train.loss import make_loss_fn
from .train.optim import OptimizerConfig, make_optimizer
from .train.trainer import TrainResult, make_train_step, split_batches
from .utils.helpers import matmul_precision_scope, rel_l2_error


class VarNet:
    """Variational PDE solver: neural trial function + weak-form loss.

      pde:          ADPDE problem definition
      layer_width:  hidden-layer widths of the MLP trial function
      disc_num:     spatial elements per dimension (int or per-dim seq)
      b_disc_num:   boundary points per segment edge
      t_disc_num:   time elements (time-dependent problems only)
      integ_p_num:  Gauss-Legendre points per dim per element
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
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VarNet(device='cuda'): no CUDA device is available")
        if getattr(pde, "nl_adv", None) is not None:
            raise NotImplementedError("nonlinear advection is not ported to "
                                      "varnet_tpu_torch yet")
        self.pde = pde
        self.layer_width = tuple(int(w) for w in layer_width)
        self.disc_num = disc_num
        self.b_disc_num = int(b_disc_num)
        self.t_disc_num = None if t_disc_num is None else int(t_disc_num)
        self.integ_p_num = int(integ_p_num)
        self.activation = activation
        self.seed = int(seed)
        self.optimizer_cfg = optimizer or OptimizerConfig()
        self.use_fused_residual = bool(use_fused_residual)
        self.use_pallas = (self.device.type == "cuda" if use_pallas == "auto"
                           else bool(use_pallas))
        self.has_react = not (
            pde.react is None
            or (np.isscalar(pde.react) and float(pde.react) == 0.0)
        )
        self.fixed: FixedData = build_fixed_data(
            pde, disc_num, b_disc_num=self.b_disc_num, t_disc_num=self.t_disc_num,
            integ_p_num=self.integ_p_num, pad_multiple=1,
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
        verbose: bool = True,
        error_disc: int = 64,
        error_times: int = 5,
        target_error: Optional[float] = None,
    ) -> TrainResult:
        """Run the training loop (reference ``VarNet.train``).

        weight:      (w_int, w_bc[, w_ic]) loss weights
        batch_num:   interior mini-batches per epoch
        save_freq:   report period (epochs)
        folderpath:  directory for the JSONL training log and train_result.json
        target_error: optional early-stop threshold on rel-L2 error

        Matmuls outside the kernel run with TF32 off (exact f32), as the
        kernel does on the CUDA cores.
        """
        with matmul_precision_scope():
            return self._train_impl(int(epoch_num), weight, int(batch_num), save_freq,
                                    folderpath, verbose, error_disc, error_times,
                                    target_error)

    def _train_impl(self, epoch_num, weight, batch_num, save_freq, folderpath, verbose,
                    error_disc, error_times, target_error):
        td = self.static.time_dependent
        if weight is None:
            weight = (1.0, 1.0) + ((1.0,) if td else ())
        w_full = [float(w) for w in weight] + [0.0] * (3 - len(weight))

        quad_h = pad_quad(self.fixed.quad, batch_num)
        quad_d = self._to_device(quad_h)
        bc_d = self._to_device(pad_points(self.fixed.bc, 1))
        ic_d = None if self.fixed.ic is None else self._to_device(pad_points(self.fixed.ic, 1))

        loss_fn = make_loss_fn(self.static, activation=self.activation,
                               has_react=self.has_react, fused=self.use_fused_residual,
                               device=self.device, input_scaling=self.input_scaling,
                               value_and_jac=self._value_and_jac(self.use_pallas),
                               apply_fn=self._apply_fn())
        quads = quad_d if batch_num == 1 else split_batches(quad_d, batch_num)

        def prepare(q):
            # the fused kernel's data layout, ONCE per train call (not per step)
            if not self.use_fused_residual:
                return None
            return prepare_residual_data(q, self.scale, self.shift, time_dependent=td,
                                         has_react=self.has_react, device=self.device,
                                         fourier_bt=self.fourier_bt)

        prepared = prepare(quads) if batch_num == 1 else [prepare(q) for q in quads]

        theta = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
                 for layer in self._params(None)]
        optimizer = make_optimizer(self.optimizer_cfg,
                                   [layer[k] for layer in theta for k in ("w", "b")])
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
        for epoch in range(1, epoch_num + 1):
            aux = step_fn(theta, quads, bc_d, ic_d, w_full, prepared)
            if t_start is None:
                self._sync()
                t_start = time.perf_counter()
            else:
                timed_epochs += 1
            last = epoch == epoch_num
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
        backward (K8 and K7's backward with a Fourier-feature embedding).
        Checkpointing and fault recovery (``folderpath``, ``resume``,
        ``max_retries``) are not ported yet (ROADMAP Queue 1 item 9).
        """
        if folderpath is not None or resume or int(max_retries) > 0:
            raise NotImplementedError(
                "refine_lm checkpoints and fault recovery (folderpath, resume, "
                "max_retries) are not ported to varnet_tpu_torch yet (ROADMAP item 9)")
        with matmul_precision_scope(matmul_precision):
            return self._refine_lm_impl(
                int(steps), weight, int(cg_iters), int(save_freq), verbose, error_disc,
                error_times, float(lam0), target_error, int(k_chunks), int(cg_segment),
                int(precond), precond_mode)

    def _refine_lm_impl(self, steps, weight, cg_iters, save_freq, verbose, error_disc,
                        error_times, lam0, target_error, k_chunks, cg_segment, precond,
                        precond_mode) -> TrainResult:
        td = self.static.time_dependent
        if weight is None:
            weight = (1.0, 1.0) + ((1.0,) if td else ())
        w_full = [float(w) for w in weight] + [0.0] * (4 - len(weight))
        if not td:
            w_full = [w_full[0], w_full[1], 0.0, w_full[2]]

        quad_d = self._to_device(pad_quad(self.fixed.quad, k_chunks))
        bc_d = self._to_device(pad_points(self.fixed.bc, 1))
        ic_d = None if self.fixed.ic is None else self._to_device(pad_points(self.fixed.ic, 1))
        res_fn = make_residual_fn(
            self.static, activation=self.activation, k_chunks=k_chunks,
            value_and_jac=self._value_and_jac(self.use_pallas),
            has_react=self.has_react, device=self.device,
            input_scaling=self.input_scaling, apply_fn=self._apply_fn())
        theta0 = self._params(None)
        flat0, unravel = ravel_params(theta0)

        def closure(flat):
            return res_fn(unravel(flat), quad_d, bc_d, ic_d, w_full)

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
                result.epochs.append(it)
                result.losses.append({"loss": loss, "lam": lam})
                result.errors.append(err if err is not None else float("nan"))
                result.wall_times.append(time.perf_counter() - t_start)
                if verbose:
                    err_s = f"{err:.3e}" if err is not None else "n/a"
                    print(f"[varnet/lm] it {it:5d}  loss {loss:.4e}  lam {lam:.1e}"
                          f"  relL2 {err_s}  ({result.wall_times[-1]:.1f}s)", flush=True)
                if target_error is not None and err is not None and err < target_error:
                    if verbose:
                        print(f"[varnet/lm] target {target_error:.1e} reached")
                    break
        self.theta = [{k: v.detach().clone() for k, v in layer.items()}
                      for layer in unravel(state.flat)]
        result.total_steps = steps
        self.train_result = result
        return result

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
        """u_theta at points (reference ``VarNet.evaluate``), in exact f32.

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
        return np.concatenate(outs) if outs else np.zeros(0)

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
