"""High-level orchestrator: the ``VarNet`` class.

PyTorch counterpart of ``varnet_tpu/api.py``: same constructor and
``train`` / ``train_ensemble`` / ``refine_lm`` / ``refine_lbfgs`` / ``evaluate`` /
``evaluate_ensemble`` / ``evaluate_grad`` / ``compute_error`` / ``refine_tests`` /
``train_adaptive`` / ``sim_res`` call shapes, one explicit device.  Fixed
data is assembled once on the host, moved to the device and kept there; the
fused residual's data layout is prepared once per ``train`` call.  On a CUDA
device the Adam step's interior residual runs through the hand-written kernels
of ``ops/fused_residual.py`` (K1/K2; K2-FF for a net behind a Fourier-feature
embedding; K4, the precoeff residual, for exact BC/IC and per-node test
tables; K3, the jacobian-panel residual, for nonlinear advection: viscous
Burgers, ``ADPDE(nl_adv=b)``), and the value + jacobian evaluation of the LM and
L-BFGS refinements, of the Adam general path and of ``evaluate_grad`` through those
of ``ops/value_and_jac.py`` (K5 forward and backward, K6 JVP; K7/K8 with the
embedding); on the CPU through their plain versions.  An ensemble's members run
one after another through the same kernels.  ``train`` and ``refine_lm`` checkpoint into a case folder
(``train/checkpoint.py``), resume from it with global step numbering, and retry
transient device faults (``train/fault.py``), as the JAX package's do.

Data parallel (``parallel/mesh.py``, ``n_devices``): under an initialized
``torch.distributed`` group each rank holds its contiguous block of the
test-function axis (and of the BC / IC / observation / flux rows), runs the
same kernels on it, and the Adam, ensemble, LM and L-BFGS steps sum their
per-rank parts with packed all-reduces; evaluation runs whole on every rank,
and rank 0 alone writes the case folder.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import shutil
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .fem.adaptive import refine_fixed
from .fem.assembly import (
    FixedData,
    QuadData,
    _pad_axis0,
    build_fixed_data,
    pad_flux,
    pad_points,
    pad_quad,
)
from .fem.hardbc import HardBC, HardQuad, hard_transform, tables_to
from .models.mlp import (
    ff_apply,
    ff_value_and_jac,
    init_mlp,
    init_siren,
    leaf_segments,
    make_fourier_features,
    make_input_scaling,
    mlp_apply,
    mlp_value_and_jac,
    net_of,
    params_to_numpy,
    ravel_params,
    tree_leaves,
    tree_map,
)
from .ops import value_and_jac as vj
from .ops.fused_residual import prepare_residual_coeffs, prepare_residual_data
from .ops.residual import hook_fields, support_volume, weak_residual
from .parallel.mesh import (
    all_reduce_sum,
    barrier,
    default_device,
    make_mesh,
    replicate,
    shard_flux,
    shard_hard,
    shard_points,
    shard_quad,
    shard_rows,
)
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
from .train.loss import make_loss_fn, obs_weight_slots
from .train.optim import OptimizerConfig, make_optimizer
from .train.lbfgs import LBFGS, lbfgs_iteration
from .train.trainer import (
    EnsembleResult,
    TrainResult,
    make_train_step,
    pad_axis1,
    pad_batched_axis1,
    reshape_batches,
)
from .utils.helpers import matmul_precision_scope, rel_l2_error
from .utils import spans

# quadrature points per host call of the exact-BC table build: chunks small
# enough for the caches, built by a few threads (NumPy releases the GIL in its
# array operations); the tables are per point, so chunking changes no value
HARD_TABLE_CHUNK = 1 << 16
HARD_TABLE_THREADS = 8


def _finite_loss(loss_fn, now):
    """``loss_fn`` raising ``FloatingPointError`` on a non-finite total, before
    its backward runs (``train(debug_nans=True)``; ``now['epoch']`` names the
    epoch)."""
    def checked(*args, **kw):
        total, aux = loss_fn(*args, **kw)
        if not bool(torch.isfinite(total)):
            raise FloatingPointError(f"debug_nans: non-finite loss {float(total.detach())} "
                                     f"at epoch {now['epoch']}")
        return total, aux

    return checked


@contextlib.contextmanager
def _nan_checks(now):
    """Autograd's anomaly mode for the scope (the previous mode restored after),
    its report of a NaN in a backward raised as ``FloatingPointError`` naming
    ``now['epoch']``; every other error, a kernel's own among them, passes
    unchanged."""
    with torch.autograd.set_detect_anomaly(True):
        try:
            yield
        except RuntimeError as err:
            if "returned nan values" not in str(err):
                raise
            raise FloatingPointError(f"debug_nans: NaN in the backward at epoch "
                                     f"{now['epoch']}: {err}") from err


class _TraceWindow:
    """A ``torch.profiler`` trace of ``steps`` epochs, from ``start(epoch)`` (after
    the warm-up step) to ``stop``, written as a Chrome trace into ``folder``:
    the host's ops, on a CUDA device every kernel by name, and the program's
    spans (``utils/spans.py``, recorded over the same epochs) as complete
    events on a ``varnet`` track."""

    def __init__(self, folder, steps, device):
        self.folder, self.steps, self.device = folder, int(steps), device
        self.prof, self.first, self.end = None, 0, 0
        self.scope = self.rec = None

    def start(self, epoch):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.scope = contextlib.ExitStack()
        self.rec = self.scope.enter_context(spans.record())
        self.prof.start()
        self.first, self.end = epoch + 1, epoch + self.steps

    def after(self, epoch):
        if self.prof is not None and epoch >= self.end:
            self.stop()

    def stop(self):
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.scope.close()
        os.makedirs(self.folder, exist_ok=True)
        path = os.path.join(self.folder, f"trace_from_epoch_{self.first}.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"].extend(
            spans.chrome_events(self.rec.spans, trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f)
        self.prof = self.scope = self.rec = None


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
      activation:   'tanh' | 'sigmoid' | 'sin'.  sin (SIREN) nets are drawn by
                    ``init_siren`` (layer 0 at the embedding's 2F inputs with
                    Fourier features); on CUDA every kernel has a sin
                    instantiation, so they take the routes tanh takes
      omega0:       SIREN's layer-0 frequency (activation 'sin' only)
      seed:         seed of the ``torch.Generator`` that draws the initial net
      device:       torch device of the fixed data, parameters and training;
                    'cuda' raises when no GPU is present (no fallback); under
                    a process group 'cuda' is this rank's ``cuda:LOCAL_RANK``
      n_devices:    data-parallel ranks (``parallel/mesh.py``): None takes the
                    world size of the initialized default process group (1
                    without one); another value must equal it.  With a group
                    every step sums its ranks' parts by all-reduce (also at
                    world size 1); without one no collective runs
      dtype:        parameter and compute dtype (torch.float32 default).  The
                    kernels are f32-only: another dtype takes the general
                    path through the plain chain, and an explicit
                    ``use_pallas=True`` / ``use_fused_residual=True`` with it
                    raises
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
                    general value + jacobian path; "auto" = at float32
      use_pallas:   the value + jacobian evaluation of ``refine_lm`` and of
                    the Adam general path through ``ops/value_and_jac.py``
                    (kernels K5/K6 or K7/K8 on CUDA, their plain versions on
                    CPU); "auto" = on a CUDA device at float32.  False takes
                    ``mlp_value_and_jac`` (``ff_value_and_jac``) under
                    autograd.  (The JAX package's name for its Pallas kernels.)

      Inverse problems (theta becomes ``{'net': [...], 'src': ..., 'kap': ...,
      'vel': ...}``, each hook's leaf trained with the net; hooks take torch
      tensors ``f(leaf, x [P, d], t [P] or None)``):
      source_fn:    trainable source ``source_fn(phi, x, t) -> [P]`` in place of
                    the problem's (``models/source.py``); theta['src'] starts at
                    ``source_init``.  The fused residual integrates a zeroed
                    source and the loss adds the trainable one's term
      diff_fn:      trainable diffusivity ``diff_fn(psi, x, t) -> [P]``;
                    theta['kap'] starts at ``diff_init``.  Not with Neumann /
                    Robin data, whose normals are scaled by the fixed kappa
      vel_fn:       trainable velocity ``vel_fn(phi, x, t) -> [P, d]``;
                    theta['vel'] starts at ``vel_init``.  A trainable kappa or
                    velocity takes the general value + jacobian path (K5 on CUDA)
      obs_data:     a PointData of observations: the loss gains
                    w_obs * mean |u - u_obs|^2 (the transformed u with
                    ``hard_bc``), w_obs the 4th weight (a steady problem's 3rd)

    Neumann / Robin boundary data (``NeumannBC`` / ``RobinBC``) add the flux
    penalty w_bc * mean |alpha u + kappa du/dn - g|^2 over the flux points, on
    the transformed u with ``hard_bc``, through the plain value + jacobian chain
    (the batch is boundary-sized).
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
        use_fused_residual="auto",
        use_pallas="auto",
        input_scaling: bool = True,
        fourier_features: Optional[int] = None,
        fourier_scale=0.5,
        fourier_b=None,
        hard_bc: bool = False,
        fused_precoeff: bool = False,
        fused_directional: bool = True,
        omega0: float = 6.0,
        source_fn=None,
        source_init: Any = None,
        diff_fn=None,
        diff_init: Any = None,
        vel_fn=None,
        vel_init: Any = None,
        obs_data=None,
        n_devices: Optional[int] = None,
        dtype=torch.float32,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VarNet(device='cuda'): no CUDA device is available")
        if self.device.type == "cuda" and self.device.index is None and (
                torch.distributed.is_initialized()):
            self.device = default_device()
        self.mesh = make_mesh(n_devices, device=self.device)
        self.n_shards = self.mesh.n_shards
        self.dtype = dtype
        f32 = dtype == torch.float32
        for name, value in (("use_pallas", use_pallas), ("use_fused_residual", use_fused_residual)):
            if value is True and not f32:
                raise ValueError(f"{name}=True needs dtype=torch.float32 (the kernels are "
                                 f"f32-only), got dtype={dtype}")
        if fused_precoeff and not fused_directional:
            raise ValueError("fused_precoeff=True requires fused_directional=True")
        for fn, init, name in ((source_fn, source_init, "source"), (diff_fn, diff_init, "diff"),
                               (vel_fn, vel_init, "vel")):
            if fn is not None and init is None:
                raise ValueError(f"{name}_fn requires {name}_init")
        if diff_fn is not None and any(isinstance(g, (NeumannBC, RobinBC)) for g in pde.bcs):
            raise ValueError("diff_fn (trainable kappa) is incompatible with Neumann/Robin BCs: "
                             "FluxData bakes kappa-scaled normals at assembly time")
        self.source_fn, self.diff_fn, self.vel_fn = source_fn, diff_fn, vel_fn
        self.obs_data = obs_data
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
        self.use_fused_residual = (f32 if use_fused_residual == "auto"
                                   else bool(use_fused_residual))
        self.fused_precoeff = bool(fused_precoeff)
        self.use_pallas = (self.device.type == "cuda" and f32 if use_pallas == "auto"
                           else bool(use_pallas))
        self.has_react = not (
            pde.react is None
            or (np.isscalar(pde.react) and float(pde.react) == 0.0)
        )
        with spans.span("varnet.build"):
            # exact BC/IC: the host-side transform builder; its tables are built at
            # the (padded) quad coords when a run needs them (_hard_tables)
            self.hard = None
            if hard_bc:
                self.hard = HardBC(pde)
            self._hard_cache = None
            self.hard_table_seconds = 0.0
            with spans.span("build.assembly"):
                self.fixed: FixedData = build_fixed_data(
                    pde, disc_num, b_disc_num=self.b_disc_num, t_disc_num=self.t_disc_num,
                    integ_p_num=self.integ_p_num, pad_multiple=1, test_order=self.test_order,
                )
            self.static = self.fixed.static
            with spans.span("build.to_device"):
                gen = torch.Generator().manual_seed(self.seed)
                # the embedding is drawn before the net, as the JAX package splits its key
                self.fourier_b = None
                n_in = self.static.n_inputs
                if fourier_b is not None:
                    b_mat = torch.as_tensor(np.asarray(fourier_b), dtype=dtype)
                    if b_mat.ndim != 2 or b_mat.shape[0] != n_in or (
                            fourier_features is not None
                            and b_mat.shape[1] != int(fourier_features)):
                        raise ValueError(f"fourier_b must be [{n_in}, F], got {tuple(b_mat.shape)}")
                    self.fourier_b = b_mat.to(self.device)
                elif fourier_features is not None:
                    self.fourier_b = make_fourier_features(gen, n_in, int(fourier_features),
                                                           fourier_scale).to(self.device, dtype)
                self._net_in = n_in if self.fourier_b is None else 2 * self.fourier_b.shape[1]
                self.omega0 = float(omega0)
                self._hook_inits = {"src": (source_fn, source_init), "kap": (diff_fn, diff_init),
                                    "vel": (vel_fn, vel_init)}
                self.theta = replicate(self._draw_theta(gen), self.mesh)
                self.input_scaling = bool(input_scaling)
                self.scale = self.shift = None
                if self.input_scaling:
                    self.scale, self.shift = make_input_scaling(
                        self.static.input_lo, self.static.input_hi, dtype=dtype, device=self.device)
        self.opt_state = None   # the optimizer state of the last load_model
        self.train_result: Optional[TrainResult] = None
        self._ensemble_thetas = None   # the stacked members of the last train_ensemble

    def _draw_theta(self, gen: torch.Generator):
        """A fresh theta: the net drawn from ``gen`` (``init_siren`` for sin, else
        ``init_mlp``, at the embedding's width with Fourier features) and the
        hooks' initial leaves."""
        if self.activation == "sin":
            net = init_siren(gen, self._net_in, self.layer_width, omega0=self.omega0,
                             dtype=self.dtype, device=self.device)
        else:
            net = init_mlp(gen, self._net_in, self.layer_width, dtype=self.dtype,
                           device=self.device)
        if all(fn is None for fn, _ in self._hook_inits.values()):
            return net
        theta = {"net": net}
        for leaf, (fn, init) in self._hook_inits.items():
            if fn is not None:
                theta[leaf] = self._as_tensors(init)
        return theta

    def _init_member(self, i: int):
        """Member ``i``'s initial theta (``train_ensemble``), drawn as the
        constructor draws one, from a generator of its own seeded from
        (seed, i); the Fourier embedding B is the instance's, shared."""
        seed = int(np.random.SeedSequence([self.seed, int(i)]).generate_state(1)[0])
        return self._draw_theta(torch.Generator().manual_seed(seed))

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
        precoeff fold or per-node tables; per-node tables need the fold; a
        trainable diffusivity or velocity multiplies what the kernels bake into
        their data, so it takes the general path."""
        if not self.use_fused_residual or self.diff_fn is not None or self.vel_fn is not None:
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
        wall time; the build is the span ``prepare.hard_tables``, opened only
        when the cache misses, so its count is the number of builds."""
        if self.hard is None:
            return None
        if self._hard_cache is None or self._hard_cache[0] is not self.fixed:
            with spans.timed("prepare.hard_tables") as build:
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
            self.hard_table_seconds = build.seconds
        k = quad_h.coords.shape[0]
        return HardQuad(*(None if a is None else _pad_axis0(a, k) for a in self._hard_cache[1]))

    def _rows(self):
        """The full-batch rows besides BC/IC, as keyword arguments of the loss and
        the LM residual, on the device: ``obs`` (the observations), ``neu`` (the
        Neumann/Robin flux points) and, with exact BC, their transform tables
        ``hard_obs`` (HardPts) and ``hard_neu`` (HardQuad, built host-side in
        f64 at the flux coords: their rows see the transformed u).  Each padded
        to the rank count, this rank's block."""
        n = self.n_shards
        obs_h = None if self.obs_data is None else pad_points(self.obs_data, n)
        neu_h = None if self.fixed.neu is None else pad_flux(self.fixed.neu, n)
        rows = {"obs": None if obs_h is None else shard_points(obs_h, self.mesh, self.dtype),
                "neu": None if neu_h is None else shard_flux(neu_h, self.mesh, self.dtype)}
        if self.hard is not None:
            _, rows["hard_obs"], rows["hard_neu"] = shard_hard(
                (None, None if obs_h is None else self.hard.points(obs_h.coords),
                 None if neu_h is None else self.hard.tables(neu_h.coords)),
                self.mesh, self.dtype)
        return rows

    def _points(self):
        """The BC and IC penalty rows (IC None for a steady problem), padded to
        the rank count, this rank's block on the device."""
        n = self.n_shards
        bc = shard_points(pad_points(self.fixed.bc, n), self.mesh, self.dtype)
        ic = (None if self.fixed.ic is None
              else shard_points(pad_points(self.fixed.ic, n), self.mesh, self.dtype))
        return bc, ic

    def _hook_kwargs(self):
        """The trainable-field and observation arguments of ``make_loss_fn`` /
        ``make_residual_fn``; the flux rows take the plain value + jacobian
        chain (the batch is boundary-sized)."""
        has_obs = self.obs_data is not None
        return dict(source_fn=self.source_fn, diff_fn=self.diff_fn, vel_fn=self.vel_fn,
                    has_obs=has_obs,
                    n_obs_real=int(np.sum(self.obs_data.mask)) if has_obs else 0,
                    flux_value_and_jac=self._value_and_jac(False))

    # ------------------------------------------------------------------ #
    # training

    @property
    def _np_dtype(self):
        """The NumPy dtype of the instance's dtype."""
        return torch.empty(0, dtype=self.dtype).numpy().dtype

    def _to_device(self, arrays):
        """A QuadData / PointData / FluxData of host arrays, whole, as tensors of
        the instance's dtype on the device."""
        return type(arrays)(*(torch.from_numpy(np.array(a, dtype=self._np_dtype)).to(self.device)
                              for a in arrays))

    def _tables(self, hq):
        """Exact-BC tables of host arrays (None passes) as tensors of the
        instance's dtype on the device."""
        return None if hq is None else tables_to(hq, self.device, self.dtype)

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
        value_and_jac: Optional[Callable] = None,
        target_error: Optional[float] = None,
        normalize_residual: bool = True,
        profile_dir: Optional[str] = None,
        profile_steps: int = 10,
        debug_nans: bool = False,
        matmul_precision: Optional[str] = None,
        max_retries: int = 0,
        retry_backoff: float = 30.0,
    ) -> TrainResult:
        """Run the training loop (reference ``VarNet.train``).

        weight:      (w_int, w_bc[, w_ic][, w_obs]) loss weights (a steady
                     problem's third is w_obs; the flux rows share w_bc)
        batch_num:   interior mini-batches per epoch (observation and flux
                     rows stay full-batch, as BC/IC)
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
        value_and_jac: an override of the general path's value + jacobian
                     ``f(net, x, activation, scale, shift) -> (u, du/dx)``;
                     given, the step takes the general path (no fused residual)
        target_error: optional early-stop threshold on rel-L2 error
        normalize_residual: the interior term as the mean of the support-volume
                     normalized r_k^2 (default); False: the reference's raw
                     sum of r_k^2 (``train/loss.py``)
        profile_dir: a ``torch.profiler`` trace of ``profile_steps`` epochs after
                     the first (warm-up) one, written as a Chrome trace
                     (``trace_from_epoch_<first>.json``) into this directory;
                     on a CUDA device it holds the kernels by name.  The
                     program's spans over those epochs (``train.epoch``,
                     ``train.drain``, ``train.report``: ``utils/spans.py``)
                     are on its ``varnet`` track, on the clock of the
                     kernels beside them
        debug_nans:  for this call, autograd's anomaly mode (restored after)
                     and a finiteness check of every step's loss: a non-finite
                     loss, or a NaN that anomaly mode finds in a backward,
                     raises ``FloatingPointError`` naming the epoch (the type
                     JAX's ``jax_debug_nans`` raises).  The check syncs the
                     device every step
        matmul_precision: None / 'highest' / 'float32': every matmul in full
                     f32 (TF32 off), the port's only precision; reduced values
                     raise
        max_retries: on a transient device fault (``train/fault.py``),
                     re-enter the loop up to this many times, resuming from
                     the newest checkpoint when ``folderpath`` is set
        retry_backoff: seconds to sleep before each retry
        """
        if resume and folderpath is None:
            raise ValueError("resume=True requires folderpath (nothing to resume from)")
        self._check_retries(max_retries)
        verbose = verbose and self.mesh.is_main

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
            now = {"epoch": 0}   # the epoch running, for debug_nans' messages
            trace = (None if profile_dir is None
                     else _TraceWindow(profile_dir, profile_steps, self.device))
            try:
                with matmul_precision_scope(matmul_precision or "highest"), (
                        _nan_checks(now) if debug_nans else contextlib.nullcontext()):
                    return self._train_impl(st["epochs"], weight, int(batch_num), save_freq,
                                            folderpath, st["resume"], verbose, error_disc,
                                            error_times, target_error, value_and_jac,
                                            normalize_residual, debug_nans, now, trace)
            finally:
                if trace is not None:
                    trace.stop()

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

        with spans.span("train.call"):
            return self._retry_transient(attempt_fn, on_fault, max_retries, retry_backoff,
                                         verbose, label="", include_oom=False)

    def _check_retries(self, max_retries):
        """Retries are one process's: under several ranks one rank retrying alone
        would wait forever in the others' collectives.  A fault there raises on
        its rank, and torchrun (``--max-restarts``) restarts every rank, which
        continue from the case folder with ``resume=True``."""
        if int(max_retries) and self.mesh.distributed:
            raise ValueError("max_retries > 0 is not supported under a process group: "
                             "relaunch every rank (torchrun --max-restarts) with "
                             "resume=True and a folderpath instead")

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

    def _adam_data(self, kind, batch_num, normalize_residual=True, value_and_jac=None):
        """The device data and loss of an Adam run on the interior residual
        ``kind`` (``_fused_kind``, or None for the general path): ``(loss_fn,
        args)``, where ``loss_fn(theta, *args, **rows)`` is one step's loss:
        ``args`` = (quad, bc, ic, prepared, hard), each per mini-batch (a list)
        for ``batch_num > 1``; the weights go between ic and prepared.
        ``value_and_jac`` overrides the general path's value + jacobian
        (default: the kernels' on ``use_pallas``, else the plain chain).

        Padding is the JAX package's: to ``batch_num`` (or the rank count), then,
        for mini-batches, each batch's test axis to the rank count, so batch
        membership does not depend on the number of ranks; the data are this
        rank's block, and the kernels' layouts are prepared from it."""
        td = self.static.time_dependent
        n = self.n_shards
        quad_h = pad_quad(self.fixed.quad, batch_num if batch_num > 1 else n)
        if kind is not None and self.source_fn is not None:
            # the trainable source enters the weak form linearly: the kernel
            # integrates a zeroed source and the loss adds the trainable one's term
            quad_h = quad_h._replace(src=np.zeros_like(quad_h.src))
        # one host f64 table build serves the K4 fold or the general path's tables
        hard_h = self._hard_tables(quad_h)
        batched = batch_num > 1
        if batched:
            quad_h = pad_batched_axis1(reshape_batches(quad_h, batch_num), n)
            hard_h = None if hard_h is None else HardQuad(*(
                None if a is None
                else pad_axis1(a.reshape((batch_num, -1) + a.shape[1:]), quad_h.coords.shape[1])
                for a in hard_h))
        quad_d = shard_quad(quad_h, self.mesh, self.dtype, batched=batched)
        hard_h = None if hard_h is None else HardQuad(*(
            None if a is None else shard_rows(a, self.mesh, 1 if batched else 0) for a in hard_h))
        bc_d, ic_d = self._points()

        loss_fn = make_loss_fn(self.static, activation=self.activation,
                               has_react=self.has_react, fused=kind is not None,
                               device=self.device, input_scaling=self.input_scaling,
                               value_and_jac=value_and_jac or self._value_and_jac(self.use_pallas),
                               apply_fn=self._apply_fn(), hard_mode=self.hard is not None,
                               nl_vec=self.nl_vec, normalize_residual=normalize_residual,
                               dtype=self.dtype, **self._hook_kwargs())
        if not batched:
            quads, hards = quad_d, hard_h
        else:
            per_node = quad_d.tables_per_node
            quads = [QuadData(*(a[b] if f not in ("N", "dN", "w") or per_node else a
                                for f, a in zip(QuadData._fields, quad_d)))
                     for b in range(batch_num)]
            hards = [None if hard_h is None
                     else HardQuad(*(None if a is None else a[b] for a in hard_h))
                     for b in range(batch_num)]

        def prepare(q, hq):
            # the fused kernel's data layout, ONCE per run (not per step); K4's
            # fold of the coefficients (and of the exact-BC tables) is a span
            if kind == "precoeff":
                with spans.span("prepare.coeff_fold"):
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
            return None if kind is not None else self._tables(hq)

        if not batched:
            prepared, hard_d = prepare(quads, hards), hard_tensors(hards)
        else:
            prepared = [prepare(q, h) for q, h in zip(quads, hards)]
            hard_d = [hard_tensors(h) for h in hards]
        return loss_fn, (quads, bc_d, ic_d, prepared, hard_d)

    def _train_impl(self, epoch_num, weight, batch_num, save_freq, folderpath, resume,
                    verbose, error_disc, error_times, target_error, value_and_jac,
                    normalize_residual, debug_nans, now, trace):
        with spans.timed("train.prepare") as prepare:
            w_full = self._weights(weight)
            # an explicit value + jacobian takes the general path, as in the JAX package
            kind = self._fused_kind if value_and_jac is None else None
            loss_fn, (quads, bc_d, ic_d, prepared, hard_d) = self._adam_data(
                kind, batch_num, normalize_residual, value_and_jac)
            rows = self._rows()
            if debug_nans:
                loss_fn = _finite_loss(loss_fn, now)

            theta = tree_map(lambda v: v.clone().requires_grad_(True),
                             replicate(self._params(None), self.mesh))
            optimizer = make_optimizer(self.optimizer_cfg, tree_leaves(theta))
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
                        for leaf, stored in zip(tree_leaves(theta), tree_leaves(state["theta"])):
                            leaf.copy_(stored)
                    optimizer.load_state_dict(state["opt_state"])
                    start_epoch = step
                    if verbose:
                        print(f"[varnet] resumed from epoch {step} in {folderpath}")
            step_fn = make_train_step(loss_fn, optimizer, batch_num=batch_num, mesh=self.mesh)

            result = TrainResult()
            log_path = None
            if folderpath is not None:
                os.makedirs(folderpath, exist_ok=True)
                log_path = os.path.join(folderpath, "train_log.jsonl")
            main = self.mesh.is_main
            n_real_quad = self.static.n_test * self.static.n_quad_per_test
        t_start = None          # set after the first (warm-up) step
        timed_epochs = 0
        report_seconds = 0.0    # the reports' host + eval time, left out of the rate
        for epoch in range(start_epoch + 1, start_epoch + epoch_num + 1):
            now["epoch"] = epoch
            with spans.span("train.epoch"):
                aux = step_fn(theta, quads, bc_d, ic_d, w_full, prepared, hard_d, **rows)
            if t_start is None:
                with spans.span("train.drain"):
                    self._sync()
                t_start = time.perf_counter()
                if trace is not None:
                    trace.start(epoch)
            else:
                timed_epochs += 1
            if trace is not None:
                trace.after(epoch)
            last = epoch == start_epoch + epoch_num
            if epoch % int(save_freq) == 0 or last:
                # drain the queued device work first so it counts as training time
                with spans.span("train.drain"):
                    self._sync()
                with spans.timed("train.report") as report:
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
                              + (f"  ic {aux_host['loss_ic']:.3e}" if "loss_ic" in aux_host
                                 else "")
                              + f"  relL2 {err_s}  ({elapsed:.1f}s)", flush=True)
                    if log_path is not None:
                        if main:
                            with open(log_path, "a") as f:
                                f.write(json.dumps({"epoch": epoch, "err": err, **aux_host})
                                        + "\n")
                            self._save(folderpath, epoch, theta, {"seed": self.seed}, optimizer)
                        barrier(self.mesh)
                report_seconds += report.seconds
                if target_error is not None and err is not None and err < target_error:
                    if verbose:
                        print(f"[varnet] target error {target_error:.1e} reached")
                    break

        with spans.span("train.drain"):
            self._sync()
        total_time = time.perf_counter() - t_start - report_seconds if t_start else 0.0
        result.total_steps = timed_epochs * batch_num
        result.steps_per_sec = result.total_steps / total_time if total_time > 0 else 0.0
        result.quad_evals_per_sec = (
            timed_epochs * n_real_quad / total_time if total_time > 0 else 0.0)
        result.prepare_seconds, result.report_seconds = prepare.seconds, report_seconds
        self.theta = tree_map(torch.Tensor.detach, theta)
        self.train_result = result
        if folderpath is not None:
            if main:
                with open(os.path.join(folderpath, "train_result.json"), "w") as f:
                    json.dump(result.as_dict(), f, indent=2)
            barrier(self.mesh)
        return result

    # ------------------------------------------------------------------ #
    # ensembles

    def train_ensemble(
        self,
        epoch_num: int,
        n_members: int = 8,
        weight: Optional[Sequence[float]] = None,
        batch_num: int = 1,
        save_freq: int = 500,
        verbose: bool = True,
        error_disc: int = 64,
        error_times: int = 5,
        select: str = "error",
        matmul_precision: Optional[str] = None,
        normalize_residual: bool = True,
    ) -> EnsembleResult:
        """Train ``n_members`` independently seeded nets side by side (reference
        ``VarNet.train_ensemble``): seed-variance measurement, best-of-E
        selection, and a spread for ``evaluate_ensemble``.

        Member i starts from ``_init_member(i)``.  The loss is the sum of the
        member losses, so each member's gradient is its own, and one optimizer
        steps over every member's leaves: Adam, RMSProp and SGD are elementwise,
        so that is E independent optimizers.  ``grad_clip`` would couple the
        members through the joint norm and is refused.  With ``batch_num == 1``
        and a fused residual (``_fused_kind``) the members run one after another
        through the fused kernels (K1/K2, K2-FF, K3 or K4), as the JAX package's
        ``lax.map`` runs them; otherwise each member takes the general path (K5
        on ``use_pallas``), where the JAX package vmaps: the same sum.

        select: 'error' (rel-L2 against ``pde.c_ex``, the default) or 'loss', the
        winner's criterion.  After the run ``self.theta`` is the winner,
        ``self.opt_state`` is None and ``self._ensemble_thetas`` holds every
        member, stacked on a leading axis as host NumPy arrays (``save_theta_npz``
        / ``load_theta_npz`` round-trip it).  ``steps_per_sec`` counts ensemble
        steps, ``quad_evals_per_sec`` member evaluations (x E), report overhead
        excluded.
        """
        if int(n_members) < 2:
            raise ValueError("train_ensemble needs n_members >= 2")
        if select not in ("error", "loss"):
            raise ValueError("select must be 'error' or 'loss'")
        if self.optimizer_cfg.grad_clip is not None:
            raise ValueError("grad_clip couples ensemble members through the joint "
                             "global norm; use grad_clip=None with train_ensemble")
        with matmul_precision_scope(matmul_precision or "highest"):
            return self._train_ensemble_impl(int(epoch_num), int(n_members), weight,
                                             int(batch_num), int(save_freq),
                                             verbose and self.mesh.is_main,
                                             error_disc, error_times, select,
                                             normalize_residual)

    def _train_ensemble_impl(self, epoch_num, e, weight, batch_num, save_freq, verbose,
                             error_disc, error_times, select, normalize_residual):
        w_full = self._weights(weight)
        kind = self._fused_kind if batch_num == 1 else None
        loss_fn, (quads, bc_d, ic_d, prepared, hard_d) = self._adam_data(
            kind, batch_num, normalize_residual)
        rows = self._rows()

        def ens_loss(members, quad, bc, ic, weights, prep, hard=None, **kw):
            totals = torch.stack([loss_fn(th, quad, bc, ic, weights, prep, hard, **kw)[0]
                                  for th in members])
            # the sum: each member's gradient stays its own
            return totals.sum(), {"member_loss": totals}

        members = [tree_map(lambda v: v.clone().requires_grad_(True),
                            replicate(self._as_tensors(self._init_member(i)), self.mesh))
                   for i in range(e)]
        optimizer = make_optimizer(self.optimizer_cfg, tree_leaves(members))
        step_fn = make_train_step(ens_loss, optimizer, batch_num=batch_num, mesh=self.mesh)

        result = EnsembleResult(n_members=e)
        n_real_quad = self.static.n_test * self.static.n_quad_per_test
        t_start = None
        timed_epochs = 0
        report_overhead = 0.0
        for epoch in range(1, epoch_num + 1):
            aux = step_fn(members, quads, bc_d, ic_d, w_full, prepared, hard_d, **rows)
            if t_start is None:
                self._sync()
                t_start = time.perf_counter()
            else:
                timed_epochs += 1
            if epoch % save_freq == 0 or epoch == epoch_num:
                self._sync()
                t_rep = time.perf_counter()
                losses = [float(v) for v in aux["member_loss"]]
                errs = [self.compute_error(th, disc=error_disc, n_times=error_times)
                        for th in members]
                elapsed = time.perf_counter() - t_start
                result.epochs.append(epoch)
                result.member_losses.append(losses)
                result.member_errors.append(
                    [float("nan") if v is None else float(v) for v in errs])
                result.wall_times.append(elapsed)
                if verbose:
                    lo = int(np.argmin(losses))
                    err_s = ("n/a" if errs[0] is None else
                             f"best {np.nanmin(result.member_errors[-1]):.3e}"
                             f" / worst {np.nanmax(result.member_errors[-1]):.3e}")
                    print(f"[varnet/ens] epoch {epoch:7d}  loss [{min(losses):.4e} .. "
                          f"{max(losses):.4e}] (member {lo} lowest)  relL2 {err_s}  "
                          f"({elapsed:.1f}s)", flush=True)
                report_overhead += time.perf_counter() - t_rep

        self._sync()
        total_time = time.perf_counter() - t_start - report_overhead if t_start else 0.0
        result.steps_per_sec = timed_epochs * batch_num / total_time if total_time > 0 else 0.0
        result.quad_evals_per_sec = (
            timed_epochs * e * n_real_quad / total_time if total_time > 0 else 0.0)

        final_errs = result.member_errors[-1] if result.member_errors else []
        if select == "error" and final_errs and not all(np.isnan(v) for v in final_errs):
            best = int(np.nanargmin(final_errs))
            result.best_error = float(final_errs[best])
        else:
            best = int(np.argmin(result.member_losses[-1]))
            if final_errs and not np.isnan(final_errs[best]):
                result.best_error = float(final_errs[best])
        result.best_member = best
        self.theta = tree_map(lambda v: v.detach().clone(), members[best])
        self.opt_state = None   # the joint state does not transfer to train()
        columns = iter([np.stack(col) for col in
                        zip(*(tree_leaves(params_to_numpy(m)) for m in members))])
        self._ensemble_thetas = tree_map(lambda _: next(columns), members[0])
        if verbose:
            print(f"[varnet/ens] selected member {best}"
                  + ("" if result.best_error is None else f" (relL2 {result.best_error:.3e})"),
                  flush=True)
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
        weight:      (w_int, w_bc[, w_ic][, w_obs]) loss weights, as ``train``
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
        self._check_retries(max_retries)
        verbose = verbose and self.mesh.is_main
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
        elif lm_folder is not None:
            if self.mesh.is_main and list_checkpoint_steps(lm_folder):
                shutil.rmtree(lm_folder)
                if verbose:
                    print(f"[varnet/lm] cleared stale LM checkpoints in {lm_folder} (fresh "
                          "run; pass resume=True to continue them instead)")
            barrier(self.mesh)

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

        with spans.span("lm.call"):
            return self._retry_transient(attempt_fn, on_fault, max_retries, retry_backoff,
                                         verbose, label="/lm", include_oom=True)

    def _refine_lm_impl(self, steps, weight, cg_iters, save_freq, verbose, error_disc,
                        error_times, lam0, target_error, k_chunks, cg_segment, precond,
                        precond_mode, folderpath=None, step_offset=0) -> TrainResult:
        with spans.timed("lm.prepare") as prepare:
            w_full = self._weights(weight)
            # each rank's block of the test functions splits into k_chunks chunks
            quad_h = pad_quad(self.fixed.quad, self.n_shards * k_chunks)
            quad_d = shard_quad(quad_h, self.mesh, self.dtype)
            bc_d, ic_d = self._points()
            hard_h = self._hard_tables(quad_h)
            hard_d = None if hard_h is None else shard_hard((hard_h, None, None), self.mesh,
                                                            self.dtype)[0]
            rows = self._rows()
            res_fn = make_residual_fn(
                self.static, activation=self.activation, k_chunks=k_chunks,
                value_and_jac=self._value_and_jac(self.use_pallas),
                has_react=self.has_react, device=self.device,
                input_scaling=self.input_scaling, apply_fn=self._apply_fn(),
                hard_mode=self.hard is not None, nl_vec=self.nl_vec, dtype=self.dtype,
                **self._hook_kwargs())
            theta0 = replicate(self._params(None), self.mesh)
            flat0, unravel = ravel_params(theta0)

            def closure(flat):
                return res_fn(unravel(flat), quad_d, bc_d, ic_d, w_full, hard=hard_d, **rows)

            lm_step = make_lm_step(closure, cg_iters=cg_iters, cg_segment=cg_segment,
                                   precond=precond, leaf_segments=leaf_segments(theta0),
                                   precond_mode=precond_mode, mesh=self.mesh)
            with torch.no_grad():
                r0 = closure(flat0)
            state = LMState(flat=flat0,
                            lam=torch.tensor(lam0, dtype=self.dtype, device=self.device),
                            loss=all_reduce_sum(torch.dot(r0, r0), self.mesh))

        result = TrainResult()
        t_start = None
        report_seconds = 0.0
        for it in range(1, steps + 1):
            with spans.span("lm.iteration"):
                state = lm_step(state)
            if t_start is None:
                with spans.span("lm.drain"):
                    self._sync()
                t_start = time.perf_counter()
            if it % save_freq == 0 or it == steps:
                with spans.span("lm.drain"):
                    self._sync()
                with spans.timed("lm.report") as report:
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
                        if self.mesh.is_main:
                            self._save(folderpath, it_g, theta_now,
                                       {"lam": lam, "loss": loss, "phase": "lm"})
                        barrier(self.mesh)
                report_seconds += report.seconds
                if target_error is not None and err is not None and err < target_error:
                    if verbose:
                        print(f"[varnet/lm] target {target_error:.1e} reached")
                    break
        self.theta = tree_map(lambda v: v.detach().clone(), unravel(state.flat))
        result.total_steps = step_offset + steps
        result.prepare_seconds, result.report_seconds = prepare.seconds, report_seconds
        self.train_result = result
        return result

    # ------------------------------------------------------------------ #
    # L-BFGS refinement

    def refine_lbfgs(
        self,
        steps: int = 500,
        weight: Optional[Sequence[float]] = None,
        save_freq: int = 100,
        verbose: bool = True,
        error_disc: int = 64,
        error_times: int = 5,
        memory_size: int = 20,
        target_error: Optional[float] = None,
        matmul_precision: Optional[str] = "highest",
        normalize_residual: bool = True,
    ) -> TrainResult:
        """L-BFGS polish after Adam (reference ``VarNet.refine_lbfgs``): full
        batch, ``optax.lbfgs(memory_size=)``'s two-loop recursion and zoom line
        search (``train/lbfgs.py``).  The loss is the general path's: its value +
        jacobian through K5's forward and backward on ``use_pallas`` (K7 with an
        embedding), the plain chain otherwise.  Each line-search step evaluates
        the loss and its gradient once; the last one's carry into the next
        iteration.  ``losses`` hold the loss at the start of each reported
        iteration, the rel-L2 is that of the iterate after it.

        Start it from a mid-converged Adam state: from a deeply converged one
        (loss near the f32 line search's resolution) the zoom search cannot
        certify descent and stalls.
        """
        with matmul_precision_scope(matmul_precision):
            return self._refine_lbfgs_impl(int(steps), weight, int(save_freq),
                                           verbose and self.mesh.is_main,
                                           error_disc, error_times, int(memory_size),
                                           target_error, normalize_residual)

    def _refine_lbfgs_impl(self, steps, weight, save_freq, verbose, error_disc, error_times,
                           memory_size, target_error, normalize_residual) -> TrainResult:
        w_full = self._weights(weight)
        loss_fn, (quad_d, bc_d, ic_d, _, hard_d) = self._adam_data(None, 1, normalize_residual)
        rows = self._rows()
        flat, unravel = ravel_params(replicate(self._params(None), self.mesh))

        def value_and_grad(vec):
            vec = vec.detach().requires_grad_(True)
            with torch.enable_grad():
                total, _ = loss_fn(unravel(vec), quad_d, bc_d, ic_d, w_full, None, hard_d,
                                   **rows)
                (grad,) = torch.autograd.grad(total, vec)
            # this rank's share of the loss and its gradient: [grad, value] in
            # one all-reduce (the identity without a group), so the line search
            # sees the same sums on every rank
            packed = all_reduce_sum(torch.cat([grad, total.detach()[None]]), self.mesh)
            return packed[-1], packed[:-1]

        lbfgs = LBFGS(flat.numel(), memory_size, device=self.device, dtype=flat.dtype)
        value = grad = None
        result = TrainResult()
        t_start = None
        for it in range(1, steps + 1):
            if value is None or not math.isfinite(float(value)):
                # optax.value_and_grad_from_state: the line search's last
                # evaluation serves the next iteration unless it is not finite
                value, grad = value_and_grad(flat)
            start_value = value
            flat, ls = lbfgs_iteration(value_and_grad, lbfgs, flat, value, grad)
            value, grad = ls.value, ls.grad
            if t_start is None:
                self._sync()
                t_start = time.perf_counter()
            if it % save_freq == 0 or it == steps:
                loss = float(start_value)
                err = self.compute_error(unravel(flat), disc=error_disc, n_times=error_times)
                result.epochs.append(it)
                result.losses.append({"loss": loss})
                result.errors.append(err if err is not None else float("nan"))
                result.wall_times.append(time.perf_counter() - t_start)
                if verbose:
                    err_s = f"{err:.3e}" if err is not None else "n/a"
                    print(f"[varnet/lbfgs] it {it:6d}  loss {loss:.4e}  relL2 {err_s}"
                          f"  ({result.wall_times[-1]:.1f}s)", flush=True)
                if target_error is not None and err is not None and err < target_error:
                    if verbose:
                        print(f"[varnet/lbfgs] target {target_error:.1e} reached")
                    break
        self.theta = tree_map(lambda v: v.detach().clone(), unravel(flat))
        result.total_steps = steps
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
            "param_count": int(sum(v.numel() for v in tree_leaves(net_of(self.theta)))),
        }

    def _save(self, folderpath, step, theta, meta, optimizer=None):
        """One checkpoint (theta, the optimizer's state when given), its meta
        sidecar and ``config.json``."""
        state = {"theta": tree_map(lambda v: v.detach().clone(), theta)}
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
        optimizer = make_optimizer(self.optimizer_cfg, tree_leaves(theta))
        state, step = load_checkpoint(folderpath, {"theta": theta,
                                                   "opt_state": optimizer.state_dict()},
                                      step, map_location=self.device)
        self.theta = state["theta"]
        self.opt_state = state["opt_state"]
        return step

    # ------------------------------------------------------------------ #
    # evaluation

    def _params(self, theta):
        """theta (None = current; a parameter tree of torch tensors, or of NumPy
        or JAX arrays in the JAX layout) as tensors on the device."""
        return self._as_tensors(self.theta if theta is None else theta)

    def _as_tensors(self, tree):
        """A tree of tensors or arrays as tensors of the instance's dtype on the
        device (tensors already there are not copied)."""
        def leaf(a):
            if isinstance(a, torch.Tensor):
                return a.detach().to(device=self.device, dtype=self.dtype)
            return torch.as_tensor(np.array(a), dtype=self.dtype, device=self.device)

        return tree_map(leaf, tree)

    def _weights(self, weight):
        """The 4-slot loss weights (w_int, w_bc, w_ic, w_obs) of a call's
        ``weight`` (default 1 for every term the problem has)."""
        td = self.static.time_dependent
        if weight is None:
            weight = (1.0,) * (2 + td + (self.obs_data is not None))
        return obs_weight_slots(weight, td)

    def evaluate(self, x: np.ndarray, t: Optional[np.ndarray] = None,
                 mu: Optional[np.ndarray] = None, theta: Any = None,
                 chunk: int = 1 << 20, matmul_precision: Optional[str] = "highest") -> np.ndarray:
        """u_theta at points (reference ``VarNet.evaluate``), the net in the
        instance's dtype (exact f32 by default); with exact BC the ansatz A + B n
        is applied on the host in f64.  Every rank evaluates in full, with no
        collective.

        x: [P, d]; t: scalar or [P] (time-dependent problems);
        mu: [P, n_mor] or [n_mor] (parametric problems).  Large point sets
        are evaluated in chunks of ``chunk`` points.  ``matmul_precision``:
        'highest' / 'float32' (TF32 off) or None (the flags as they are);
        reduced values raise, as in ``train``."""
        coords = self._make_coords(x, t, mu)
        net = net_of(self._params(theta))
        apply = self._apply_fn()
        outs = []
        with torch.no_grad(), matmul_precision_scope(matmul_precision):
            for s in range(0, coords.shape[0], chunk):
                block = torch.as_tensor(coords[s:s + chunk], dtype=self.dtype,
                                        device=self.device)
                u = apply(net, block, self.activation, self.scale, self.shift)
                outs.append(u.double().cpu().numpy())
        u = np.concatenate(outs) if outs else np.zeros(0)
        return u if self.hard is None else self._hard_combine(coords, u)

    def evaluate_field(self, which: str, x: np.ndarray, t: Optional[np.ndarray] = None,
                       theta: Any = None) -> np.ndarray:
        """A recovered trainable field at points (inverse problems; reference
        ``VarNet.evaluate_field``): ``which`` is 'source', 'kappa' or 'vel' and
        needs its hook (``source_fn`` / ``diff_fn`` / ``vel_fn``).  x: [P, d];
        t: scalar or [P] (time-dependent problems).  Returns [P] (source,
        kappa) or [P, d] (vel), evaluated in f32 as the loss evaluates it."""
        fn, leaf = {"source": (self.source_fn, "src"), "kappa": (self.diff_fn, "kap"),
                    "vel": (self.vel_fn, "vel")}[which]
        if fn is None:
            raise ValueError(f"evaluate_field('{which}') requires the corresponding "
                             "trainable hook (source_fn/diff_fn/vel_fn)")
        theta = self._params(theta)
        x = torch.as_tensor(np.atleast_2d(np.asarray(x, self._np_dtype)), device=self.device)
        t_d = None
        if self.static.time_dependent and t is not None:
            t_d = torch.as_tensor(np.broadcast_to(np.asarray(t, self._np_dtype), (x.shape[0],)),
                                  device=self.device)
        with torch.no_grad(), matmul_precision_scope():
            out = fn(theta[leaf], x, t_d)
        return out.detach().cpu().numpy()

    def evaluate_ensemble(self, x: np.ndarray, t: Optional[np.ndarray] = None,
                          mu: Optional[np.ndarray] = None, thetas: Any = None,
                          chunk: int = 1 << 20, matmul_precision: Optional[str] = "highest",
                          return_members: bool = False):
        """Ensemble mean and spread of u at points (reference
        ``VarNet.evaluate_ensemble``): every member of the last
        ``train_ensemble`` (or of a stacked ``thetas`` tree with a leading
        member axis) through ``evaluate``; returns ``(mean [P], std [P])``, and
        the ``[E, P]`` member matrix with ``return_members``."""
        thetas = self._ensemble_thetas if thetas is None else thetas
        if thetas is None:
            raise ValueError("no ensemble available: run train_ensemble first or pass "
                             "a stacked thetas pytree")
        e = tree_leaves(thetas)[0].shape[0]
        with matmul_precision_scope(matmul_precision):
            members = np.stack([self.evaluate(x, t=t, mu=mu, chunk=chunk,
                                              theta=tree_map(lambda a: a[i], thetas))
                                for i in range(e)])
        mean, std = members.mean(axis=0), members.std(axis=0)
        if return_members:
            return mean, std, members
        return mean, std

    def evaluate_grad(self, x: np.ndarray, t: Optional[np.ndarray] = None,
                      mu: Optional[np.ndarray] = None, theta: Any = None,
                      matmul_precision: Optional[str] = "highest",
                      chunk: int = 1 << 20) -> Dict[str, np.ndarray]:
        """u and its input derivatives at points (reference
        ``VarNet.evaluate_grad``): ``{"u": [P], "grad": [P, d]}`` and ``"u_t":
        [P]`` for a time-dependent problem, with the exact-BC ansatz applied on
        the host in f64; conventions as ``evaluate``, in chunks of ``chunk``
        points.  The value + jacobian runs through K5's forward on
        ``use_pallas`` (K7 with an embedding), the plain chain otherwise."""
        coords = self._make_coords(x, t, mu)
        net = net_of(self._params(theta))
        vj_fn = self._value_and_jac(self.use_pallas)
        us, dus = [], []
        with torch.no_grad(), matmul_precision_scope(matmul_precision):
            for s in range(0, coords.shape[0], chunk):
                block = torch.as_tensor(coords[s:s + chunk], dtype=self.dtype,
                                        device=self.device)
                u, du = vj_fn(net, block, self.activation, self.scale, self.shift)
                us.append(u.double().cpu().numpy())
                dus.append(du.double().cpu().numpy())
        u = np.concatenate(us) if us else np.zeros(0)
        du = np.concatenate(dus) if dus else np.zeros((0, coords.shape[1]))
        d = self.static.n_space
        grad, u_t = du[:, :d], (du[:, d] if self.static.time_dependent else None)
        if self.hard is not None:
            u, grad, u_t = hard_transform(u, grad, u_t, self.hard.tables(coords))
        out = {"u": u, "grad": grad}
        if self.static.time_dependent:
            out["u_t"] = u_t
        return out

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
        theta = self._params(theta)
        net = net_of(theta)
        d, td, n_in = self.static.n_space, self.static.time_dependent, self.static.n_inputs
        vj_fn = self._value_and_jac(False)
        need_u = self.has_react or self.nl_vec is not None
        nl = (None if self.nl_vec is None
              else torch.as_tensor(np.asarray(self.nl_vec), dtype=self.dtype,
                                   device=self.device))
        per_node = quad.tables_per_node
        chunk = max(1, min(int(chunk), k_real))
        out = np.empty(k_real, dtype=np.float64)

        def dev(a):
            return torch.from_numpy(np.array(a, dtype=self._np_dtype)).to(self.device)

        with torch.no_grad(), matmul_precision_scope(matmul_precision or "highest"):
            for lo in range(0, k_real, chunk):
                sl = slice(lo, min(lo + chunk, k_real))
                coords_c = np.asarray(quad.coords[sl]).astype(np.float32)
                c, nq = coords_c.shape[0], coords_c.shape[1]
                tbls = [dev(a[sl] if per_node else a) for a in (quad.N, quad.dN, quad.w)]
                flat = dev(coords_c).reshape(c * nq, n_in)
                u, du = vj_fn(net, flat, self.activation, self.scale, self.shift)
                grad_u = du[:, :d].reshape(c, nq, d)
                u_t = du[:, d].reshape(c, nq) if td else None
                u = u.reshape(c, nq)
                if self.hard is not None:
                    # tables at the f32 coords, as the JAX package builds them here
                    hq = self._tables(self.hard.tables(coords_c))
                    u, grad_u, u_t = hard_transform(u, grad_u, u_t, hq)
                kappa, vel, src = hook_fields(
                    theta, flat, d, td, dev(quad.kappa[sl]), dev(quad.vel[sl]),
                    dev(quad.src[sl]), self.source_fn, self.diff_fn, self.vel_fn)
                r = weak_residual(grad_u, *tbls, kappa, vel, src, u_t, u=u if need_u else None,
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
            merged.prepare_seconds += res.prepare_seconds
            merged.report_seconds += res.report_seconds
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

    # ------------------------------------------------------------------ #
    # visualization

    def sim_res(self, folderpath: str, disc: int = 64, n_times: int = 5):
        """Render solution plots into the case folder (reference ``VarNet.simRes``,
        ``viz/plot.py``).  matplotlib is imported here, on demand: without it
        this raises an ``ImportError`` that names it."""
        try:
            from .viz.plot import plot_solution
        except ModuleNotFoundError as err:
            if not (err.name or "").startswith("matplotlib"):
                raise
            raise ImportError("VarNet.sim_res needs matplotlib, which is not installed "
                              "here") from err
        return plot_solution(self, folderpath, disc=disc, n_times=n_times)
