"""Levenberg-Marquardt refinement (matrix-free Gauss-Newton + CG): the PyTorch
port of ``varnet_tpu/train/gauss_newton.py`` (penalty and exact-BC forms, one
device or data parallel over ranks).

The variational loss is a nonlinear least-squares problem,

    L(theta) = || r_full(theta) ||^2,
    r_full = [ sqrt(w_int/K) r_k / vol_k,  sqrt(w_bc/N_bc) e_bc,  sqrt(w_ic/N_ic) e_ic,
               sqrt(w_obs/N_obs) e_obs,  sqrt(w_bc/N_neu) e_neu ],

(exact BC/IC, ``hard_mode``: the BC/IC rows drop out, and the interior,
observation and flux rows are of u = A + B n; an inverse problem's theta
carries its trainable source / diffusivity / velocity leaves, raveled with the
net),
so Gauss-Newton curvature J^T J is applied matrix-free: J v by forward mode
(``torch.autograd.forward_ad`` dual tensors) and J^T w by a retained reverse
pass, once each per CG iteration.  With ``value_and_jac`` from
``ops/value_and_jac.py`` both reach the hand-written kernels: the forward-mode
rule is K6, the reverse rule K5's backward (K8 and K7's backward with a
Fourier-feature embedding).

Both run on the iteration's stored primal.  The parameters stay at ``flat``
from the linearization to the accept, so one LM iteration keeps the net's
(u, du) per interior chunk (a :class:`PrimalStore`, (1 + n_in) floats per
interior point: 158.5 MB for the contaminant recipe's 9.9M points), filled by
the linearization's forward; J v's dual forward, J^T w's checkpointed
recompute and a segment's re-linearization read it, so the net's forward (K5's
or K7's) runs twice per chunk and LM iteration, there and in the accept,
whatever cg_iters and cg_segment are.  The store is dropped before the accept
evaluates the candidate; the plain value + jacobian (``mlp_value_and_jac``)
has no rules of its own and recomputes.

The JAX step is one jitted program; here it runs eagerly, with every quantity
(parameters, damping, loss, CG state) kept on the device, so the host never
waits on the card inside a step.

Data parallel (a distributed ``mesh``, the JAX package's
``_make_lm_step_sharded``): the closure gives this rank's slice of the residual
rows, J v stays local, J^T (J v) is summed over the ranks once per CG
application; the init packs b, the probe diagonal and r.r into one all-reduce
and the accept reduces the candidate loss: 2 + cg_iters all-reduces per LM
iteration, and every rank takes the same decision from the same sums.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint

from ..fem.assembly import ProblemStatic
from ..fem.hardbc import hard_transform
from ..models.mlp import make_input_scaling, mlp_apply, mlp_value_and_jac, net_of
from ..ops.residual import hook_fields, support_volume, weak_residual
from ..ops.value_and_jac import PrimalSlot
from ..parallel.mesh import all_reduce_sum
from ..utils.spans import span
from .loss import flux_error, obs_values

_CHUNKED = ("coords", "kappa", "vel", "src", "react", "mask")


class PrimalStore:
    """One LM iteration's store of the net's primal: a ``PrimalSlot`` per
    (residual function, chunk's points), filled by the first evaluation of
    those points in the iteration and read by every later one.  The points are
    told apart by their memory, shape, strides and version, and each slot keeps
    its points alive, so other points (another quad, or the same tensor
    changed in place) get a slot of their own and never another's primal.  It
    serves only the parameters it was opened at, ``flat``: parameters that are
    not views of flat's memory at its version (another point, or flat changed
    in place) raise rather than get a stale primal.  Dropped, it serves
    nothing."""

    def __init__(self, flat: torch.Tensor):
        self._at = (flat.untyped_storage().data_ptr(), flat._version)
        self._slots = {}   # key -> (the points, their PrimalSlot)

    def slot(self, owner, points: torch.Tensor, net) -> Optional[PrimalSlot]:
        if self._at is None:
            return None
        for layer in net:
            for leaf in (layer["w"], layer["b"]):
                if (leaf.untyped_storage().data_ptr(), leaf._version) != self._at:
                    raise RuntimeError("the LM iteration's primal store was asked to serve "
                                       "parameters other than the ones it was opened at")
        key = (owner, points.device, points.dtype, points.data_ptr(), tuple(points.shape),
               points.stride(), points._version)
        if key not in self._slots:
            self._slots[key] = (points, PrimalSlot())
        return self._slots[key][1]

    def drop(self):
        self._at = None
        for _, slot in self._slots.values():
            slot.out = None
        self._slots.clear()


_scope = threading.local()   # .store: the calling thread's open PrimalStore


def _open_store() -> Optional[PrimalStore]:
    return getattr(_scope, "store", None)


@contextlib.contextmanager
def primal_scope(flat: torch.Tensor):
    """A :class:`PrimalStore` at ``flat`` for the residual functions of
    :func:`make_residual_fn` that this thread evaluates inside, dropped on
    exit.  A chunk's checkpointed recompute reaches the store it was
    evaluated with, whichever thread runs the reverse pass."""
    store, outer = PrimalStore(flat), _open_store()
    _scope.store = store
    try:
        yield store
    finally:
        store.drop()
        _scope.store = outer


def make_residual_fn(
    static: ProblemStatic,
    activation: str = "tanh",
    value_and_jac: Callable = mlp_value_and_jac,
    k_chunks: int = 1,
    has_react: bool = False,
    device=None,
    input_scaling: bool = True,
    apply_fn: Callable = mlp_apply,
    hard_mode: bool = False,
    nl_vec=None,
    source_fn: Optional[Callable] = None,
    diff_fn: Optional[Callable] = None,
    vel_fn: Optional[Callable] = None,
    has_obs: bool = False,
    n_obs_real: int = 1,
    flux_value_and_jac: Optional[Callable] = None,
    dtype=torch.float32,
):
    """Weighted residual VECTOR ``residual_fn(theta, quad, bc, ic=None,
    weights=(1, 1, 1, 0), hard=None, obs=None, neu=None, hard_obs=None,
    hard_neu=None) -> r_full`` with sum(r^2) == the total loss of
    ``make_loss_fn`` (its normalized-residual convention), whose arguments
    these are.  Inputs
    are scaled onto [-1, 1] as in the JAX package unless ``input_scaling``
    is False; ``apply_fn`` evaluates the net at the BC/IC points.

    ``k_chunks > 1`` evaluates the interior over that many chunks of the
    test-function axis, each under ``torch.utils.checkpoint`` when a graph is
    being built, so a reverse pass recomputes one chunk at a time (the JAX
    package's ``lax.map`` over ``jax.checkpoint``); K must divide evenly
    (pad with ``pad_quad``).  Per-node test tables and the exact-BC quad
    tables (``hard``, a HardQuad of tensors; ``hard_mode``) are chunked with
    their test functions; in hard mode the BC/IC rows drop out.
    ``nl_vec`` (the constant [d] Burgers direction b) adds the nonlinear
    advection term u (b . grad u), of the transformed u in hard mode; J v and
    J^T w still run through ``value_and_jac`` (K6 and K5's backward).
    ``source_fn`` / ``diff_fn`` / ``vel_fn`` replace the fixed source,
    diffusivity and velocity per chunk by the trainable fields of theta's
    ``src`` / ``kap`` / ``vel`` leaves; the flux rows (``neu``) take
    ``flux_value_and_jac`` (the plain matmul chain by default), the
    observation rows (``has_obs``, weight ``weights[3]``) ``apply_fn``.
    ``dtype``: that of the input scaling and the Burgers direction (the data's).

    ``value_and_jac`` takes ``primal=``: inside a :func:`primal_scope` each
    interior chunk's slot of the scope's store, else None.  The kernels'
    Functions (on the CPU too) keep the net's primal there; the plain chain
    ignores it and recomputes, as do the BC, IC, observation and flux rows.
    """
    d = static.n_space
    td = static.time_dependent
    n_in = static.n_inputs
    n_bc = float(max(static.n_bc, 1))
    n_ic = float(max(static.n_ic, 1))
    n_k = float(max(static.n_test, 1))
    n_obs = float(max(int(n_obs_real), 1))
    n_neu = float(max(static.n_neu, 1))
    flux_vj = flux_value_and_jac or mlp_value_and_jac
    scale = shift = None
    if input_scaling:
        scale, shift = make_input_scaling(static.input_lo, static.input_hi, dtype=dtype,
                                          device=device)
    nl = (None if nl_vec is None
          else torch.as_tensor(np.asarray(nl_vec), dtype=dtype, device=device))
    need_u = has_react or nl is not None

    def interior(theta, coords, kappa, vel, src, react, mask, n_tbl, dn_tbl, w_tbl, hq,
                 store=None):
        # store: the open PrimalStore (a checkpointed recompute gets the one its
        # chunk was first evaluated with), or None
        k, nq = coords.shape[0], coords.shape[1]
        flat = coords.reshape(k * nq, n_in)
        net = net_of(theta)
        primal = None if store is None else store.slot(interior, coords, net)
        u, du = value_and_jac(net, flat, activation, scale, shift, primal=primal)
        grad_u = du[:, :d].reshape(k, nq, d)
        u_t = du[:, d].reshape(k, nq) if td else None
        u = u.reshape(k, nq)
        if hard_mode:
            u, grad_u, u_t = hard_transform(u, grad_u, u_t, hq)
        kappa, vel, src = hook_fields(theta, flat, d, td, kappa, vel, src, source_fn, diff_fn,
                                      vel_fn)
        r = weak_residual(
            grad_u, n_tbl, dn_tbl, w_tbl, kappa, vel, src, u_t,
            u=u if need_u else None,
            react=react if has_react else None,
            nl_vec=nl,
        )
        return (r / support_volume(w_tbl)) * mask

    def residual_fn(theta, quad, bc, ic=None, weights=(1.0, 1.0, 1.0, 0.0), hard=None,
                    obs=None, neu=None, hard_obs=None, hard_neu=None):
        fields = [getattr(quad, f) for f in _CHUNKED]
        tables = (quad.N, quad.dN, quad.w)
        store = _open_store()
        if k_chunks == 1:
            r = interior(theta, *fields, *tables, hard, store)
        else:
            k = quad.coords.shape[0]
            if k % k_chunks:
                raise ValueError(f"K={k} not divisible by k_chunks={k_chunks}")
            kc = k // k_chunks
            per_node = quad.tables_per_node
            parts = []
            for c in range(k_chunks):
                sl = slice(c * kc, (c + 1) * kc)
                chunk = [a[sl] for a in fields]
                chunk += [a[sl] for a in tables] if per_node else list(tables)
                chunk.append(None if hard is None
                             else type(hard)(*(None if a is None else a[sl] for a in hard)))
                chunk.append(store)
                if torch.is_grad_enabled():
                    parts.append(checkpoint(interior, theta, *chunk, use_reentrant=False))
                else:
                    parts.append(interior(theta, *chunk))
            r = torch.cat(parts)
        parts = [math.sqrt(weights[0] / n_k) * r]
        net = net_of(theta)
        if not hard_mode:
            u_bc = apply_fn(net, bc.coords, activation, scale, shift)
            parts.append(math.sqrt(weights[1] / n_bc) * (u_bc - bc.values) * bc.mask)
            if ic is not None:
                u_ic = apply_fn(net, ic.coords, activation, scale, shift)
                parts.append(math.sqrt(weights[2] / n_ic) * (u_ic - ic.values) * ic.mask)
        if has_obs:
            if obs is None:
                # dropping the data rows would polish an objective without them
                raise ValueError("has_obs=True but the obs batch is None")
            u_obs = obs_values(net, obs, apply_fn, activation, scale, shift, hard_obs)
            parts.append(math.sqrt(weights[3] / n_obs) * (u_obs - obs.values) * obs.mask)
        if neu is not None:
            err = flux_error(net, neu, d, activation, scale, shift, flux_vj, hard_neu)
            parts.append(math.sqrt(weights[1] / n_neu) * err * neu.mask)
        return torch.cat(parts)

    return residual_fn


class LMState(NamedTuple):
    flat: torch.Tensor   # raveled parameters
    lam: torch.Tensor    # damping (0-dim)
    loss: torch.Tensor   # current ||r||^2 (0-dim)


_PROBE_KEY_SEED = 7
LAM_UP, LAM_DOWN = 4.0, 0.5      # damping after a rejected / an accepted step


def rademacher_probes(n_probes: int, n_r: int, dtype=torch.float32,
                      device=None, rank: int = 0) -> torch.Tensor:
    """[n_probes, n_r] Rademacher (+-1) probes from a ``torch.Generator``
    seeded ``_PROBE_KEY_SEED`` (fixed, as JAX's fixed key: the estimator is
    unbiased for any realization, and a frozen one keeps LM iterations
    reproducible); rank r > 0 of a data-parallel run seeds
    ``_PROBE_KEY_SEED + r``, so the ranks' probes are independent (the JAX
    package folds the shard index into its key)."""
    gen = torch.Generator().manual_seed(_PROBE_KEY_SEED + int(rank))
    z = torch.randint(0, 2, (n_probes, n_r), generator=gen) * 2 - 1
    return z.to(dtype=dtype, device=device)


def _diag_probe_est(pullback, z):
    """Hutchinson estimate of diag(J^T J) from the probes z [n_probes, n_r]
    through the pullback: E[(J^T z)_j^2] = sum_i J_ij^2 (before the floor,
    which :func:`_floor_diag` applies after any sum over ranks)."""
    q = torch.stack([pullback(zz) for zz in z])
    return torch.mean(q * q, dim=0)


def _floor_diag(diag):
    """A relative floor on the diagonal estimate: it guards against the rare
    probe-cancellation underestimate."""
    return torch.maximum(diag, 1e-4 * torch.mean(diag))


def _leaf_reduce_diag(diag, leaf_segments, n_leaves: int):
    """Collapse an elementwise diag(J^T J) estimate to per-LEAF means (one
    scalar per parameter leaf: the cross-layer curvature scale the
    preconditioner exists to fix, with a low-variance trace estimate)."""
    seg = torch.zeros(n_leaves, dtype=diag.dtype, device=diag.device)
    seg.index_add_(0, leaf_segments, diag)
    cnt = torch.bincount(leaf_segments, minlength=n_leaves).to(diag.dtype)
    return (seg / torch.clamp_min(cnt, 1.0))[leaf_segments]


def linearize(closure: Callable, flat: torch.Tensor):
    """(r, pullback): the residual at ``flat`` and w -> J^T w.  The graph is
    built once and kept (``retain_graph``), as JAX's ``jax.vjp`` linearizes
    once; chunks under ``checkpoint`` recompute their forward per call."""
    x = flat.detach().requires_grad_(True)
    with torch.enable_grad():
        r = closure(x)

    def pullback(w):
        return torch.autograd.grad(r, x, w, retain_graph=True)[0]

    return r.detach(), pullback


def jvp(closure: Callable, flat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """J v at ``flat`` by forward mode (dual tensors)."""
    with torch.no_grad(), fwAD.dual_level():
        r = closure(fwAD.make_dual(flat.detach(), v))
        return fwAD.unpack_dual(r).tangent


def make_lm_step(
    residual_closure: Callable,  # flat_params -> r vector
    cg_iters: int = 50,
    cg_segment: int = 0,
    precond: int = 0,
    leaf_segments=None,
    precond_mode: str = "diag",
    mesh=None,
):
    """One Levenberg-Marquardt iteration on RAVELED parameters:
    ``step(LMState) -> LMState``.

    Solves (J^T J + lam I) delta = -J^T r by ``cg_iters`` CG iterations (J v
    forward mode, J^T w through the retained pullback), accepts the step if
    the loss falls (lam *= LAM_DOWN) and rejects it otherwise (lam *= LAM_UP),
    lam clipped to [1e-12, 1e6].

    precond > 0: Jacobi-preconditioned CG with diag(J^T J) estimated by that
    many Hutchinson probes once per iteration; precond_mode 'leaf' reduces the
    estimate to per-leaf means (needs ``leaf_segments``, the flat-index ->
    leaf-id map), 'diag' keeps it elementwise.

    cg_segment > 0: CG runs in segments of that many iterations (exactly
    ``cg_iters`` in total), re-linearizing at the start of each after the
    first (which reuses the linearization that gave b), as the JAX package's
    host-looped segments do; 0 runs them all on one linearization.

    mesh: a distributed ``parallel.mesh.Mesh`` makes ``residual_closure`` this
    rank's residual slice and sums across ranks as the module docstring says.
    """
    if precond and precond_mode == "leaf" and leaf_segments is None:
        raise ValueError(
            "precond_mode='leaf' requires leaf_segments (flat-index -> leaf-id map); "
            "pass precond_mode='diag' for the elementwise estimate")
    n_probes = int(precond)
    segs = None if leaf_segments is None else torch.as_tensor(np.asarray(leaf_segments),
                                                              dtype=torch.long)
    n_leaves = 0 if segs is None else int(segs.max()) + 1
    rank = 0 if mesh is None else mesh.rank

    def loss_of(flat):
        with torch.no_grad():
            r = residual_closure(flat)
        return all_reduce_sum(torch.dot(r, r), mesh)

    def cg_run(flat, lam, pullback, carry, minv, n):
        # Preconditioned CG on (J^T J + lam I) with M^{-1} = minv (elementwise);
        # minv=None is plain CG (z == res).
        x, p, res, rz = carry
        for _ in range(n):
            with span("lm.cg_iter"):
                ap = all_reduce_sum(pullback(jvp(residual_closure, flat, p)), mesh) + lam * p
                alpha = rz / torch.clamp_min(torch.dot(p, ap), 1e-30)
                x = x + alpha * p
                res = res - alpha * ap
                z = res if minv is None else minv * res
                rz_new = torch.dot(res, z)
                p = z + (rz_new / torch.clamp_min(rz, 1e-30)) * p
                rz = rz_new
        return x, p, res, rz

    def cg_init(flat, lam):
        # b, the probes' mean square (J^T z)^2 and r.r in ONE all-reduce (the
        # identity without a group); the floor and the per-leaf means come
        # after the sum, so they see every rank's rows (the ranks' independent
        # probes give an unbiased sum)
        with span("lm.linearize"):
            r, pullback = linearize(residual_closure, flat)
            b = -pullback(r)
            n = b.shape[0]
            parts = [b]
            if n_probes:
                z = rademacher_probes(n_probes, r.shape[0], r.dtype, r.device, rank=rank)
                parts.append(_diag_probe_est(pullback, z))
            packed = all_reduce_sum(torch.cat(parts + [torch.dot(r, r)[None]]), mesh)
            b, loss, minv = packed[:n], packed[-1], None
            if n_probes:
                diag = _floor_diag(packed[n:2 * n])
                if precond_mode == "leaf":
                    diag = _leaf_reduce_diag(diag, segs.to(diag.device), n_leaves)
                minv = 1.0 / (diag + lam)
            z0 = b if minv is None else minv * b
            return (torch.zeros_like(b), z0, b, torch.dot(b, z0)), loss, minv, pullback

    def accept(flat, lam, loss, delta):
        with span("lm.accept"):
            cand = flat + delta
            cand_loss = loss_of(cand)
            improved = cand_loss < loss
            return LMState(
                flat=torch.where(improved, cand, flat),
                lam=torch.clamp(torch.where(improved, lam * LAM_DOWN, lam * LAM_UP), 1e-12, 1e6),
                loss=torch.where(improved, cand_loss, loss),
            )

    seg = int(cg_segment) if cg_segment and int(cg_segment) > 0 else 0

    def step(state: LMState) -> LMState:
        flat, lam = state.flat.detach(), state.lam
        # every J v and J^T w of the iteration is at flat: its linearization's
        # primal serves them all, and is dropped before the candidate's loss
        with primal_scope(flat):
            carry, loss, minv, pullback = cg_init(flat, lam)
            if not seg:
                carry = cg_run(flat, lam, pullback, carry, minv, int(cg_iters))
            else:
                done = 0
                while done < int(cg_iters):
                    n = min(seg, int(cg_iters) - done)
                    if done:
                        with span("lm.linearize"):
                            _, pullback = linearize(residual_closure, flat)
                    carry = cg_run(flat, lam, pullback, carry, minv, n)
                    done += n
        return accept(flat, lam, loss, carry[0])

    return step
