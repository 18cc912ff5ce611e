"""Levenberg-Marquardt refinement (matrix-free Gauss-Newton + CG): the PyTorch
port of ``varnet_tpu/train/gauss_newton.py`` (penalty and exact-BC forms, one
device).

The variational loss is a nonlinear least-squares problem,

    L(theta) = || r_full(theta) ||^2,
    r_full = [ sqrt(w_int/K) r_k / vol_k,  sqrt(w_bc/N_bc) e_bc,  sqrt(w_ic/N_ic) e_ic ],

(exact BC/IC, ``hard_mode``: the interior rows alone, of u = A + B n),
so Gauss-Newton curvature J^T J is applied matrix-free: J v by forward mode
(``torch.autograd.forward_ad`` dual tensors) and J^T w by a retained reverse
pass, once each per CG iteration.  With ``value_and_jac`` from
``ops/value_and_jac.py`` both reach the hand-written kernels: the forward-mode
rule is K6, the reverse rule K5's backward.

The JAX step is one jitted program; here it runs eagerly, with every quantity
(parameters, damping, loss, CG state) kept on the device, so the host never
waits on the card inside a step.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint

from ..fem.assembly import ProblemStatic
from ..fem.hardbc import hard_transform
from ..models.mlp import make_input_scaling, mlp_apply, mlp_value_and_jac
from ..ops.residual import support_volume, weak_residual

# make_residual_fn options of the JAX package that the port does not carry yet
# argument -> the feature it needs, not ported yet
UNPORTED = {
    "source_fn": "the trainable source of the inverse source problem",
    "diff_fn": "the trainable diffusivity of the inverse coefficient problem",
    "vel_fn": "the trainable velocity of the inverse coefficient problem",
    "has_obs": "observation rows",
    "neu": "Neumann/Robin flux rows",
}
_CHUNKED = ("coords", "kappa", "vel", "src", "react", "mask")


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
    **unported,
):
    """Weighted residual VECTOR ``residual_fn(theta, quad, bc, ic=None,
    weights=(1, 1, 1, 0), hard=None) -> r_full`` with sum(r^2) == the total
    loss of ``make_loss_fn`` (its normalized-residual convention).  Inputs
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
    """
    unknown = sorted(set(unported) - set(UNPORTED))
    if unknown:
        raise TypeError(f"make_residual_fn got unexpected arguments {unknown}")
    asked = sorted(k for k, v in unported.items() if v not in (None, False))
    if asked:
        raise NotImplementedError("not ported to varnet_tpu_torch yet: " + "; ".join(
            f"{UNPORTED[k]} ({k})" for k in asked))
    d = static.n_space
    td = static.time_dependent
    n_in = static.n_inputs
    n_bc = float(max(static.n_bc, 1))
    n_ic = float(max(static.n_ic, 1))
    n_k = float(max(static.n_test, 1))
    scale = shift = None
    if input_scaling:
        scale, shift = make_input_scaling(static.input_lo, static.input_hi, device=device)
    nl = (None if nl_vec is None
          else torch.as_tensor(np.asarray(nl_vec), dtype=torch.float32, device=device))
    need_u = has_react or nl is not None

    def interior(net, coords, kappa, vel, src, react, mask, n_tbl, dn_tbl, w_tbl, hq):
        k, nq = coords.shape[0], coords.shape[1]
        u, du = value_and_jac(net, coords.reshape(k * nq, n_in), activation, scale, shift)
        grad_u = du[:, :d].reshape(k, nq, d)
        u_t = du[:, d].reshape(k, nq) if td else None
        u = u.reshape(k, nq)
        if hard_mode:
            u, grad_u, u_t = hard_transform(u, grad_u, u_t, hq)
        r = weak_residual(
            grad_u, n_tbl, dn_tbl, w_tbl, kappa, vel, src, u_t,
            u=u if need_u else None,
            react=react if has_react else None,
            nl_vec=nl,
        )
        return (r / support_volume(w_tbl)) * mask

    def residual_fn(theta, quad, bc, ic=None, weights=(1.0, 1.0, 1.0, 0.0), hard=None):
        fields = [getattr(quad, f) for f in _CHUNKED]
        tables = (quad.N, quad.dN, quad.w)
        if k_chunks == 1:
            r = interior(theta, *fields, *tables, hard)
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
                if torch.is_grad_enabled():
                    parts.append(checkpoint(interior, theta, *chunk, use_reentrant=False))
                else:
                    parts.append(interior(theta, *chunk))
            r = torch.cat(parts)
        parts = [math.sqrt(weights[0] / n_k) * r]
        if not hard_mode:
            u_bc = apply_fn(theta, bc.coords, activation, scale, shift)
            parts.append(math.sqrt(weights[1] / n_bc) * (u_bc - bc.values) * bc.mask)
            if ic is not None:
                u_ic = apply_fn(theta, ic.coords, activation, scale, shift)
                parts.append(math.sqrt(weights[2] / n_ic) * (u_ic - ic.values) * ic.mask)
        return torch.cat(parts)

    return residual_fn


class LMState(NamedTuple):
    flat: torch.Tensor   # raveled parameters
    lam: torch.Tensor    # damping (0-dim)
    loss: torch.Tensor   # current ||r||^2 (0-dim)


_PROBE_KEY_SEED = 7
LAM_UP, LAM_DOWN = 4.0, 0.5      # damping after a rejected / an accepted step


def rademacher_probes(n_probes: int, n_r: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """[n_probes, n_r] Rademacher (+-1) probes from a ``torch.Generator``
    seeded ``_PROBE_KEY_SEED`` (fixed, as JAX's fixed key: the estimator is
    unbiased for any realization, and a frozen one keeps LM iterations
    reproducible)."""
    gen = torch.Generator().manual_seed(_PROBE_KEY_SEED)
    z = torch.randint(0, 2, (n_probes, n_r), generator=gen) * 2 - 1
    return z.to(dtype=dtype, device=device)


def _diag_probe_est(pullback, z):
    """Hutchinson estimate of diag(J^T J) from the probes z [n_probes, n_r]
    through the pullback: E[(J^T z)_j^2] = sum_i J_ij^2.  A relative floor
    guards against the rare probe-cancellation underestimate."""
    q = torch.stack([pullback(zz) for zz in z])
    diag = torch.mean(q * q, dim=0)
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
    """
    if precond and precond_mode == "leaf" and leaf_segments is None:
        raise ValueError(
            "precond_mode='leaf' requires leaf_segments (flat-index -> leaf-id map); "
            "pass precond_mode='diag' for the elementwise estimate")
    n_probes = int(precond)
    segs = None if leaf_segments is None else torch.as_tensor(np.asarray(leaf_segments),
                                                              dtype=torch.long)
    n_leaves = 0 if segs is None else int(segs.max()) + 1

    def loss_of(flat):
        with torch.no_grad():
            r = residual_closure(flat)
        return torch.dot(r, r)

    def make_minv(pullback, r, lam):
        if not n_probes:
            return None
        diag = _diag_probe_est(pullback, rademacher_probes(n_probes, r.shape[0], r.dtype,
                                                           r.device))
        if precond_mode == "leaf":
            diag = _leaf_reduce_diag(diag, segs.to(diag.device), n_leaves)
        return 1.0 / (diag + lam)

    def cg_run(flat, lam, pullback, carry, minv, n):
        # Preconditioned CG on (J^T J + lam I) with M^{-1} = minv (elementwise);
        # minv=None is plain CG (z == res).
        x, p, res, rz = carry
        for _ in range(n):
            ap = pullback(jvp(residual_closure, flat, p)) + lam * p
            alpha = rz / torch.clamp_min(torch.dot(p, ap), 1e-30)
            x = x + alpha * p
            res = res - alpha * ap
            z = res if minv is None else minv * res
            rz_new = torch.dot(res, z)
            p = z + (rz_new / torch.clamp_min(rz, 1e-30)) * p
            rz = rz_new
        return x, p, res, rz

    def cg_init(flat, lam):
        r, pullback = linearize(residual_closure, flat)
        b = -pullback(r)
        minv = make_minv(pullback, r, lam)
        z0 = b if minv is None else minv * b
        return (torch.zeros_like(b), z0, b, torch.dot(b, z0)), torch.dot(r, r), minv, pullback

    def accept(flat, lam, loss, delta):
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
        carry, loss, minv, pullback = cg_init(flat, lam)
        if not seg:
            carry = cg_run(flat, lam, pullback, carry, minv, int(cg_iters))
        else:
            done = 0
            while done < int(cg_iters):
                n = min(seg, int(cg_iters) - done)
                if done:
                    _, pullback = linearize(residual_closure, flat)
                carry = cg_run(flat, lam, pullback, carry, minv, n)
                done += n
        return accept(flat, lam, loss, carry[0])

    return step
