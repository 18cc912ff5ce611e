"""The port's Gauss-Newton pieces (varnet_tpu_torch.train.gauss_newton) against
the JAX package's on the small flagship mesh (disc 8 / b 6 / t 4) at a fixed
theta: the residual vector, J v and J^T w, the Hutchinson probe estimator and
its per-leaf reduction, chunking and CG segmentation.

Tolerances: the residual at rtol 1e-5 of max|r| (f32 sums in another order),
J v and J^T w at rtol 1e-4 of their max (one more chain rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from varnet_tpu.fem.assembly import PointData as JPoints
from varnet_tpu.fem.assembly import QuadData as JQuad
from varnet_tpu.train import gauss_newton as jgn
from varnet_tpu_torch.fem.assembly import build_fixed_data, pad_points, pad_quad
from varnet_tpu_torch.models.mlp import (
    leaf_segments,
    mlp_value_and_jac,
    params_from_jax,
    ravel_params,
)
from varnet_tpu_torch.ops.value_and_jac import value_and_jac
from varnet_tpu_torch.problems.analytic import transient_ad_2d
from varnet_tpu_torch.train import gauss_newton as gn
from varnet_tpu_torch.train.loss import make_loss_fn
from _torch_threads import _one_intra_op_thread  # noqa: F401


WEIGHTS = [1.0, 10.0, 10.0, 0.0]
VJ = {"general": mlp_value_and_jac, "kernel_fn": value_and_jac}


def _theta(n_in, widths=(20, 20), seed=0):
    rng = np.random.default_rng(seed)
    sizes = (n_in,) + widths + (1,)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


@pytest.fixture(scope="module")
def problem():
    """Fixed data padded to a multiple of 2 test functions, as torch tensors
    and as JAX arrays, and a theta."""
    fd = build_fixed_data(transient_ad_2d()["pde"], 8, b_disc_num=6, t_disc_num=4)
    quad = pad_quad(fd.quad, 2)
    bc, ic = pad_points(fd.bc, 1), pad_points(fd.ic, 1)

    def tq(t):
        return type(t)(*(torch.from_numpy(np.array(a, dtype=np.float32)) for a in t))

    def jq(t, cls):
        return cls(*(jnp.asarray(a, jnp.float32) for a in t))

    return dict(static=fd.static, quad=tq(quad), bc=tq(bc), ic=tq(ic),
                jquad=jq(quad, JQuad), jbc=jq(bc, JPoints), jic=jq(ic, JPoints),
                raw=_theta(fd.static.n_inputs))


def _closures(problem, vj="general", k_chunks=1):
    """(port closure, port flat, JAX closure, JAX flat) over raveled parameters."""
    res = gn.make_residual_fn(problem["static"], value_and_jac=VJ[vj], k_chunks=k_chunks)
    flat, unravel = ravel_params(params_from_jax(problem["raw"]))

    def closure(f):
        return res(unravel(f), problem["quad"], problem["bc"], problem["ic"], WEIGHTS)

    jres = jgn.make_residual_fn(problem["static"], k_chunks=k_chunks)
    jflat, junravel = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, problem["raw"]))

    def jclosure(f):
        return jres(junravel(f), problem["jquad"], problem["jbc"], problem["jic"], None,
                    weights=jnp.asarray(WEIGHTS))

    return closure, flat, jclosure, jflat


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("vj", list(VJ))
def test_residual_vector_matches_jax(problem, vj):
    closure, flat, jclosure, jflat = _closures(problem, vj)
    r = closure(flat)
    jr = jclosure(jflat)
    assert r.shape == jr.shape
    _close(r.detach().numpy(), jr, 1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_sum_of_squares_is_the_loss(problem, fused):
    """sum r^2 == make_loss_fn's total (the normalized-residual convention)."""
    from varnet_tpu_torch.models.mlp import make_input_scaling
    from varnet_tpu_torch.ops.fused_residual import prepare_residual_data

    st = problem["static"]
    closure, flat, _, _ = _closures(problem)
    r = closure(flat)
    loss_fn = make_loss_fn(st, fused=fused)
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    prepared = prepare_residual_data(problem["quad"], scale, shift, time_dependent=True,
                                     has_react=False) if fused else None
    total, _ = loss_fn(params_from_jax(problem["raw"]), problem["quad"], problem["bc"],
                       problem["ic"], WEIGHTS[:3], prepared)
    np.testing.assert_allclose(float(torch.dot(r, r)), float(total), rtol=1e-5)


def test_k_chunks_matches_one_chunk(problem):
    """k_chunks = 2 (checkpointed chunks) gives the same residual and J^T w."""
    c1, flat, _, _ = _closures(problem, "kernel_fn", 1)
    c2, _, _, _ = _closures(problem, "kernel_fn", 2)
    r1, pb1 = gn.linearize(c1, flat)
    r2, pb2 = gn.linearize(c2, flat)
    _close(r2.numpy(), r1.numpy(), 1e-6)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(r1.shape[0]).astype(np.float32))
    _close(pb2(w).numpy(), pb1(w).numpy(), 1e-6)
    _close(pb2(2 * w).numpy(), 2 * pb1(w).numpy(), 1e-6)   # the graph survives reuse


@pytest.mark.parametrize("k_chunks", [1, 2])
@pytest.mark.parametrize("vj", list(VJ))
def test_jv_and_jtw_match_jax(problem, vj, k_chunks):
    closure, flat, jclosure, jflat = _closures(problem, vj, k_chunks)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(flat.shape[0]).astype(np.float32)
    _, jr_pullback = jax.vjp(jclosure, jflat)
    jjv = jax.jvp(jclosure, (jflat,), (jnp.asarray(v),))[1]
    w = rng.standard_normal(jjv.shape[0]).astype(np.float32)
    jjtw = jr_pullback(jnp.asarray(w))[0]

    jv = gn.jvp(closure, flat, torch.from_numpy(v))
    _, pullback = gn.linearize(closure, flat)
    _close(jv.numpy(), jjv, 1e-4)
    _close(pullback(torch.from_numpy(w)).numpy(), jjtw, 1e-4)


def test_probe_estimator_and_leaf_reduce_match_jax(problem):
    """Given the same Rademacher matrix (drawn in JAX), the diag(J^T J)
    estimate (the probes' mean square, then its floor) and its per-leaf
    reduction agree."""
    closure, flat, jclosure, jflat = _closures(problem)
    jr, jpullback = jax.vjp(jclosure, jflat)
    n_r, n_probes = jr.shape[0], 4
    key = jax.random.PRNGKey(gn._PROBE_KEY_SEED)
    jdiag = jgn._diag_probe_est(jpullback, n_r, n_probes, jnp.float32, key)
    z = np.array(jax.random.rademacher(key, (n_probes, n_r), dtype=jnp.float32))
    _, pullback = gn.linearize(closure, flat)
    diag = gn._floor_diag(gn._diag_probe_est(pullback, torch.from_numpy(z)))
    _close(diag.numpy(), jdiag, 1e-4)

    segs = leaf_segments(params_from_jax(problem["raw"]))
    n_leaves = int(segs.max()) + 1
    jleaf = jgn._leaf_reduce_diag(jdiag, jnp.asarray(segs), n_leaves)
    leaf = gn._leaf_reduce_diag(torch.from_numpy(np.asarray(jdiag)),
                                torch.from_numpy(segs), n_leaves)
    np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf), rtol=1e-6)
    assert len(np.unique(leaf.numpy())) == n_leaves


def test_rademacher_probes_are_fixed_signs():
    z1 = gn.rademacher_probes(3, 1000)
    z2 = gn.rademacher_probes(3, 1000)
    assert torch.equal(z1, z2) and set(z1.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(z1.mean())) < 0.1


def test_segmented_cg_matches_one_segment_with_exact_count(problem):
    """cg_segment = 2 with cg_iters = 5 runs exactly 5 CG iterations (segments
    2 + 2 + 1, re-linearized at the 2nd and 3rd) and lands where one segment
    does."""
    closure, flat, _, _ = _closures(problem)
    calls = {"n": 0}

    def counted(f):
        calls["n"] += 1
        return closure(f)

    r0 = closure(flat).detach()
    state = gn.LMState(flat=flat.detach(), lam=torch.tensor(1e-3), loss=torch.dot(r0, r0))
    out = {}
    for seg in (0, 2):
        calls["n"] = 0
        out[seg] = gn.make_lm_step(counted, cg_iters=5, cg_segment=seg)(state)
        out[seg, "calls"] = calls["n"]
    # linearize + 5 J v + accept, plus 2 re-linearizations when segmented
    assert (out[0, "calls"], out[2, "calls"]) == (7, 9)
    _close(out[2].flat.numpy(), out[0].flat.numpy(), 1e-5)
    np.testing.assert_allclose(float(out[2].loss), float(out[0].loss), rtol=1e-5)
    assert float(out[0].loss) < float(state.loss)
    assert float(out[0].lam) == pytest.approx(5e-4)


def test_unported_options_raise(problem):
    with pytest.raises(TypeError):
        gn.make_residual_fn(problem["static"], no_such_option=True)
    with pytest.raises(ValueError, match="leaf_segments"):
        gn.make_lm_step(lambda f: f, precond=2, precond_mode="leaf")
