"""The LM iteration's stored primal (``train/gauss_newton.py``'s ``PrimalStore``
and ``primal_scope``, ``ops/value_and_jac.py``'s ``PrimalSlot``).

One LM iteration keeps the net's (u, du) per interior chunk from its
linearization to its accept, and J v and J^T w read it instead of re-running
the net's forward.  The forward is deterministic, so everything must be
bit-equal (``torch.equal``) to the store-free computation:

* the products CG starts from (r, b = -J^T r, J b, J^T J b) at ``flat``;
* one ``make_lm_step`` step, against the same step with the scope left closed;
* the counts: one fill per chunk, the rest hits, and the net's forward run
  twice per chunk and iteration (the linearization and the accept);
* a store asked to serve other parameters raises, and other points (a second
  quad, or the same points changed in place) get their own slot.

On the CPU the kernels' Functions route to their plain versions: the FF net
(K7 / K8's Function) and the plain MLP (K5 / K6's), the penalty form, exact BC
and Burgers' nonlinear advection.  The ``gpu`` tests run the kernels on the
card; they skip elsewhere (run them with ``python -m pytest --noconftest -p
no:cacheprovider -m gpu tests/test_torch_lm_primal.py``).
"""

import contextlib
import functools
import threading

import pytest
import torch

from varnet_tpu_torch import VarNet, api
from varnet_tpu_torch.fem.assembly import pad_points, pad_quad
from varnet_tpu_torch.models.mlp import ravel_params
from varnet_tpu_torch.ops import value_and_jac as vj
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.train import gauss_newton as gn
from _torch_threads import _one_intra_op_thread  # noqa: F401

CG = 5
FORMS = {
    "penalty": (analytic.transient_ad_2d, dict(disc_num=8, b_disc_num=6, t_disc_num=4)),
    "hard": (analytic.steady_ad_2d, dict(disc_num=8, b_disc_num=6, hard_bc=True)),
    "burgers": (analytic.burgers_1d_transient, dict(disc_num=12, t_disc_num=6)),
}
NETS = {"mlp": dict(layer_width=(12, 12)),
        "ff": dict(layer_width=(12, 12), fourier_features=8, input_scaling=False)}
CASES = [(net, form) for form in FORMS for net in NETS]
IDS = [f"{net}-{form}" for net, form in CASES]


def _varnet(net, form, device="cpu", **kw):
    factory, mesh = FORMS[form]
    kw = {"use_pallas": True, **mesh, **NETS[net], **kw}
    return VarNet(factory()["pde"], device=device, **kw)


def _lm_closure(vn, k_chunks):
    """(closure, flat): the residual closure ``refine_lm`` hands to
    ``make_lm_step`` (flat -> r) and the raveled start point."""
    caught, real = [], api.make_lm_step

    def capture(closure, **kw):
        caught.append(closure)
        return real(closure, **kw)

    api.make_lm_step = capture
    try:
        vn.refine_lm(steps=0, k_chunks=k_chunks, verbose=False)
    finally:
        api.make_lm_step = real
    return caught[0], ravel_params(vn.theta)[0].detach().clone()


@functools.lru_cache(maxsize=None)
def _parts(net, form, k_chunks):
    return _lm_closure(_varnet(net, form), k_chunks)


def _state(closure, flat):
    with torch.no_grad():
        r0 = closure(flat)
    return gn.LMState(flat=flat, lam=torch.tensor(1e-3, device=flat.device),
                      loss=torch.dot(r0, r0))


def _products(closure, flat):
    """r, b = -J^T r, J b and J^T J b at flat, as CG's first iteration has them."""
    r, pullback = gn.linearize(closure, flat)
    b = -pullback(r)
    jb = gn.jvp(closure, flat, b)
    return r, b, jb, pullback(jb)


def _no_store(_flat):
    return contextlib.nullcontext()


def _counting(monkeypatch):
    """Count the calls of the net's forward (K5's and K7's, plain here)."""
    calls = {"n": 0}
    for name in ("vj_fwd", "ff_vj_fwd"):
        real = getattr(vj, name)

        def counted(*a, _real=real, **k):
            calls["n"] += 1
            return _real(*a, **k)

        monkeypatch.setattr(vj, name, counted)
    return calls


@pytest.mark.parametrize("k_chunks", [1, 4])
@pytest.mark.parametrize("net,form", CASES, ids=IDS)
def test_products_equal_the_store_free_ones(net, form, k_chunks):
    closure, flat = _parts(net, form, k_chunks)
    free = _products(closure, flat)
    with gn.primal_scope(flat):
        stored = _products(closure, flat)
    for name, a, b in zip(("r", "b", "J b", "J^T J b"), stored, free):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("cg_segment", [0, 2], ids=["one-segment", "segments"])
@pytest.mark.parametrize("k_chunks", [1, 4])
@pytest.mark.parametrize("net,form", CASES, ids=IDS)
def test_lm_step_is_bit_equal_to_the_store_free_step(net, form, k_chunks, cg_segment,
                                                     monkeypatch):
    closure, flat = _parts(net, form, k_chunks)
    state = _state(closure, flat)
    step = gn.make_lm_step(closure, cg_iters=CG, cg_segment=cg_segment)
    stored = step(state)
    monkeypatch.setattr(gn, "primal_scope", _no_store)
    free = step(state)
    for name, a, b in zip(gn.LMState._fields, stored, free):
        assert torch.equal(a, b), name
    assert float(stored.loss) <= float(state.loss)


@pytest.mark.parametrize("cg_segment", [0, 2], ids=["one-segment", "segments"])
@pytest.mark.parametrize("k_chunks", [1, 4])
@pytest.mark.parametrize("net,form", CASES, ids=IDS)
def test_fills_hits_and_forwards_per_iteration(net, form, k_chunks, cg_segment, monkeypatch):
    """One fill per chunk (the linearization's forward).  Hits per chunk: CG's
    J v and each re-linearization's forward, and with k_chunks > 1 every J^T w's
    checkpointed recompute too (b's and CG's); one chunk keeps the reverse graph
    whole, so its J^T w recomputes nothing.  The net's forward runs 2 k_chunks
    times per iteration: the linearization and the accept's candidate."""
    closure, flat = _parts(net, form, k_chunks)
    state = _state(closure, flat)
    step = gn.make_lm_step(closure, cg_iters=CG, cg_segment=cg_segment)
    calls = _counting(monkeypatch)
    fills, hits = vj.primal_fills, vj.primal_hits
    step(state)
    relinearized = -(-CG // cg_segment) - 1 if cg_segment else 0
    per_chunk = CG + relinearized + (0 if k_chunks == 1 else 1 + CG)
    assert vj.primal_fills - fills == k_chunks
    assert vj.primal_hits - hits == k_chunks * per_chunk
    assert calls["n"] == 2 * k_chunks


def test_plain_value_and_jac_keeps_recomputing(monkeypatch):
    """``mlp_value_and_jac`` has no rules of its own: no slot, every forward runs."""
    vn = _varnet("mlp", "penalty", use_pallas=False)
    closure, flat = _lm_closure(vn, 2)
    fills, hits = vj.primal_fills, vj.primal_hits
    free = _products(closure, flat)
    with gn.primal_scope(flat):
        stored = _products(closure, flat)
    assert (vj.primal_fills, vj.primal_hits) == (fills, hits)
    for a, b in zip(stored, free):
        assert torch.equal(a, b)


@pytest.mark.parametrize("net", list(NETS))
def test_store_refuses_other_parameters(net):
    closure, flat = _lm_closure(_varnet(net, "penalty"), 2)
    with gn.primal_scope(flat):
        gn.linearize(closure, flat)
        with pytest.raises(RuntimeError, match="primal store"):
            gn.jvp(closure, flat + 1e-3, torch.ones_like(flat))
        with pytest.raises(RuntimeError, match="primal store"):
            closure(flat.clone())
        flat.mul_(1.0)   # same values, changed in place
        with pytest.raises(RuntimeError, match="primal store"):
            closure(flat)
    with torch.no_grad():
        assert torch.isfinite(closure(flat + 1e-3)).all()   # closed: nothing served


@pytest.mark.parametrize("how", ["second-quad", "changed-in-place"])
@pytest.mark.parametrize("k_chunks", [1, 4])
@pytest.mark.parametrize("net", list(NETS))
def test_other_points_get_their_own_slot(net, k_chunks, how):
    """One residual function evaluated on two sets of points at the same
    parameters inside a scope: each set is served its own primal (bit-equal
    to the store-free residual), never the other's."""
    vn = _varnet(net, "penalty")
    res = gn.make_residual_fn(vn.static, value_and_jac=vn._value_and_jac(True),
                              apply_fn=vn._apply_fn(), k_chunks=k_chunks,
                              input_scaling=vn.input_scaling)
    flat, unravel = ravel_params(vn.theta)
    flat = flat.detach().clone()
    bc, ic = vn._to_device(pad_points(vn.fixed.bc, 1)), vn._to_device(pad_points(vn.fixed.ic, 1))
    quads = [vn._to_device(pad_quad(vn.fixed.quad, k_chunks)) for _ in range(2)]
    quads[1].coords.mul_(0.9)

    def closure(f, quad):
        return res(unravel(f), quad, bc, ic)

    with torch.no_grad():
        free = [closure(flat, q) for q in quads]
        fills, hits = vj.primal_fills, vj.primal_hits
        with gn.primal_scope(flat):
            first = closure(flat, quads[0])
            if how == "changed-in-place":
                quads[0].coords.mul_(0.9)   # now quads[1]'s points, in quads[0]'s memory
                second, again = closure(flat, quads[0]), closure(flat, quads[0])
            else:
                second, again = closure(flat, quads[1]), closure(flat, quads[0])
    assert torch.equal(first, free[0]) and torch.equal(second, free[1])
    assert torch.equal(again, free[1] if how == "changed-in-place" else free[0])
    assert (vj.primal_fills - fills, vj.primal_hits - hits) == (2 * k_chunks, k_chunks)


def test_store_is_dropped_when_the_scope_closes():
    closure, flat = _lm_closure(_varnet("ff", "penalty"), 2)
    with gn.primal_scope(flat) as store:
        _products(closure, flat)
        slots = [slot for _, slot in store._slots.values()]
        assert len(slots) == 2 and all(s.out is not None for s in slots)
    assert all(s.out is None for s in slots) and gn._open_store() is None
    fills = vj.primal_fills
    _products(closure, flat)
    assert vj.primal_fills == fills


def test_a_scope_belongs_to_the_thread_that_opened_it():
    """Another thread's residual at other parameters neither sees nor trips it."""
    closure, flat = _lm_closure(_varnet("mlp", "penalty"), 2)
    out = {}
    with gn.primal_scope(flat):
        worker = threading.Thread(target=lambda: out.update(r=closure(flat + 1e-3)))
        worker.start()
        worker.join(timeout=120)
    assert not worker.is_alive() and torch.isfinite(out["r"]).all()


# ---------------------------------------------------------------------------
# on the card: K5 / K6 and K7 / K8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


CARD_NETS = {
    # the contaminant recipe's net (128 Fourier features into tanh w96x3) on a small mesh
    "ff128-w96x3": (analytic.contaminant_transport_2d,
                    dict(layer_width=(96, 96, 96), fourier_features=128, input_scaling=False,
                         disc_num=8, b_disc_num=6, t_disc_num=4)),
    "flagship-w48x2": (analytic.transient_ad_2d,
                       dict(layer_width=(48, 48), disc_num=8, b_disc_num=6, t_disc_num=4)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_NETS))
def test_refine_lm_on_the_card_matches_the_store_free_products(cuda, name):
    """``refine_lm(steps=2)``'s b = -J^T r and its first CG product J^T J b, as
    the program computes them with the store, equal J v / J^T w composed by hand
    without it (``torch.equal``): K7 / K5's forward is deterministic."""
    factory, kw = CARD_NETS[name]
    vn = VarNet(factory()["pde"], device=cuda, **kw)
    assert vn.use_pallas
    closure, flat = _lm_closure(vn, 2)
    caught, linearize = [], gn.linearize

    def recording(clo, at):
        r, pullback = linearize(clo, at)

        def recorded(w):
            out = pullback(w)
            caught.append(out.detach().clone())
            return out

        return r, recorded

    gn.linearize = recording
    try:
        vn.refine_lm(steps=2, cg_iters=CG, k_chunks=2, save_freq=1, verbose=False,
                     error_disc=8, error_times=2)
    finally:
        gn.linearize = linearize
    r, pullback = gn.linearize(closure, flat)
    b = -pullback(r)
    assert torch.equal(-caught[0], b)
    assert torch.equal(caught[1], pullback(gn.jvp(closure, flat, b)))


@pytest.mark.gpu
@pytest.mark.parametrize("cg_segment", [0, 2], ids=["one-segment", "segments"])
@pytest.mark.parametrize("name", list(CARD_NETS))
def test_forward_launches_per_lm_iteration_on_the_card(cuda, name, cg_segment):
    """K7's (K5's) forward launches 2 k_chunks times per LM iteration, whatever
    cg_iters and cg_segment are; K8 (K6) once per chunk and CG iteration."""
    factory, kw = CARD_NETS[name]
    vn = VarNet(factory()["pde"], device=cuda, **kw)
    closure, flat = _lm_closure(vn, 4)
    state = _state(closure, flat)
    fwd, jvp = (vj.ff_vj_fwd, vj.ff_vj_jvp) if "ff" in name else (vj.vj_fwd, vj.vj_jvp)
    before = (fwd.launches, jvp.launches, vj.primal_fills, vj.primal_hits)
    gn.make_lm_step(closure, cg_iters=CG, cg_segment=cg_segment)(state)
    torch.cuda.synchronize()
    relinearized = -(-CG // cg_segment) - 1 if cg_segment else 0
    assert (fwd.launches - before[0], jvp.launches - before[1]) == (2 * 4, 4 * CG)
    assert (vj.primal_fills - before[2], vj.primal_hits - before[3]) == (
        4, 4 * (2 * CG + 1 + relinearized))
