"""Can K5's backward and K6 run their hidden-layer products on the tensor cores?

``csrc/value_and_jac.cu`` computes the hidden layers' products of K5 backward
(forward recompute Z = S W^T, cotangents G W, weight gradient G^T S) and K6
(Z = S W^T, DZ = DS W^T + S dW^T) with ``mma.sync ... tf32`` in 3xTF32: each
operand x is split into x_hi = cvt.rna.tf32(x) and x_lo = cvt.rna.tf32(x - x_hi),
and a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi, summed in f32.  Layer 0,
the output layer and the activations stay in f32 on the CUDA cores.

This file emulates that arithmetic on the CPU, on seeded numpy inputs at the
main path's widths (w48x2, w48x3, n_in 3), and holds it against an f64
evaluation with the card tests' gates (each gradient leaf / output row within
1e-4 of its max): 3xTF32 passes with room to spare, a single TF32 pass does not.
The emulation rounds each product exactly (a tf32 x tf32 product fits an f32
significand) and sums in f32 matmuls; the tensor core's own summation order is
not modelled, which the headroom covers.
"""

import numpy as np
import pytest
import torch

from varnet_tpu_torch.ops import value_and_jac as vj
from varnet_tpu_torch.ops.fused_residual import _act_triple

GATE = 1e-4         # the card tests' K5 bwd / K6 gate
HEADROOM = 10.0     # 3xTF32 must stay below GATE / HEADROOM
P = 6000


def tf32(x):
    """cvt.rna.tf32.f32: round an f32 to 10 mantissa bits, to nearest, ties away
    from zero (add half an ulp of tf32 to the magnitude bits, then truncate)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def bwd(params, xs, g, act_name, mm):
    """K5 backward as the kernel computes it: hidden-layer products through
    ``mm``, everything else in the tensors' own precision.  Parameters in the
    kernel's layout: wts[l] [out, in], bs[l] [out, 1]."""
    act, act_p, act_pp = _act_triple(act_name)
    wts = [layer["w"].T for layer in params]
    bs = [layer["b"][:, None] for layer in params]
    n, p = xs.shape
    lh = len(params) - 1
    a = act(wts[0] @ xs + bs[0])
    acts, pres = [a], [None]
    stacks = []             # S_l = [a_l | J_l^1 .. J_l^n], [H, (1 + n) P]

    def stack(l):
        sp = act_p(acts[l])
        cols = [wts[0][:, k:k + 1] for k in range(n)] if l == 0 else \
            [pres[l][:, k * p:(k + 1) * p] for k in range(n)]
        return torch.cat([acts[l]] + [sp * c for c in cols], dim=1)

    for l in range(1, lh):
        stacks.append(stack(l - 1))
        z = mm(wts[l], stacks[-1])
        acts.append(act(z[:, :p] + bs[l]))
        pres.append(z[:, p:])
    top = stack(lh - 1)
    d_wts, d_bs = [None] * (lh + 1), [None] * (lh + 1)
    d_wts[-1] = sum(g[k:k + 1] @ top[:, k * p:(k + 1) * p].T for k in range(1 + n))
    d_bs[-1] = g[0:1].sum(dim=1, keepdim=True)
    gs = torch.cat([wts[-1].T * g[k:k + 1] for k in range(1 + n)], dim=1)
    for l in range(lh - 1, -1, -1):
        sp = act_p(acts[l])
        spp = act_pp(acts[l], sp)
        pre = [wts[0][:, k:k + 1] if l == 0 else pres[l][:, k * p:(k + 1) * p]
               for k in range(n)]
        acc = sum(gs[:, (1 + k) * p:(2 + k) * p] * pre[k] for k in range(n))
        gz = sp * gs[:, :p] + spp * acc
        gp = sp.repeat(1, n) * gs[:, p:]
        d_bs[l] = gz.sum(dim=1, keepdim=True)
        if l == 0:
            d_wts[0] = gz @ xs.T + gp.reshape(-1, n, p).sum(dim=2)
        else:
            gzc = torch.cat([gz, gp], dim=1)
            d_wts[l] = mm(gzc, stacks[l - 1].T)
            gs = mm(wts[l].T, gzc)
    return [t for dw, db in zip(d_wts, d_bs) for t in (dw.T, db[:, 0])]


def jvp(params, xs, tangent, act_name, mm):
    """K6 as the kernel computes it (``mm`` for the hidden layers' products)."""
    act, act_p, act_pp = _act_triple(act_name)
    wts = [layer["w"].T for layer in params]
    bs = [layer["b"][:, None] for layer in params]
    dwts = [layer["w"].T for layer in tangent]
    dbs = [layer["b"][:, None] for layer in tangent]
    n, p = xs.shape
    z, dz = wts[0] @ xs + bs[0], dwts[0] @ xs + dbs[0]
    a = act(z)
    sp = act_p(a)
    dsp = act_pp(a, sp) * dz
    s = torch.cat([a] + [sp * wts[0][:, k:k + 1] for k in range(n)], dim=1)
    ds = torch.cat([sp * dz] + [dsp * wts[0][:, k:k + 1] + sp * dwts[0][:, k:k + 1]
                                for k in range(n)], dim=1)
    for wt, b, dwt, db in zip(wts[1:-1], bs[1:-1], dwts[1:-1], dbs[1:-1]):
        zc = mm(wt, s)
        dzc = mm(wt, ds) + mm(dwt, s)
        a = act(zc[:, :p] + b)
        dz = dzc[:, :p] + db
        sp = act_p(a)
        dsp = act_pp(a, sp) * dz
        s = torch.cat([a, sp.repeat(1, n) * zc[:, p:]], dim=1)
        ds = torch.cat([sp * dz, dsp.repeat(1, n) * zc[:, p:] + sp.repeat(1, n) * dzc[:, p:]],
                       dim=1)
    doc = (dwts[-1] @ s + wts[-1] @ ds).reshape(1 + n, p)
    return torch.cat([doc[:1] + dbs[-1], doc[1:]], dim=0)


def _case(widths, n_in=3, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [n_in] + list(widths) + [1]
    params, tangent = [], []
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        std = np.sqrt(2.0 / (fi + fo))
        params.append({"w": std * rng.standard_normal((fi, fo)),
                       "b": 0.1 * rng.standard_normal(fo)})
        tangent.append({"w": rng.standard_normal((fi, fo)), "b": rng.standard_normal(fo)})
    xs = rng.uniform(-1.0, 1.0, (n_in, P))
    g = rng.standard_normal((1 + n_in, P))
    return params, tangent, xs, g


def _as(tree, dtype):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(dtype)
    return [{k: torch.from_numpy(v).to(dtype) for k, v in layer.items()} for layer in tree]


def _worst(got, ref):
    return max(float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(got, ref))


@pytest.fixture(scope="module", params=[(48, 48), (48, 48, 48)], ids=["w48x2", "w48x3"])
def errors(request):
    params, tangent, xs, g = _case(request.param)
    f32 = [_as(t, torch.float32) for t in (params, tangent, xs, g)]
    f64 = [_as(t, torch.float64) for t in (params, tangent, xs, g)]
    out = {}
    for name, fn in (("bwd", lambda p, t, x, gg, mm: bwd(p, x, gg, "tanh", mm)),
                     ("jvp", lambda p, t, x, gg, mm: jvp(p, x, t, "tanh", mm))):
        ref = fn(*f64, torch.matmul)
        out[name] = {mode: _worst(fn(*f32, mm), ref)
                     for mode, mm in (("f32", torch.matmul), ("3xtf32", mm_3xtf32),
                                      ("tf32", mm_tf32))}
        out[name]["ref"] = ref
    out["f64"] = f64
    return out


def test_emulated_arithmetic_is_the_plain_versions():
    """The emulation's arithmetic, in f64 with exact products, is K5 bwd's and
    K6's plain versions."""
    params, tangent, xs, g = (_as(t, torch.float64) for t in _case((20, 24, 16)))
    got = bwd(params, xs, g, "sigmoid", torch.matmul)
    ref = vj._leaves(vj.vj_bwd_plain(params, xs, "sigmoid", g))
    assert _worst(got, ref) < 1e-12
    assert _worst(jvp(params, xs, tangent, "sigmoid", torch.matmul),
                  vj.vj_jvp_plain(params, xs, "sigmoid", tangent)) < 1e-12


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                      # a tf32 value: unchanged
    tie = 1.0 + 2.0 ** -11                      # halfway between 1 and 1 + 2^-10
    x = torch.tensor([one, tie, -tie, 1.0 + 2.0 ** -12, 3.0e-39], dtype=torch.float32)
    assert tf32(x).tolist() == [one, one, -one, 1.0, float(tf32(x)[4])]
    assert float(tf32(x)[4]) == pytest.approx(3.0e-39, rel=2.0 ** -10)


@pytest.mark.parametrize("kernel", ["bwd", "jvp"])
def test_3xtf32_holds_the_card_gate(errors, kernel):
    e = errors[kernel]
    assert e["3xtf32"] < GATE / HEADROOM, e
    # within a small factor of plain f32's own distance from f64
    assert e["3xtf32"] < 20 * max(e["f32"], 1e-7), e


@pytest.mark.parametrize("kernel", ["bwd", "jvp"])
def test_single_tf32_breaks_the_card_gate(errors, kernel):
    assert errors[kernel]["tf32"] > GATE, errors[kernel]
