"""Can the kernels run their hidden-layer products on the tensor cores?

``csrc/value_and_jac.cu`` (K5 forward and backward, K6) and ``csrc/dir_residual.cu``
(the K1/K4 forward and backward) compute the hidden layers' products -- K5 and K1/K4
forward: Z = S W^T; K5 backward and K1/K4 backward: recompute Z = S W^T, cotangents
G W, weight gradient G^T S; K6: Z = S W^T, DZ = DS W^T + S dW^T -- with
``mma.sync.m16n8k8 ... tf32`` in
3xTF32: each operand x is split into x_hi = cvt.rna.tf32(x) and x_lo = cvt.rna.tf32(x -
x_hi), and a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi.  Layer 0, the output layer
and the activations stay in f32 on the CUDA cores.

This file emulates that arithmetic on the CPU in the kernels' product order
(``mm_steps``): the contraction runs in k-steps of depth 8; an mma rounds its f32 sum
toward zero (the tensor core's own sum truncates); each k-step's three products go to a
fresh tile that is added to the running sum rounding to nearest.  On seeded numpy inputs
at the main path's widths (w48x2, w48x3, n_in 3) it holds each kernel against an f64
evaluation with the card gates (each gradient leaf / output row within 1e-4 of its max;
K5 forward 1e-5): 3xTF32 with the fresh-tile sum passes with room to spare, a single
TF32 pass does not, and neither does 3xTF32 with the running sum kept in the mma
accumulator (truncated at every k-step) where the sum is long: the weight gradients,
summed over every point.  The K1/K4 forward's r sums each test function's nq point
contributions as its second kernel does (``qsum``: 32 lanes, each summing every 32nd
point in order, then a shuffle tree), checked also at nq 1296.  The emulation sums each product exactly before it rounds
(a tf32 x tf32 product fits an f32 significand); the order of the tensor core's
internal sum is not modelled, which the headroom covers.

``csrc/ff_mlp.cu`` (K2-FF, K7; K3 and wide K4 share its two kernels) runs every layer
product on the tensor cores, layer 0's 256-deep sum against the Fourier embedding too:
its emulations (``ff_*``, F 128, w96x3 as the contaminant net) take W0's rows in the
kernel's slice order and sum the weight gradients tile by tile.  3xTF32 with fresh tiles
holds K2-FF's r gate (5e-5) and the 1e-4 gates with the same headroom, single TF32 does
not, and a truncating running sum loses the layer-0 sum itself
(``test_truncating_running_sum_loses_the_layer0_sum``).  K8 (``ff_jvp``) is emulated in
ff_jvp_kernel's order: the s panels in tile 0, their tangents in tile 1, dW's product
added onto tile 1's fresh tile after DS W's.
"""

import numpy as np
import pytest
import torch

from varnet_tpu_torch.ops import fused_residual as fr
from varnet_tpu_torch.ops import value_and_jac as vj
from varnet_tpu_torch.ops.fused_residual import _act_triple
from _torch_threads import _one_intra_op_thread  # noqa: F401


def _act_of_a(name):
    """The kernels' tanh / sigmoid helpers with act' and act'' as functions of the
    output a alone, as these emulations apply them."""
    act, act_p, act_pp = _act_triple(name)
    return act, (lambda a: act_p(None, a)), (lambda a, sp: act_pp(None, a, sp))


GATE = 1e-4         # the card gates of K5 bwd, K6 and the K1/K4 gradients
FWD_GATE = 1e-5     # K5 forward's
HEADROOM = 10.0     # 3xTF32 must stay below its gate / HEADROOM ...
FWD_HEADROOM = 2.0  # ... K5 forward's below FWD_GATE / 2: the f32 plain version itself
                    # sits 1.3-4.4e-6 from f64 on a row here (sigmoid's value row is a
                    # cancellation of its terms)
P = 6000
FF_R_GATE = 5e-5    # K2-FF r's card gate: raw-input angles of tens of radians


def tf32(x):
    """cvt.rna.tf32.f32: round an f32 to 10 mantissa bits, to nearest, ties away
    from zero (add half an ulp of tf32 to the magnitude bits, then truncate)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def rz(x):
    """f64 -> f32 rounding toward zero: an mma's f32 sum."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def mm_steps(a, b, split=True, fresh=True, also=None):
    """a @ b as the kernels' mma.sync k-steps: depth-8 slices of the contraction, each
    mma's sum rounded toward zero; ``split``: 3xTF32 (the small terms first), else a
    single TF32 product; ``fresh``: each k-step's products summed in a fresh tile and
    added to the running sum in f32 (round to nearest), else the running sum kept in
    the mma accumulator.  ``also``: a second product (a2, b2) of the same shapes added
    k-step by k-step after a @ b's, into the same fresh tile (K8's DS W + S dW)."""
    if b.shape[1] > 1024:   # column blocks: the same sums in bounded memory
        return torch.cat([mm_steps(a, b[:, j:j + 1024], split, fresh,
                                   None if also is None else (also[0], also[1][:, j:j + 1024]))
                          for j in range(0, b.shape[1], 1024)], dim=1)
    prods = []
    for x, y in [(a, b)] + ([] if also is None else [also]):
        x, y = x.float(), y.float()
        pad = -x.shape[1] % 8
        x = torch.nn.functional.pad(x, (0, pad))
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
        xh, yh = tf32(x), tf32(y)
        terms = [(tf32(x - xh), yh), (xh, tf32(y - yh)), (xh, yh)] if split else [(xh, yh)]
        steps = x.shape[1] // 8
        # the exact products of each k-step: [steps, M, N] per term
        prods += [torch.bmm(u.double().reshape(-1, steps, 8).transpose(0, 1),
                            v.double().reshape(steps, 8, -1)) for u, v in terms]
    acc = torch.zeros(a.shape[0], b.shape[1])
    if fresh:
        tile = torch.zeros_like(prods[0], dtype=torch.float32)
        for pr in prods:
            tile = rz(tile.double() + pr)
        for k in range(steps):
            acc = acc + tile[k]
    else:
        for k in range(steps):
            for pr in prods:
                acc = rz(acc.double() + pr[k])
    return acc


def mm_3xtf32(a, b, also=None):
    return mm_steps(a, b, also=also)


def mm_tf32(a, b, also=None):
    return mm_steps(a, b, split=False, also=also)


def mm_trunc(a, b, also=None):
    return mm_steps(a, b, fresh=False, also=also)


def mm_pair(mm):
    """a1 @ b1 + a2 @ b2 through ``mm``, the two products' k-steps sharing fresh tiles."""
    if mm is torch.matmul:
        return lambda a1, b1, a2, b2: a1 @ b1 + a2 @ b2
    return lambda a1, b1, a2, b2: mm(a1, b1, also=(a2, b2))


def bwd(params, xs, g, act_name, mm):
    """K5 backward as the kernel computes it: hidden-layer products through
    ``mm``, everything else in the tensors' own precision.  Parameters in the
    kernel's layout: wts[l] [out, in], bs[l] [out, 1]."""
    act, act_p, act_pp = _act_of_a(act_name)
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
    act, act_p, act_pp = _act_of_a(act_name)
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


def fwd(params, xs, act_name, mm):
    """K5 forward as the kernel computes it: the value and n_in jacobian panels stacked,
    the hidden-layer products through ``mm``."""
    act, act_p, _ = _act_of_a(act_name)
    wts = [layer["w"].T for layer in params]
    bs = [layer["b"][:, None] for layer in params]
    n, p = xs.shape
    a = act(wts[0] @ xs + bs[0])
    s = torch.cat([a] + [act_p(a) * wts[0][:, k:k + 1] for k in range(n)], dim=1)
    for wt, b in zip(wts[1:-1], bs[1:-1]):
        z = mm(wt, s)
        a = act(z[:, :p] + b)
        s = torch.cat([a, act_p(a).repeat(1, n) * z[:, p:]], dim=1)
    out = (wts[-1] @ s).reshape(1 + n, p)
    return torch.cat([out[:1] + bs[-1], out[1:]], dim=0)


def qsum(contrib, nq):
    """r [K], K = P // nq: each test function's nq contributions summed as the K1/K4
    forward's second kernel sums them: lane l of a warp adds q = l, l + 32, ... in order,
    then a shuffle tree adds lane l + off into lane l for off = 16, 8, 4, 2, 1."""
    k = contrib.shape[0] // nq
    c = torch.nn.functional.pad(contrib[:k * nq].reshape(k, nq), (0, -nq % 32))
    lanes = torch.zeros(k, 32, dtype=contrib.dtype)
    for step in c.reshape(k, -1, 32).unbind(dim=1):
        lanes = lanes + step
    for off in (16, 8, 4, 2, 1):
        lanes = torch.cat([lanes[:, :off] + lanes[:, off:2 * off], lanes[:, off:]], dim=1)
    return lanes[:, 0]


def dir_fwd(params, xs, c, csrc, cu, nq, act_name, mm):
    """The K1/K4 forward as the kernel computes it: layer 0 and the output row in the
    tensors' own precision, the stacked [a | t] through ``mm`` at each hidden layer, the
    point contributions w_out . t + csrc (+ cu (w_out . a + b_out), cu None: no
    reaction), then the test functions' sums (``qsum``)."""
    act, act_p, _ = _act_of_a(act_name)
    wts = [layer["w"].T for layer in params]
    bs = [layer["b"][:, None] for layer in params]
    p = xs.shape[1]
    a = act(wts[0] @ xs + bs[0])
    s = torch.cat([a, act_p(a) * (wts[0] @ c)], dim=1)
    for wt, b in zip(wts[1:-1], bs[1:-1]):
        z = mm(wt, s)
        a = act(z[:, :p] + b)
        s = torch.cat([a, act_p(a) * z[:, p:]], dim=1)
    out = (wts[-1] @ s)[0]
    contrib = out[p:] + csrc
    if cu is not None:
        contrib = contrib + cu * (out[:p] + bs[-1][0])
    return [qsum(contrib, nq)]


def dir_fwd_plain(params, xs, c, csrc, cu, nq, act_name):
    """The K1/K4 forward's plain version on the first P // nq test functions of nq points."""
    n = xs.shape[1] // nq * nq
    data = fr.CoeffData(xs=xs[:, :n], cdir=c[:, :n], csrc=csrc[:n],
                        cu=None if cu is None else cu[:n], k=n // nq, nq=nq)
    return [fr.dir_residual_fwd_plain(params, data, act_name)]


def dir_bwd(params, xs, c, g_tan, cu, act_name, mm):
    """The K1/K4 backward as the kernel computes it: two panels, the value a and the
    directional tangent t = act'(a) W c, stacked [a | t]; the output cotangents g_val =
    g_tan cu (zero without reaction: cu None) and g_tan per point; the hidden-layer
    products through ``mm``; the act'' term (act''/act') gj t."""
    act, act_p, _ = _act_of_a(act_name)
    ratio = (lambda a: -2.0 * a) if act_name == "tanh" else (lambda a: 1.0 - 2.0 * a)
    wts = [layer["w"].T for layer in params]
    bs = [layer["b"][:, None] for layer in params]
    p = xs.shape[1]
    lh = len(params) - 1
    a = act(wts[0] @ xs + bs[0])
    stacks = [torch.cat([a, act_p(a) * (wts[0] @ c)], dim=1)]
    for l in range(1, lh):
        z = mm(wts[l], stacks[-1])
        a = act(z[:, :p] + bs[l])
        stacks.append(torch.cat([a, act_p(a) * z[:, p:]], dim=1))
    g_val = g_tan * cu if cu is not None else torch.zeros_like(g_tan)
    go = torch.cat([g_val, g_tan])[None, :]
    d_wts, d_bs = [None] * (lh + 1), [None] * (lh + 1)
    d_wts[-1] = go @ stacks[-1].T
    d_bs[-1] = g_val.sum()[None, None]
    gs = wts[-1].T * go
    for l in range(lh - 1, -1, -1):
        a, t = stacks[l][:, :p], stacks[l][:, p:]
        sp = act_p(a)
        gz = sp * gs[:, :p] + ratio(a) * (gs[:, p:] * t)
        gp = sp * gs[:, p:]
        d_bs[l] = gz.sum(dim=1, keepdim=True)
        if l == 0:
            d_wts[0] = gz @ xs.T + gp @ c.T
        else:
            gzc = torch.cat([gz, gp], dim=1)
            d_wts[l] = mm(gzc, stacks[l - 1].T)
            gs = mm(wts[l].T, gzc)
    return [t for dw, db in zip(d_wts, d_bs) for t in (dw.T, db[:, 0])]


def dir_bwd_plain(params, xs, c, g_tan, cu, act_name):
    """The K1/K4 backward's plain version: precomputed coefficients, one point per
    test function (nq 1), so the cotangent is g_tan itself."""
    data = fr.CoeffData(xs=xs, cdir=c, csrc=torch.zeros_like(g_tan), cu=cu, k=xs.shape[1],
                        nq=1)
    return vj._leaves(fr.dir_residual_bwd_plain(params, data, act_name, g_tan))


# ---------------------------------------------------------------------------
# csrc/ff_mlp.cu's stacked kernels: the Fourier-feature net (F = 128 features, K = 256,
# w96x3) of K2-FF (FF_DIR: value and directional panels) and K7 (FF_UNIT: value and n_in
# unit panels).  Every layer product runs on the tensor cores, layer 0's too: its 256-deep
# sum takes W0's rows in the kernel's slice order (8 sin rows, then the same 8 features'
# cos rows), 32 k-steps of 8.  The weight gradients sum each tile's 128 stacked rows in
# k-steps from zero, then the tiles in order (one tile per block at this size).

FF_F, FF_WIDTHS, FF_P, FF_NQ = 128, (96, 96, 96), 1024, 16
FF_TILE_ROWS = 128     # the stacked rows of a tile: 4 warp pairs x 32


def ff_case(seed, dtype):
    """A seeded contaminant-like case: 2 pi B^T [F, 3] (scales 0.5 and 2), raw points in
    [0, 2] (angles of tens of radians), a w96x3 net behind [sin | cos], random tables
    (d 2 and time), the cotangents gr [K] and g [4, P].  The f64 case holds the f32
    case's values, so only the arithmetic differs."""
    rng = np.random.default_rng(100 + seed)
    n_in, d, k = 3, 2, FF_P // FF_NQ
    b = np.concatenate([0.5 * rng.standard_normal((n_in, FF_F - FF_F // 2)),
                        2.0 * rng.standard_normal((n_in, FF_F // 2))], axis=1)
    sizes = [2 * FF_F] + list(FF_WIDTHS) + [1]
    params = [{"w": np.sqrt(2.0 / (fi + fo)) * rng.standard_normal((fi, fo)),
               "b": 0.1 * rng.standard_normal(fo)} for fi, fo in zip(sizes[:-1], sizes[1:])]
    f32 = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)  # noqa: E731
    data = fr.ResidualData(
        xs=f32(rng.uniform(0.0, 2.0, (n_in, FF_P))),
        flds=f32(np.concatenate([1.0 + rng.uniform(size=(1, FF_P)),
                                 rng.standard_normal((d + 1, FF_P))])),
        tab=f32(np.concatenate([rng.uniform(size=(FF_NQ, 2)),
                                rng.standard_normal((FF_NQ, d))], axis=1)),
        scale=f32(1.0 + rng.uniform(size=n_in)), k=k, nq=FF_NQ, d=d, td=True,
        has_react=False, bt=f32((2 * np.pi) * b.T))
    return ([{key: f32(v) for key, v in layer.items()} for layer in params], data,
            f32(rng.standard_normal(k)), f32(rng.standard_normal((1 + n_in, FF_P))))


def ff_embed_rows():
    """W0's rows (and the embedding's) in the kernel's k order: slice j of 16 holds the
    sin rows 8 j.. 8 j + 7, then the cos rows F + 8 j.. F + 8 j + 7."""
    j = torch.arange(FF_F).reshape(-1, 8)
    return torch.cat([j, FF_F + j], dim=1).reshape(-1)


def ff_embed_panels(data, dirs):
    """The embedding's value and tangent panels [2F, np P] (pc = bt . v in the JAX
    kernels' order)."""
    ang = fr._small_k(data.bt, data.xs)
    sn, cs = torch.sin(ang), torch.cos(ang)
    panels = [torch.cat([sn, cs])]
    for v in dirs:
        pc = fr._small_k(data.bt, v)
        panels.append(torch.cat([cs * pc, -sn * pc]))
    return torch.cat(panels, dim=1)


def ff_stacks(params, data, dirs, act_name, mm):
    """The stacked forward as the kernels compute it: S_0 = the embedding's value and
    tangent panels [2F, np P] (pc = bt . v in the JAX kernels' order), layer 0 through
    ``mm`` over W0's rows in the kernel's order, then each hidden layer; per layer the
    slot [a | J_1 .. J_{np-1}] [H, np P].  Returns (S_0, slots)."""
    act, act_p, _ = _act_of_a(act_name)
    wts = [layer["w"].T for layer in params]
    bs = [layer["b"][:, None] for layer in params]
    p = data.xs.shape[1]
    s0 = ff_embed_panels(data, dirs)
    rows = ff_embed_rows()
    s, slots = s0, []
    for l, (wt, b) in enumerate(zip(wts[:-1], bs[:-1])):
        z = mm(wt[:, rows], s[rows]) if l == 0 else mm(wt, s)
        a = act(z[:, :p] + b)
        s = torch.cat([a, act_p(a).repeat(1, len(dirs)) * z[:, p:]], dim=1)
        slots.append(s)
    return s0, slots


def ff_outputs(params, slot, n_panels):
    """The output row of every panel: (u, du_1, ..) [n_panels, P], in the tensors' own
    precision (the kernels' four-chain dot products on the CUDA cores)."""
    out = (params[-1]["w"].T @ slot).reshape(n_panels, -1)
    return torch.cat([out[:1] + params[-1]["b"], out[1:]])


def ff_tile_order(p, n_panels):
    """The stacked rows of the kernels' tiles: groups of 32 rows, G = 32 / npad points
    with their panels (panel-major), 4 groups a tile; padded panels are zero rows and add
    nothing, so they are left out.  An index into the [np P] panel-major columns."""
    npad = 2 if n_panels <= 2 else 4
    g = 32 // npad
    idx = torch.arange(p).reshape(-1, g)                         # [groups, G]
    cols = torch.stack([idx + m * p for m in range(n_panels)], dim=1)
    return cols.reshape(-1)


def ff_mm_tiles(a, b, order, mm):
    """a [M, R] @ b [R, N] over the R stacked rows as the backward sums dW: each tile's
    FF_TILE_ROWS rows (in ``order``) through ``mm`` from zero, then the tiles added in
    order, in f32."""
    total = None
    for t in range(0, len(order), FF_TILE_ROWS):
        cols = order[t:t + FF_TILE_ROWS]
        part = mm(a[:, cols], b[cols])
        total = part if total is None else total + part
    return total


def ff_bwd(params, data, dirs, go, act_name, mm):
    """The stacked backward as the kernels compute it: recompute (``ff_stacks``), the top
    epilogue from G = w_out go, going down dW_l over the tiles' rows (``ff_mm_tiles``),
    the cotangents G_{l-1} = [gz | gp]_l W_l^T through ``mm``, the epilogue gz = act' ga
    + (act''/act') sum_m gj_m J_m, gp_m = act' gj_m; dW_0 against the embedding's
    panels.  go [np, P]: the output cotangent of every panel."""
    act, act_p, _ = _act_of_a(act_name)
    ratio = (lambda a: -2.0 * a) if act_name == "tanh" else (lambda a: 1.0 - 2.0 * a)
    wts = [layer["w"].T for layer in params]
    n_panels, p = go.shape
    order = ff_tile_order(p, n_panels)
    s0, slots = ff_stacks(params, data, dirs, act_name, mm)
    lh = len(params) - 1
    gor = go.reshape(1, -1)                                       # [1, np P]
    d_wts, d_bs = [None] * (lh + 1), [None] * (lh + 1)
    d_wts[-1] = gor @ slots[-1].T
    d_bs[-1] = go[0].sum()[None, None]
    g = wts[-1].T * gor                                           # [H, np P]
    for l in range(lh - 1, -1, -1):
        a, js = slots[l][:, :p], slots[l][:, p:]
        sp = act_p(a)
        gj = g[:, p:]
        acc = sum(gj[:, m * p:(m + 1) * p] * js[:, m * p:(m + 1) * p]
                  for m in range(n_panels - 1))
        gz = sp * g[:, :p] + ratio(a) * acc
        gzc = torch.cat([gz, sp.repeat(1, n_panels - 1) * gj], dim=1)
        d_bs[l] = gz.sum(dim=1, keepdim=True)
        s_in = s0 if l == 0 else slots[l - 1]
        d_wts[l] = ff_mm_tiles(gzc, s_in.T, order, mm)
        if l > 0:
            g = mm(wts[l].T, gzc)
    return [t for dw, db in zip(d_wts, d_bs) for t in (dw.T, db[:, 0])]


def ff_jvp(params, data, tangent, act_name, mm):
    """K8 as ff_jvp_kernel computes it: tile 0 the s panels (value and unit tangents of
    the embedding), tile 1 their parameter tangents ds; layer 0 S W0 and S dW0 (each its
    own fresh tiles), each hidden layer S W and DS W + S dW (the two sharing a k-step's
    fresh tile), W0's rows in the kernel's slice order; the epilogue and the output rows
    dW_out s + w_out ds in the tensors' own precision."""
    act, act_p, act_pp = _act_of_a(act_name)
    wts = [layer["w"].T for layer in params]
    bs = [layer["b"][:, None] for layer in params]
    dwts = [layer["w"].T for layer in tangent]
    dbs = [layer["b"][:, None] for layer in tangent]
    n, p = data.xs.shape
    s0 = ff_embed_panels(data, ff_unit_dirs(data))
    rows = ff_embed_rows()
    s = ds = None
    for l, (wt, b, dwt, db) in enumerate(zip(wts[:-1], bs[:-1], dwts[:-1], dbs[:-1])):
        if l == 0:
            zc, dzc = mm(wt[:, rows], s0[rows]), mm(dwt[:, rows], s0[rows])
        else:
            zc, dzc = mm(wt, s), mm_pair(mm)(wt, ds, dwt, s)
        a = act(zc[:, :p] + b)
        dz = dzc[:, :p] + db
        sp = act_p(a)
        dsp = act_pp(a, sp) * dz
        s = torch.cat([a, sp.repeat(1, n) * zc[:, p:]], dim=1)
        ds = torch.cat([sp * dz, dsp.repeat(1, n) * zc[:, p:] + sp.repeat(1, n) * dzc[:, p:]],
                       dim=1)
    doc = (dwts[-1] @ s + wts[-1] @ ds).reshape(1 + n, p)
    return list(torch.cat([doc[:1] + dbs[-1], doc[1:]], dim=0))


def ff_tangent(params, seed):
    """A seeded parameter tangent of every leaf, in the parameters' dtype (f32 values)."""
    rng = np.random.default_rng(200 + seed)
    return [{k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
             .to(v.dtype) for k, v in layer.items()} for layer in params]


def ff_unit_dirs(data):
    eye = torch.eye(data.xs.shape[0], dtype=data.xs.dtype)
    return [eye[:, j:j + 1].expand_as(data.xs) for j in range(data.xs.shape[0])]


def ff_kernel(kind, act_name):
    """(emulation, plain version) of ``kind`` on the seeded ff case of a fixture param
    (its depth picks the seed): K2-FF forward (r, summed per test function as
    vr_qsum_kernel does) and backward, K7 forward ([u, du]) and backward, K8."""
    def emul(p, t, x, g, c, gt, cu, cs, mm):
        params, data, gr, gu = ff_case(len(p), x.dtype)
        if kind == "dir_fwd":
            c, _, csrc = fr._dir_coeffs(data)
            out = ff_outputs(params, ff_stacks(params, data, [c], act_name, mm)[1][-1], 2)
            return [qsum(out[1] + csrc, data.nq)]
        if kind == "dir_bwd":
            c = fr._dir_coeffs(data)[0]
            g_tan = gr.repeat_interleave(data.nq)
            return ff_bwd(params, data, [c], torch.stack([torch.zeros_like(g_tan), g_tan]),
                          act_name, mm)
        if kind == "unit_jvp":
            return ff_jvp(params, data, ff_tangent(params, len(p)), act_name, mm)
        dirs = ff_unit_dirs(data)
        if kind == "unit_fwd":
            return list(ff_outputs(params, ff_stacks(params, data, dirs, act_name, mm)[1][-1],
                                   1 + len(dirs)))
        return ff_bwd(params, data, dirs, gu, act_name, mm)

    def plain(p, t, x, g, c, gt, cu, cs):
        params, data, gr, gu = ff_case(len(p), x.dtype)
        if kind == "dir_fwd":
            return [fr.dir_residual_fwd_plain(params, data, act_name)]
        if kind == "dir_bwd":
            return vj._leaves(fr.dir_residual_bwd_plain(params, data, act_name, gr))
        if kind == "unit_fwd":
            return list(vj.ff_vj_fwd_plain(params, data.xs, data.bt, act_name))
        if kind == "unit_jvp":
            return list(vj.ff_vj_jvp_plain(params, data.xs, data.bt, act_name,
                                           ff_tangent(params, len(p))))
        return vj._leaves(vj.ff_vj_bwd_plain(params, data.xs, data.bt, act_name, gu))

    return emul, plain


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


def _dir_case(n_in=3, seed=1):
    """The directional residual's per-point data: a direction c (a weighted velocity /
    diffusion / time row per input), the tangent cotangent g_tan, the reaction
    coefficient cu and the source term csrc."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_in, P)), rng.standard_normal(P),
            rng.uniform(0.0, 2.0, P), 0.1 * rng.standard_normal(P))


def _as(tree, dtype):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(dtype)
    return [{k: torch.from_numpy(v).to(dtype) for k, v in layer.items()} for layer in tree]


def _worst(got, ref):
    return max(float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(got, ref))


# kernel -> (its emulation (params, tangent, xs, g, c, g_tan, cu, csrc, mm), its plain
# version (the same without mm), its card gate, the headroom 3xTF32 keeps below it)
DIR_CASES = [(act, react) for act in ("tanh", "sigmoid") for react in (False, True)]
DIR_NQ = 60     # points per test function of the K1/K4 forward cases: K = P / 60 = 100
KERNELS = {
    "bwd": (lambda p, t, x, g, c, gt, cu, cs, mm: bwd(p, x, g, "tanh", mm), None, GATE,
            HEADROOM),
    "jvp": (lambda p, t, x, g, c, gt, cu, cs, mm: jvp(p, x, t, "tanh", mm), None, GATE,
            HEADROOM),
    **{f"fwd-{act}": (
        (lambda act: lambda p, t, x, g, c, gt, cu, cs, mm: fwd(p, x, act, mm))(act),
        (lambda act: lambda p, t, x, g, c, gt, cu, cs: vj.vj_fwd_plain(p, x, act))(act),
        FWD_GATE, FWD_HEADROOM) for act in ("tanh", "sigmoid")},
    **{f"dir_bwd-{act}{'-react' if react else ''}": (
        (lambda act, react: lambda p, t, x, g, c, gt, cu, cs, mm:
         dir_bwd(p, x, c, gt, cu if react else None, act, mm))(act, react),
        (lambda act, react: lambda p, t, x, g, c, gt, cu, cs:
         dir_bwd_plain(p, x, c, gt, cu if react else None, act))(act, react),
        GATE, HEADROOM) for act, react in DIR_CASES},
    # the K1/K4 forward; "-nq1296": 4 test functions of 1296 points, a count the sum's
    # 32-lane stride does not divide (1296 = 40 x 32 + 16)
    **{f"dir_fwd-{act}{'-react' if react else ''}{'-nq1296' if nq == 1296 else ''}": (
        (lambda act, react, nq: lambda p, t, x, g, c, gt, cu, cs, mm:
         dir_fwd(p, x, c, cs, cu if react else None, nq, act, mm))(act, react, nq),
        (lambda act, react, nq: lambda p, t, x, g, c, gt, cu, cs:
         dir_fwd_plain(p, x, c, cs, cu if react else None, nq, act))(act, react, nq),
        FWD_GATE, FWD_HEADROOM)
       for act, react, nq in [(a, r, DIR_NQ) for a, r in DIR_CASES] + [("tanh", False, 1296)]},
    # csrc/ff_mlp.cu at F 128, w96x3: K2-FF r (5e-5) and gradients, K7 rows and gradients,
    # K8 rows
    **{f"ff_{kind}-{act}": (*ff_kernel(kind, act), gate, room)
       for kind, gate, room in (("dir_fwd", FF_R_GATE, HEADROOM), ("dir_bwd", GATE, HEADROOM),
                                ("unit_fwd", GATE, HEADROOM), ("unit_bwd", GATE, HEADROOM),
                                ("unit_jvp", GATE, HEADROOM))
       for act in ("tanh", "sigmoid")},
}
MODES = (("f32", torch.matmul), ("3xtf32", mm_3xtf32), ("tf32", mm_tf32), ("trunc", mm_trunc))
LONG_SUMS = ["bwd"] + [k for k in KERNELS if k.startswith("dir_bwd")]  # G^T S over all points


@pytest.fixture(scope="module", params=[(48, 48), (48, 48, 48)], ids=["w48x2", "w48x3"])
def errors(request):
    params, tangent, xs, g = _case(request.param)
    c, g_tan, cu, csrc = _dir_case()
    f32 = [_as(t, torch.float32) for t in (params, tangent, xs, g, c, g_tan, cu, csrc)]
    f64 = [_as(t, torch.float64) for t in (params, tangent, xs, g, c, g_tan, cu, csrc)]
    out = {}
    for name, (fn, _, gate, room) in KERNELS.items():
        ref = fn(*f64, torch.matmul)
        out[name] = {mode: _worst(fn(*f32, mm), ref) for mode, mm in MODES}
        out[name].update(gate=gate, room=room)
    return out


@pytest.mark.parametrize("kernel", [k for k in KERNELS if KERNELS[k][1] is not None])
def test_new_emulations_are_the_plain_versions(kernel):
    """The K5 forward and K1/K4 forward and backward emulations' arithmetic, in f64 with
    exact products, is the plain versions'."""
    params, tangent, xs, g = (_as(t, torch.float64) for t in _case((20, 24, 16)))
    c, g_tan, cu, csrc = (_as(t, torch.float64) for t in _dir_case())
    fn, plain = KERNELS[kernel][:2]
    args = (params, tangent, xs, g, c, g_tan, cu, csrc)
    assert _worst(fn(*args, torch.matmul), plain(*args)) < 1e-12


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


def test_mma_sum_rounds_toward_zero():
    big = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 3.0], dtype=torch.float64)
    assert rz(big).tolist() == [1.0, -1.0, 3.0]
    a = torch.ones(1, 16)
    b = torch.full((16, 1), 1.0 + 2.0 ** -20)   # not a tf32 value: the lo terms carry it
    assert mm_3xtf32(a, b).item() == pytest.approx(16 * (1.0 + 2.0 ** -20), rel=1e-7)
    assert mm_tf32(a, b).item() == 16.0


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_3xtf32_holds_the_card_gate(errors, kernel):
    e = errors[kernel]
    assert e["3xtf32"] < e["gate"] / e["room"], e
    # within a small factor of plain f32's own distance from f64
    assert e["3xtf32"] < 20 * max(e["f32"], 1e-7), e


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_single_tf32_breaks_the_card_gate(errors, kernel):
    assert errors[kernel]["tf32"] > errors[kernel]["gate"], errors[kernel]


@pytest.mark.parametrize("kernel", LONG_SUMS)
def test_truncating_running_sum_loses_the_long_sums(errors, kernel):
    """3xTF32 whose running sum stays in the mma accumulator, truncated at every k-step:
    the weight gradient sums (1 + n) P rows (K5) or 2 P rows (K1/K4), and the truncation
    biases that sum.  Here that puts K5 backward past the gate (1.4e-4-3.4e-4) and the
    K1/K4 gradients at 3e-5-1.1e-4 of it, 14-50x farther from f64 than the fresh-tile sum.
    (The forward and the JVP only sum H deep: there it costs ~1e-6.)"""
    e = errors[kernel]
    assert e["trunc"] > HEADROOM * e["3xtf32"], e
    if kernel == "bwd":
        assert e["trunc"] > e["gate"], e


@pytest.mark.parametrize("seed", [2, 3])
def test_truncating_running_sum_loses_the_layer0_sum(seed):
    """Layer 0 of the ff kernels sums 256 deep (32 k-steps of three mma each).  On the
    same f32 inputs against f64, a running sum kept in the truncating mma accumulator
    errs 11x as much as the fresh-tile sum (rms; 7x at the max) and 6x as much as plain
    f32 (rms): the fresh tiles keep the layer-0 sum at f32's own rounding or better.
    (Through the layers and the output rows the other f32 roundings come on top: there
    the truncating sum is 1.1-2.2x farther from f64, inside the gates.)"""
    params, data, _, _ = ff_case(seed, torch.float32)
    s0, _ = ff_stacks(params, data, ff_unit_dirs(data), "tanh", torch.matmul)
    rows = ff_embed_rows()
    w, e = params[0]["w"].T[:, rows], s0[rows]
    ref = w.double() @ e.double()
    err = {}
    for mode, mm in MODES:
        rel = (mm(w, e).double() - ref) / ref.abs().amax(dim=1, keepdim=True)
        err[mode] = (float(rel.pow(2).mean().sqrt()), float(rel.abs().max()))
    assert err["trunc"][0] > 5 * err["3xtf32"][0] and err["trunc"][1] > 5 * err["3xtf32"][1], err
    assert err["trunc"][0] > 3 * err["f32"][0], err
    assert err["3xtf32"][0] < err["f32"][0], err
