"""MLP value + input jacobian with parameter backward and parameter-tangent JVP:
plain PyTorch versions + Hopper CUDA kernels.

Counterpart of the JAX package's ``ops/pallas_mlp.py`` K5 (``_fwd_pallas`` /
``_bwd_pallas``, wrapped by ``_fused_fn`` and ``pallas_value_and_jac``) and K6
(``_jvp_pallas``, wrapped by ``_fused_fn_jvp`` and ``pallas_value_and_jac_jvp``).
On the scaled points xs_t [n_in, P]:

* ``vj_fwd``:  out [1 + n_in, P] = (u, du/dxs);
* ``vj_bwd``:  parameter gradients of <g, out> for a cotangent g [1 + n_in, P];
* ``vj_jvp``:  dout [1 + n_in, P], the tangent of out along a parameter tangent.

Each dispatches on the device of xs_t: CPU tensors take the plain version
(``*_plain``), CUDA tensors launch the kernel of ``csrc/value_and_jac.cu`` (or
raise); each counts its kernel launches in ``.launches``.  ``ValueAndJacFn``
carries both differentiation rules (``backward`` -> K5 backward, ``jvp`` -> K6),
so reverse and forward mode go through one function where JAX needed two
wrapped twins; ``value_and_jac`` is the drop-in for ``mlp_value_and_jac``.
Its ``primal=`` (a :class:`PrimalSlot`) keeps the forward's out for later calls
at the same parameters and points, whose forward then launches nothing: an LM
iteration's J v and J^T w reuse the linearization's (``train/gauss_newton.py``);
``primal_fills`` / ``primal_hits`` count the evaluations that filled / read one.

The Fourier-feature twins (``pallas_ff_value_and_jac`` / ``_jvp``: K7 forward
and backward, K8) are ``ff_vj_fwd`` / ``ff_vj_bwd`` / ``ff_vj_jvp`` with the
fixed bt = 2 pi B^T [F, n_in], kernels in ``csrc/ff_mlp.cu``, the Function
``FfValueAndJacFn`` and the drop-in ``ff_value_and_jac`` for
``models.mlp.ff_value_and_jac``.  Coordinates (and B) are fixed data: no gradient
or tangent flows to them.  With ``bt`` None the K7 / K8 kernels run a plain net
(layer 0 reads the coordinates): on CUDA ``value_and_jac`` sends a net wider than
K5 / K6 take (hidden width 65..256) through them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..models import mlp as _mlp
from ..models.mlp import mlp_value_and_jac
from . import build
from . import fused_residual as fr
from .fused_residual import ACTIVATIONS, MAX_HIDDEN, _act_triple, _offsets, padded_width

MAX_IN = 4   # the kernels take n_in <= 4 (W0 is stored padded to 4 columns)


def _wt_layout(params):
    return [layer["w"].T for layer in params], [layer["b"][:, None] for layer in params]


# ---------------------------------------------------------------------------
# plain PyTorch versions (the math of the Pallas kernels)


def vj_fwd_plain(params, xs_t, activation: str = "tanh"):
    """out [1 + n_in, P] by ``mlp_value_and_jac`` on the scaled points."""
    u, du = mlp_value_and_jac(params, xs_t.T, activation)
    return torch.cat([u[None, :], du.T], dim=0)


def _packed_forward(wts, bs, xs_t, activation):
    """The panel-packed forward of ``_bwd_kernel``: per hidden layer the
    pre-activation z_l, the activation a_l, the panels s_l = [a_l | J_l^1 ..
    J_l^n] [H, (1+n) P] and the tangent pre-activations P_l^j (None for layer
    0: the W_0 column)."""
    act, act_p, _ = _act_triple(activation)
    n_in, p = xs_t.shape
    z = wts[0] @ xs_t + bs[0]
    a = act(z)
    sp = act_p(z, a)
    zs, acts, pres = [z], [a], [None]
    s_packed = [torch.cat([a] + [sp * wts[0][:, j:j + 1] for j in range(n_in)], dim=1)]
    for wt, b in zip(wts[1:-1], bs[1:-1]):
        zc = wt @ s_packed[-1]
        z = zc[:, :p] + b
        a = act(z)
        sp = act_p(z, a)
        zs.append(z)
        acts.append(a)
        pres.append(zc[:, p:])
        s_packed.append(torch.cat([a, sp.repeat(1, n_in) * zc[:, p:]], dim=1))
    return zs, acts, pres, s_packed


def vj_bwd_plain(params, xs_t, activation: str, g):
    """Closed-form parameter gradients of <g, out> for g [1 + n_in, P]: a list
    of ``{'w', 'b'}`` in the parameters' layout.  Mirrors ``_bwd_kernel`` and
    ``_packed_bwd_tail``, with the act'' term gz = sp ga + spp sum_j gJ_j P_l^j."""
    _, act_p, act_pp = _act_triple(activation)
    wts, bs = _wt_layout(params)
    n_in, p = xs_t.shape
    zs, acts, pres, s_packed = _packed_forward(wts, bs, xs_t, activation)
    n = len(params)
    d_wts, d_bs = [None] * n, [None] * n
    d_wts[-1] = sum(g[j:j + 1] @ s_packed[-1][:, j * p:(j + 1) * p].T for j in range(1 + n_in))
    d_bs[-1] = g[0:1].sum(dim=1, keepdim=True)
    g_s = torch.cat([wts[-1].T * g[j:j + 1] for j in range(1 + n_in)], dim=1)
    for l in range(n - 2, -1, -1):
        sp = act_p(zs[l], acts[l])
        spp = act_pp(zs[l], acts[l], sp)
        ga, g_jac = g_s[:, :p], g_s[:, p:]
        acc = sum(g_jac[:, j * p:(j + 1) * p]
                  * (wts[0][:, j:j + 1] if l == 0 else pres[l][:, j * p:(j + 1) * p])
                  for j in range(n_in))
        gz = sp * ga + spp * acc
        g_p = sp.repeat(1, n_in) * g_jac
        d_bs[l] = gz.sum(dim=1, keepdim=True)
        if l == 0:
            d_wts[0] = gz @ xs_t.T + g_p.reshape(-1, n_in, p).sum(dim=2)
        else:
            g_zc = torch.cat([gz, g_p], dim=1)
            d_wts[l] = g_zc @ s_packed[l - 1].T
            g_s = wts[l].T @ g_zc
    return [{"w": dw.T, "b": db[:, 0]} for dw, db in zip(d_wts, d_bs)]


def vj_jvp_plain(params, xs_t, activation: str, tangent):
    """dout [1 + n_in, P] along the parameter tangent ``tangent`` (same layout
    as ``params``).  Mirrors ``_jvp_kernel`` and ``_jvp_tail``."""
    act, act_p, act_pp = _act_triple(activation)
    wts, bs = _wt_layout(params)
    dwts, dbs = _wt_layout(tangent)
    n_in, p = xs_t.shape
    z = wts[0] @ xs_t + bs[0]
    dz = dwts[0] @ xs_t + dbs[0]
    a = act(z)
    sp = act_p(z, a)
    dsp = act_pp(z, a, sp) * dz
    s = torch.cat([a] + [sp * wts[0][:, j:j + 1] for j in range(n_in)], dim=1)
    ds = torch.cat([sp * dz] + [dsp * wts[0][:, j:j + 1] + sp * dwts[0][:, j:j + 1]
                                for j in range(n_in)], dim=1)
    return _jvp_tail(wts, bs, dwts, dbs, s, ds, n_in, p, activation)


def _jvp_tail(wts, bs, dwts, dbs, s, ds, n_in, p, activation):
    """Hidden and output layers of the parameter-tangent JVP from layer 0's
    packed state (s, ds) [H, (1 + n) P] (``_jvp_tail``)."""
    act, act_p, act_pp = _act_triple(activation)
    for wt, b, dwt, db in zip(wts[1:-1], bs[1:-1], dwts[1:-1], dbs[1:-1]):
        zc = wt @ s
        dzc = dwt @ s + wt @ ds
        z = zc[:, :p] + b
        a = act(z)
        dz = dzc[:, :p] + db
        sp = act_p(z, a)
        dsp = act_pp(z, a, sp) * dz
        s = torch.cat([a, sp.repeat(1, n_in) * zc[:, p:]], dim=1)
        ds = torch.cat([sp * dz, dsp.repeat(1, n_in) * zc[:, p:]
                        + sp.repeat(1, n_in) * dzc[:, p:]], dim=1)
    doc = dwts[-1] @ s + wts[-1] @ ds                           # [1, (1+n) P]
    dout = doc.reshape(1 + n_in, p)
    return torch.cat([dout[:1] + dbs[-1], dout[1:]], dim=0)


def _ff_embed(bt, xs_t):
    """The in-kernel embedding of ``pallas_mlp._embed``: a0 = [sin | cos](bt xs)
    [2F, P] and the n_in seeded jacobian panels [cos bt_j | -sin bt_j]; with
    ``bt`` None the coordinates and the unit panels e_j."""
    if bt is None:
        eye = torch.eye(xs_t.shape[0], dtype=xs_t.dtype, device=xs_t.device)
        return xs_t, [eye[:, j:j + 1].expand_as(xs_t) for j in range(xs_t.shape[0])]
    ang = fr._small_k(bt, xs_t)
    sn, cs = torch.sin(ang), torch.cos(ang)
    return torch.cat([sn, cs]), [torch.cat([cs * bt[:, j:j + 1], -sn * bt[:, j:j + 1]])
                                 for j in range(xs_t.shape[0])]


def ff_vj_fwd_plain(params, xs_t, bt, activation: str = "tanh"):
    """K7 forward, plain: out [1 + n_in, P] = (u, du/dxs) of the Fourier-feature
    net at the scaled points xs_t, with bt = 2 pi B^T [F, n_in]
    (``_fwd_kernel_ff``)."""
    act, act_p, _ = _act_triple(activation)
    wts, bs = _wt_layout(params)
    a, jac = _ff_embed(bt, xs_t)
    for wt, b in zip(wts[:-1], bs[:-1]):
        z = wt @ a + b
        a = act(z)
        sp = act_p(z, a)
        jac = [sp * (wt @ j) for j in jac]
    return torch.cat([wts[-1] @ a + bs[-1]] + [wts[-1] @ j for j in jac])


def ff_vj_bwd_plain(params, xs_t, bt, activation: str, g):
    """K7 backward, plain: parameter gradients of <g, out> for g [1 + n_in, P]
    (``_bwd_kernel_ff``).  B is fixed: no gradient flows to it."""
    act, act_p, act_pp = _act_triple(activation)
    wts, bs = _wt_layout(params)
    n_in = xs_t.shape[0]
    a0, j0 = _ff_embed(bt, xs_t)
    zs, acts, pres, jacs = [], [], [], []
    a, jac = a0, j0
    for wt, b in zip(wts[:-1], bs[:-1]):
        pre = [wt @ j for j in jac]
        z = wt @ a + b
        a = act(z)
        sp = act_p(z, a)
        jac = [sp * q for q in pre]
        zs.append(z)
        acts.append(a)
        pres.append(pre)
        jacs.append(jac)
    gu, gdu = g[0:1], [g[j + 1:j + 2] for j in range(n_in)]
    n = len(params)
    d_wts, d_bs = [None] * n, [None] * n
    d_wts[-1] = gu @ acts[-1].T + sum(gdu[j] @ jacs[-1][j].T for j in range(n_in))
    d_bs[-1] = gu.sum(dim=1, keepdim=True)
    ga = wts[-1].T @ gu
    g_jac = [wts[-1].T @ gd for gd in gdu]
    for l in range(n - 2, -1, -1):
        sp = act_p(zs[l], acts[l])
        spp = act_pp(zs[l], acts[l], sp)
        gz = sp * ga
        for j in range(n_in):
            gz = gz + (g_jac[j] * pres[l][j]) * spp
        gp = [sp * gj for gj in g_jac]
        a_in, j_in = (a0, j0) if l == 0 else (acts[l - 1], jacs[l - 1])
        d_wts[l] = gz @ a_in.T + sum(gp[j] @ j_in[j].T for j in range(n_in))
        d_bs[l] = gz.sum(dim=1, keepdim=True)
        if l > 0:
            ga = wts[l].T @ gz
            g_jac = [wts[l].T @ q for q in gp]
    return [{"w": dw.T, "b": db[:, 0]} for dw, db in zip(d_wts, d_bs)]


def ff_vj_jvp_plain(params, xs_t, bt, activation: str, tangent):
    """K8, plain: dout [1 + n_in, P] along the parameter tangent (B fixed, no
    tangent) -- ``_jvp_kernel_ff``: the embedding seeds both the packed state
    and its tangent, then the shared ``_jvp_tail``."""
    act, act_p, act_pp = _act_triple(activation)
    wts, bs = _wt_layout(params)
    dwts, dbs = _wt_layout(tangent)
    n_in, p = xs_t.shape
    a0, j0 = _ff_embed(bt, xs_t)
    z = wts[0] @ a0 + bs[0]
    dz = dwts[0] @ a0 + dbs[0]
    a = act(z)
    sp = act_p(z, a)
    dsp = act_pp(z, a, sp) * dz
    pre = [wts[0] @ j for j in j0]
    dpre = [dwts[0] @ j for j in j0]
    s = torch.cat([a] + [sp * q for q in pre], dim=1)
    ds = torch.cat([sp * dz] + [dsp * q + sp * dq for q, dq in zip(pre, dpre)], dim=1)
    return _jvp_tail(wts, bs, dwts, dbs, s, ds, n_in, p, activation)


# ---------------------------------------------------------------------------
# CUDA kernels: load, pack, launch


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library (``ops/build.py``) with this module's entry points."""
    lib = build.load_library()
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vj_n_params_c.argtypes = [i32, i32]
    lib.vj_fwd.argtypes = [ptr] * 3 + [i64] + [i32] * 4 + [ptr]
    lib.vj_jvp.argtypes = [ptr] * 4 + [i64] + [i32] * 4 + [ptr]
    lib.vj_bwd_blocks.argtypes = [i64, i32, i32, i32, i32, ctypes.POINTER(i32)]
    lib.vj_bwd.argtypes = [ptr] * 4 + [i32, ptr, i64] + [i32] * 4 + [ptr]
    lib.vj_launch_shape.argtypes = [i32, i64] + [i32] * 4 + [ctypes.POINTER(i32)]
    lib.ff_n_params_c.argtypes = [i32] * 3
    lib.ff_vj_fwd.argtypes = [ptr] * 4 + [i64] + [i32] * 5 + [ptr]
    lib.ff_vj_jvp.argtypes = [ptr] * 5 + [i64] + [i32] * 5 + [ptr]
    lib.ff_vj_bwd_blocks.argtypes = [i64] + [i32] * 5 + [ctypes.POINTER(i32)]
    lib.ff_vj_bwd.argtypes = [ptr] * 5 + [i32, ptr, i64] + [i32] * 5 + [ptr, ctypes.POINTER(i32)]
    for fn in (lib.vj_n_params_c, lib.vj_fwd, lib.vj_jvp, lib.vj_bwd_blocks, lib.vj_bwd,
               lib.vj_launch_shape,
               lib.ff_n_params_c, lib.ff_vj_fwd, lib.ff_vj_jvp, lib.ff_vj_bwd_blocks,
               lib.ff_vj_bwd):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=64)
def _pack_index(shapes, hp: int, device):
    """(dst, total): flat position in the kernel's packed buffer of every
    element of the leaves ``w_0, b_0, w_1, b_1, ...`` concatenated (``shapes``:
    the w shapes), and the padded buffer size (layout: csrc/tc3xtf32.cuh,
    fused_residual.pack_params)."""
    offs, total = _offsets(hp, len(shapes) - 1)
    parts = []
    for l, (ow, ob) in enumerate(offs):
        fan_in, fan_out = shapes[l]
        cols = 1 if l == len(offs) - 1 else (4 if l == 0 else hp)
        i = torch.arange(fan_in)[:, None]
        j = torch.arange(fan_out)[None, :]
        parts += [(ow + j * cols + i).reshape(-1), ob + torch.arange(fan_out)]
    return torch.cat(parts).to(device), total


def _leaves(params):
    return [layer[k] for layer in params for k in ("w", "b")]


def _shapes(params):
    return tuple(tuple(layer["w"].shape) for layer in params)


def pack(params, hp: int) -> torch.Tensor:
    """Zero-padded packed buffer of ``params`` (or of a tangent in the same
    layout): one concatenation and one scatter."""
    leaves = _leaves(params)
    dst, total = _pack_index(_shapes(params), hp, leaves[0].device)
    buf = torch.zeros(total, dtype=torch.float32, device=leaves[0].device)
    buf[dst] = torch.cat([t.detach().reshape(-1) for t in leaves]).to(torch.float32)
    return buf


def unpack(buf: torch.Tensor, params, hp: int):
    """Packed gradient -> list of ``{'w', 'b'}`` in the parameters' shapes."""
    dst, _ = _pack_index(_shapes(params), hp, buf.device)
    flat = buf[dst].split([t.numel() for t in _leaves(params)])
    return [{"w": flat[2 * l].view(layer["w"].shape), "b": flat[2 * l + 1]}
            for l, layer in enumerate(params)]


def _check_kernel_args(params, xs_t):
    n_in = xs_t.shape[0]
    if not 1 <= n_in <= MAX_IN:
        raise ValueError(f"the value+jac kernels take 1 <= n_in <= {MAX_IN}, got {n_in}")
    if len(params) < 2 or params[-1]["w"].shape[1] != 1:
        raise ValueError("the value+jac kernels need >= 1 hidden layer and 1 output")
    widest = max(layer["w"].shape[1] for layer in params[:-1])
    if widest > MAX_HIDDEN:
        raise ValueError(f"hidden width {widest} > {MAX_HIDDEN} is not supported by the kernels")
    for t in (xs_t, *_leaves(params)):
        if t.device != xs_t.device or t.dtype != torch.float32:
            raise ValueError("the value+jac kernels take f32 tensors on one device")
    if not xs_t.is_contiguous():
        raise ValueError("xs_t must be contiguous")


def _packed(lib, params):
    hp = padded_width(params)
    packed = pack(params, hp)
    if packed.numel() != lib.vj_n_params_c(hp, len(params) - 1):
        raise RuntimeError("packed parameter layout differs from value_and_jac.cu's")
    return hp, packed


def _route(xs_t, activation) -> str:
    """The device kind of xs_t: "cpu" (the plain versions) or "cuda" (the
    kernels, for every activation of ``_act_triple``); anything else raises."""
    _act_triple(activation)
    kind = xs_t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"value_and_jac: unsupported device '{kind}'")
    return kind


def _stream(xs_t):
    return torch.cuda.current_stream(xs_t.device).cuda_stream


def vj_fwd(params, xs_t, activation: str = "tanh"):
    """out [1 + n_in, P]: the CUDA kernel for CUDA tensors, the plain version
    for CPU ones."""
    if _route(xs_t, activation) == "cpu":
        return vj_fwd_plain(params, xs_t, activation)
    _check_kernel_args(params, xs_t)
    lib = load_library()
    hp, packed = _packed(lib, params)
    n_in, p = xs_t.shape
    out = torch.empty((1 + n_in, p), dtype=torch.float32, device=xs_t.device)
    build.raise_on(lib.vj_fwd(xs_t.data_ptr(), packed.data_ptr(), out.data_ptr(), p, n_in,
                              len(params) - 1, hp, ACTIVATIONS[activation], _stream(xs_t)),
                   "vj_fwd")
    vj_fwd.launches += 1
    return out


def vj_bwd(params, xs_t, activation: str, g):
    """Parameter gradients of <g, out>; dispatch as ``vj_fwd``."""
    if _route(xs_t, activation) == "cpu":
        return vj_bwd_plain(params, xs_t, activation, g)
    _check_kernel_args(params, xs_t)
    lib = load_library()
    hp, packed = _packed(lib, params)
    n_in, p = xs_t.shape
    g = g.detach().to(torch.float32).contiguous()
    if tuple(g.shape) != (1 + n_in, p) or g.device != xs_t.device:
        raise ValueError(f"cotangent must be [{1 + n_in}, {p}] on {xs_t.device}")
    blocks = ctypes.c_int(0)
    fr.raise_on_fit(params, lib.vj_bwd_blocks(p, n_in, len(params) - 1, hp,
                                              ACTIVATIONS[activation], ctypes.byref(blocks)),
                    f"value_and_jac.cu vj_bwd_blocks, {activation}")
    npp = packed.numel()
    partials = torch.empty(blocks.value * npp, dtype=torch.float32, device=xs_t.device)
    grad = torch.empty(npp, dtype=torch.float32, device=xs_t.device)
    build.raise_on(lib.vj_bwd(xs_t.data_ptr(), g.data_ptr(), packed.data_ptr(),
                              partials.data_ptr(), blocks.value, grad.data_ptr(), p, n_in,
                              len(params) - 1, hp, ACTIVATIONS[activation], _stream(xs_t)),
                   "vj_bwd")
    vj_bwd.launches += 1
    return unpack(grad, params, hp)


def vj_jvp(params, xs_t, activation: str, tangent):
    """dout [1 + n_in, P] along ``tangent``; dispatch as ``vj_fwd``."""
    if _route(xs_t, activation) == "cpu":
        return vj_jvp_plain(params, xs_t, activation, tangent)
    _check_kernel_args(params, xs_t)
    lib = load_library()
    hp, packed = _packed(lib, params)
    dpacked = pack(tangent, hp)
    n_in, p = xs_t.shape
    dout = torch.empty((1 + n_in, p), dtype=torch.float32, device=xs_t.device)
    fr.raise_on_fit(params, lib.vj_jvp(xs_t.data_ptr(), packed.data_ptr(), dpacked.data_ptr(),
                                       dout.data_ptr(), p, n_in, len(params) - 1, hp,
                                       ACTIVATIONS[activation], _stream(xs_t)),
                    f"value_and_jac.cu vj_jvp, {activation}")
    vj_jvp.launches += 1
    return dout


vj_fwd.launches = 0
vj_bwd.launches = 0
vj_jvp.launches = 0


def launch_shape(kind: str, params, xs_t, activation: str) -> dict:
    """The launch shape csrc/value_and_jac.cu takes on the current card for K5's
    forward ("fwd"), K6 ("jvp") or K5's backward ("bwd") of ``params`` on the points
    xs_t [n_in, P]: threads per block, blocks resident per SM, warps per SM, blocks
    of the grid, points per tile and shared memory bytes per block."""
    shape = (ctypes.c_int * 5)()
    n_in, p = xs_t.shape
    fr.raise_on_fit(params, load_library().vj_launch_shape(
        ("fwd", "jvp", "bwd").index(kind), p, n_in, len(params) - 1, padded_width(params),
        ACTIVATIONS[activation], shape), f"value_and_jac.cu vj_launch_shape, {activation}")
    threads, per_sm, blocks, tile, smem = shape
    return {"threads": threads, "blocks_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32,
            "blocks": blocks, "tile": tile, "smem_bytes": smem}


def _as_params(flat):
    return [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]


primal_fills = 0   # evaluations that ran the forward and stored it in a PrimalSlot
primal_hits = 0    # evaluations whose forward a held PrimalSlot gave


class PrimalSlot:
    """The out [1 + n_in, P] of a value + jacobian Function's forward, kept for
    later calls at the same parameters and points (``primal=`` of
    :func:`value_and_jac` / :func:`ff_value_and_jac`).  Empty, the next call's
    forward runs and fills it; held, the forward returns it and launches
    nothing.  The backward and jvp rules read only the points and the
    parameters, so they run as without it.  Whoever holds the slot empties it
    before either changes."""

    __slots__ = ("out",)

    def __init__(self):
        self.out = None


def _forward(primal, compute):
    """``compute()``, or the out that ``primal`` holds.  The stored out is
    returned detached: a new tensor on the same memory (no copy), so that
    autograd's record of this call (the output's grad_fn, its forward-mode
    tangent) never lands on the stored one."""
    global primal_fills, primal_hits
    if primal is None:
        return compute()
    if primal.out is not None:
        primal_hits += 1
        return primal.out.detach()
    out = compute()
    primal.out = out.detach()
    primal_fills += 1
    return out


class ValueAndJacFn(torch.autograd.Function):
    """out = vj_fwd(params, xs_t), or the out a held ``primal`` slot stores
    (None: none); ``backward`` by K5's backward, ``jvp`` by K6.
    Differentiable in the parameters only: xs_t is fixed data."""

    @staticmethod
    def forward(xs_t, activation, primal, *flat):
        return _forward(primal, lambda: vj_fwd(_as_params(flat), xs_t, activation))

    @staticmethod
    def setup_context(ctx, inputs, output):
        xs_t, activation, _primal, *flat = inputs
        ctx.activation = activation
        ctx.save_for_backward(xs_t, *flat)
        ctx.save_for_forward(xs_t, *flat)

    @staticmethod
    def backward(ctx, g):
        xs_t, *flat = ctx.saved_tensors
        grads = vj_bwd(_as_params(flat), xs_t, ctx.activation, g)
        return (None, None, None, *_leaves(grads))

    @staticmethod
    def jvp(ctx, _dxs, _dact, _dprimal, *dflat):
        xs_t, *flat = ctx.saved_tensors
        tangent = [torch.zeros_like(t) if d is None else d for t, d in zip(flat, dflat)]
        return vj_jvp(_as_params(flat), xs_t, ctx.activation, _as_params(tangent))


def value_and_jac(params, x, activation: str = "tanh", scale=None, shift=None,
                  primal=None):
    """(u, du/dx) at x: [P, n_in] -> ([P], [P, n_in]) through
    :class:`ValueAndJacFn`: the signature and semantics of
    ``mlp_value_and_jac`` (du is with respect to the ORIGINAL coordinates),
    differentiable in reverse and forward mode with respect to ``params`` only.
    ``primal``: a :class:`PrimalSlot` for these parameters and points, filled
    by this call's forward if empty, standing in for it if held.
    A net without a hidden layer falls back to ``mlp_value_and_jac``, as
    ``pallas_value_and_jac`` does (and recomputes); on CUDA a net wider than
    K5 / K6 take runs on K7 / K8 without an embedding."""
    if len(params) < 2:
        return mlp_value_and_jac(params, x, activation, scale, shift)
    xs = x if scale is None else (x - shift) * scale
    xs_t = xs.detach().T.to(torch.float32).contiguous()
    if fr.uses_ff_kernels(params, xs_t.is_cuda, False):
        out = FfValueAndJacFn.apply(xs_t, None, activation, primal, *_leaves(params))
    else:
        out = ValueAndJacFn.apply(xs_t, activation, primal, *_leaves(params))
    du = out[1:]
    if scale is not None:
        du = du * scale[:, None].to(du.dtype)
    return out[0], du.T


# ---------------------------------------------------------------------------
# K7 / K8: the Fourier-feature twins (csrc/ff_mlp.cu, unit mode)


def _ff_vj_args(params, xs_t, activation, hp, fp):
    n_in, p = xs_t.shape
    return [p, n_in, fr.ff_ke(fp), len(params) - 1, hp, ACTIVATIONS[activation]]


def kernel_ff_vj_fwd(lib, params, xs_t, bt, activation: str, stream=None):
    """Launch K7's forward of ``lib`` (no device dispatch): out [1 + n_in, P]."""
    hp, fp, packed = fr._ff_packed(lib, params, bt is not None)
    btf = fr.ff_bt(bt, fp)  # held until the launch has read it
    out = torch.empty((1 + xs_t.shape[0], xs_t.shape[1]), dtype=torch.float32,
                      device=xs_t.device)
    fr.raise_on_fit(params, lib.ff_vj_fwd(
        xs_t.data_ptr(), fr._ptr(btf), packed.data_ptr(), out.data_ptr(),
        *_ff_vj_args(params, xs_t, activation, hp, fp), stream), "ff_vj_fwd")
    return out


def kernel_ff_vj_bwd(lib, params, xs_t, bt, activation: str, g, stream=None):
    """Launch K7's backward of ``lib``: gradients of <g, out>, and whether the launch
    took the wgmma engine."""
    hp, fp, packed = fr._ff_packed(lib, params, bt is not None)
    btf = fr.ff_bt(bt, fp)  # held until the launch has read it
    n_in, p = xs_t.shape
    g = g.detach().to(torch.float32).contiguous()
    if tuple(g.shape) != (1 + n_in, p) or g.device != xs_t.device:
        raise ValueError(f"cotangent must be [{1 + n_in}, {p}] on {xs_t.device}")
    blocks = ctypes.c_int(0)
    fr.raise_on_fit(params, lib.ff_vj_bwd_blocks(p, n_in, fr.ff_ke(fp), len(params) - 1, hp,
                                                 ACTIVATIONS[activation], ctypes.byref(blocks)),
                    f"ff_vj_bwd_blocks, {activation}")
    partials = torch.empty(blocks.value * packed.numel(), dtype=torch.float32,
                           device=xs_t.device)
    grad = torch.empty(packed.numel(), dtype=torch.float32, device=xs_t.device)
    wgmma = ctypes.c_int(0)
    fr.raise_on_fit(params, lib.ff_vj_bwd(
        xs_t.data_ptr(), fr._ptr(btf), packed.data_ptr(), g.data_ptr(), partials.data_ptr(),
        blocks.value, grad.data_ptr(), *_ff_vj_args(params, xs_t, activation, hp, fp), stream,
        ctypes.byref(wgmma)), "ff_vj_bwd")
    return fr.ff_unpack(grad, params, hp, fp), bool(wgmma.value)


def kernel_ff_vj_jvp(lib, params, xs_t, bt, activation: str, tangent, stream=None):
    """Launch K8 of ``lib``: dout [1 + n_in, P] along ``tangent``."""
    hp, fp, packed = fr._ff_packed(lib, params, bt is not None)
    dpacked = fr.ff_pack(tangent, hp, fp)
    btf = fr.ff_bt(bt, fp)  # held until the launch has read it
    dout = torch.empty((1 + xs_t.shape[0], xs_t.shape[1]), dtype=torch.float32,
                       device=xs_t.device)
    fr.raise_on_fit(params, lib.ff_vj_jvp(
        xs_t.data_ptr(), fr._ptr(btf), packed.data_ptr(), dpacked.data_ptr(), dout.data_ptr(),
        *_ff_vj_args(params, xs_t, activation, hp, fp), stream), "ff_vj_jvp")
    return dout


def _ff_check(params, xs_t, bt, activation):
    fr.check_ff_args(params, bt, (xs_t,), activation)
    if bt is not None and bt.shape[1] != xs_t.shape[0]:
        raise ValueError(f"bt has {bt.shape[1]} input columns, the points {xs_t.shape[0]}")


def ff_vj_fwd(params, xs_t, bt, activation: str = "tanh"):
    """K7 forward: the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if _route(xs_t, activation) == "cpu":
        return ff_vj_fwd_plain(params, xs_t, bt, activation)
    _ff_check(params, xs_t, bt, activation)
    out = kernel_ff_vj_fwd(load_library(), params, xs_t, bt, activation, _stream(xs_t))
    ff_vj_fwd.launches += 1
    return out


def ff_vj_bwd(params, xs_t, bt, activation: str, g):
    """K7 backward; dispatch as ``ff_vj_fwd``."""
    if _route(xs_t, activation) == "cpu":
        return ff_vj_bwd_plain(params, xs_t, bt, activation, g)
    _ff_check(params, xs_t, bt, activation)
    grads, wgmma = kernel_ff_vj_bwd(load_library(), params, xs_t, bt, activation, g,
                                    _stream(xs_t))
    ff_vj_bwd.launches += 1
    ff_vj_bwd.wgmma_launches += wgmma
    return grads


def ff_vj_jvp(params, xs_t, bt, activation: str, tangent):
    """K8; dispatch as ``ff_vj_fwd``."""
    if _route(xs_t, activation) == "cpu":
        return ff_vj_jvp_plain(params, xs_t, bt, activation, tangent)
    _ff_check(params, xs_t, bt, activation)
    dout = kernel_ff_vj_jvp(load_library(), params, xs_t, bt, activation, tangent,
                            _stream(xs_t))
    ff_vj_jvp.launches += 1
    return dout


ff_vj_fwd.launches = 0
ff_vj_bwd.launches = 0
ff_vj_bwd.wgmma_launches = 0   # those on ff_mlp.cu's wgmma engine
ff_vj_jvp.launches = 0


class FfValueAndJacFn(torch.autograd.Function):
    """out = ff_vj_fwd(params, xs_t, bt), or the out a held ``primal`` slot
    stores (None: none); ``backward`` by K7's backward, ``jvp`` by K8.
    Differentiable in the parameters only: xs_t and bt are fixed."""

    @staticmethod
    def forward(xs_t, bt, activation, primal, *flat):
        return _forward(primal, lambda: ff_vj_fwd(_as_params(flat), xs_t, bt, activation))

    @staticmethod
    def setup_context(ctx, inputs, output):
        xs_t, bt, activation, _primal, *flat = inputs
        ctx.activation = activation
        ctx.save_for_backward(xs_t, bt, *flat)
        ctx.save_for_forward(xs_t, bt, *flat)

    @staticmethod
    def backward(ctx, g):
        xs_t, bt, *flat = ctx.saved_tensors
        grads = ff_vj_bwd(_as_params(flat), xs_t, bt, ctx.activation, g)
        return (None, None, None, None, *_leaves(grads))

    @staticmethod
    def jvp(ctx, _dxs, _dbt, _dact, _dprimal, *dflat):
        xs_t, bt, *flat = ctx.saved_tensors
        tangent = [torch.zeros_like(t) if d is None else d for t, d in zip(flat, dflat)]
        return ff_vj_jvp(_as_params(flat), xs_t, bt, ctx.activation, _as_params(tangent))


def ff_value_and_jac(b_mat, params, x, activation: str = "tanh", scale=None, shift=None,
                     primal=None):
    """(u, du/dx) of the Fourier-feature net through :class:`FfValueAndJacFn`:
    the signature and semantics of ``models.mlp.ff_value_and_jac`` (bind B with
    ``functools.partial``), differentiable in reverse and forward mode with
    respect to ``params`` only; ``primal`` as :func:`value_and_jac`'s.  bt =
    2 pi B^T is formed as the JAX package forms it.  A net without a hidden
    layer falls back to the plain function."""
    if len(params) < 2:
        return _mlp.ff_value_and_jac(b_mat, params, x, activation, scale, shift)
    xs = x if scale is None else (x - shift) * scale
    xs_t = xs.detach().T.to(torch.float32).contiguous()
    bt = ((2.0 * math.pi) * b_mat.to(device=x.device, dtype=torch.float32).T).contiguous()
    out = FfValueAndJacFn.apply(xs_t, bt, activation, primal, *_leaves(params))
    du = out[1:]
    if scale is not None:
        du = du * scale[:, None].to(du.dtype)
    return out[0], du.T
