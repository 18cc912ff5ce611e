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
Coordinates are fixed data: no gradient or tangent flows to them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.mlp import mlp_value_and_jac
from . import build
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
    activation a_l, the panels s_l = [a_l | J_l^1 .. J_l^n] [H, (1+n) P] and
    the tangent pre-activations P_l^j (None for layer 0: the W_0 column)."""
    act, act_p, _ = _act_triple(activation)
    n_in, p = xs_t.shape
    a = act(wts[0] @ xs_t + bs[0])
    sp = act_p(a)
    acts, pres = [a], [None]
    s_packed = [torch.cat([a] + [sp * wts[0][:, j:j + 1] for j in range(n_in)], dim=1)]
    for wt, b in zip(wts[1:-1], bs[1:-1]):
        zc = wt @ s_packed[-1]
        a = act(zc[:, :p] + b)
        sp = act_p(a)
        acts.append(a)
        pres.append(zc[:, p:])
        s_packed.append(torch.cat([a, sp.repeat(1, n_in) * zc[:, p:]], dim=1))
    return acts, pres, s_packed


def vj_bwd_plain(params, xs_t, activation: str, g):
    """Closed-form parameter gradients of <g, out> for g [1 + n_in, P]: a list
    of ``{'w', 'b'}`` in the parameters' layout.  Mirrors ``_bwd_kernel`` and
    ``_packed_bwd_tail``, with the act'' term gz = sp ga + spp sum_j gJ_j P_l^j."""
    _, act_p, act_pp = _act_triple(activation)
    wts, bs = _wt_layout(params)
    n_in, p = xs_t.shape
    acts, pres, s_packed = _packed_forward(wts, bs, xs_t, activation)
    n = len(params)
    d_wts, d_bs = [None] * n, [None] * n
    d_wts[-1] = sum(g[j:j + 1] @ s_packed[-1][:, j * p:(j + 1) * p].T for j in range(1 + n_in))
    d_bs[-1] = g[0:1].sum(dim=1, keepdim=True)
    g_s = torch.cat([wts[-1].T * g[j:j + 1] for j in range(1 + n_in)], dim=1)
    for l in range(n - 2, -1, -1):
        sp = act_p(acts[l])
        spp = act_pp(acts[l], sp)
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
    sp = act_p(a)
    dsp = act_pp(a, sp) * dz
    s = torch.cat([a] + [sp * wts[0][:, j:j + 1] for j in range(n_in)], dim=1)
    ds = torch.cat([sp * dz] + [dsp * wts[0][:, j:j + 1] + sp * dwts[0][:, j:j + 1]
                                for j in range(n_in)], dim=1)
    for wt, b, dwt, db in zip(wts[1:-1], bs[1:-1], dwts[1:-1], dbs[1:-1]):
        zc = wt @ s
        dzc = dwt @ s + wt @ ds
        a = act(zc[:, :p] + b)
        dz = dzc[:, :p] + db
        sp = act_p(a)
        dsp = act_pp(a, sp) * dz
        s = torch.cat([a, sp.repeat(1, n_in) * zc[:, p:]], dim=1)
        ds = torch.cat([sp * dz, dsp.repeat(1, n_in) * zc[:, p:]
                        + sp.repeat(1, n_in) * dzc[:, p:]], dim=1)
    doc = dwts[-1] @ s + wts[-1] @ ds                           # [1, (1+n) P]
    dout = doc.reshape(1 + n_in, p)
    return torch.cat([dout[:1] + dbs[-1], dout[1:]], dim=0)


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
    lib.vj_bwd_blocks.argtypes = [i64, i32, i32, i32, ctypes.POINTER(i32)]
    lib.vj_bwd.argtypes = [ptr] * 4 + [i32, ptr, i64] + [i32] * 4 + [ptr]
    for fn in (lib.vj_n_params_c, lib.vj_fwd, lib.vj_jvp, lib.vj_bwd_blocks, lib.vj_bwd):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=64)
def _pack_index(shapes, hp: int, device):
    """(dst, total): flat position in the kernel's packed buffer of every
    element of the leaves ``w_0, b_0, w_1, b_1, ...`` concatenated (``shapes``:
    the w shapes), and the padded buffer size (layout: csrc/value_and_jac.cu,
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
    _act_triple(activation)  # tanh | sigmoid on every route; sin comes with SIREN
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
    build.raise_on(lib.vj_bwd_blocks(p, n_in, len(params) - 1, hp, ctypes.byref(blocks)),
                   "vj_bwd_blocks")
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
    build.raise_on(lib.vj_jvp(xs_t.data_ptr(), packed.data_ptr(), dpacked.data_ptr(),
                              dout.data_ptr(), p, n_in, len(params) - 1, hp,
                              ACTIVATIONS[activation], _stream(xs_t)),
                   "vj_jvp")
    vj_jvp.launches += 1
    return dout


vj_fwd.launches = 0
vj_bwd.launches = 0
vj_jvp.launches = 0


def _as_params(flat):
    return [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]


class ValueAndJacFn(torch.autograd.Function):
    """out = vj_fwd(params, xs_t); ``backward`` by K5's backward, ``jvp`` by K6.
    Differentiable in the parameters only: xs_t is fixed data."""

    @staticmethod
    def forward(xs_t, activation, *flat):
        return vj_fwd(_as_params(flat), xs_t, activation)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xs_t, activation, *flat = inputs
        ctx.activation = activation
        ctx.save_for_backward(xs_t, *flat)
        ctx.save_for_forward(xs_t, *flat)

    @staticmethod
    def backward(ctx, g):
        xs_t, *flat = ctx.saved_tensors
        grads = vj_bwd(_as_params(flat), xs_t, ctx.activation, g)
        return (None, None, *_leaves(grads))

    @staticmethod
    def jvp(ctx, _dxs, _dact, *dflat):
        xs_t, *flat = ctx.saved_tensors
        tangent = [torch.zeros_like(t) if d is None else d for t, d in zip(flat, dflat)]
        return vj_jvp(_as_params(flat), xs_t, ctx.activation, _as_params(tangent))


def value_and_jac(params, x, activation: str = "tanh", scale=None, shift=None):
    """(u, du/dx) at x: [P, n_in] -> ([P], [P, n_in]) through
    :class:`ValueAndJacFn`: the signature and semantics of
    ``mlp_value_and_jac`` (du is with respect to the ORIGINAL coordinates),
    differentiable in reverse and forward mode with respect to ``params`` only.
    A net without a hidden layer falls back to ``mlp_value_and_jac``, as
    ``pallas_value_and_jac`` does."""
    if len(params) < 2:
        return mlp_value_and_jac(params, x, activation, scale, shift)
    xs = x if scale is None else (x - shift) * scale
    xs_t = xs.detach().T.to(torch.float32).contiguous()
    out = ValueAndJacFn.apply(xs_t, activation, *_leaves(params))
    du = out[1:]
    if scale is not None:
        du = du * scale[:, None].to(du.dtype)
    return out[0], du.T
