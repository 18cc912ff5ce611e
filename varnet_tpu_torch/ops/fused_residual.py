"""Directional fused weak residual: plain PyTorch version + Hopper CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_residual.py`` directional kernels
(``_dirq_residual_fn``, G > 1, and ``_fused_residual_fn(directional=True)``,
G = 1).  For every test function k it computes

    r_k = sum_q [ c(k,q) . du/dxs + cu(k,q) u + csrc(k,q) ],
    c_j = w_q scale_j (vel_j N_q + kappa dN_qj)   (j < d),   c_t = w_q scale_t N_q,
    cu  = w_q N_q react,   csrc = -w_q N_q src,

by pushing ONE directional tangent through the MLP beside the activations, and
its closed-form parameter backward (gradients flow to the parameters only; the
quadrature data is constant).

Two implementations share one signature:

* ``dir_residual_fwd_plain`` / ``dir_residual_bwd_plain``: straightforward
  vectorised PyTorch.  The backward mirrors ``_dir_bwd_kernel`` step by step.
* ``csrc/dir_residual.cu``: hand-written CUDA for sm_90a, built with ``nvcc``
  (``ops/build.py``, with every other ``csrc/*.cu``) into a plain-C shared
  library at first use and called through ``ctypes``.

``dir_residual_fwd`` / ``dir_residual_bwd`` dispatch on the device of the data:
CPU tensors take the plain version, CUDA tensors launch the kernel (or raise),
anything else raises.  Each counts its kernel launches in ``.launches``.
``DirResidualFn`` is the autograd glue, ``fused_residual`` the loss's entry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import build

MAX_IN = 4          # kernel's padded input width; n_in <= 3 is supported
MAX_HIDDEN = 64
ACTIVATIONS = {"tanh": 0, "sigmoid": 1}


class ResidualData(NamedTuple):
    """Fixed per-point data of the residual, in the kernel's layout.

    Points are flattened p = k * nq + q.  Built once per training call by
    :func:`prepare_residual_data` and reused every step."""

    xs: torch.Tensor       # [n_in, P] f32 scaled coordinates
    flds: torch.Tensor     # [2 + d (+1), P] f32: kappa, vel_0..vel_{d-1}, src[, react]
    tab: torch.Tensor      # [nq, 2 + d] f32: N, w, dN_0..dN_{d-1}
    scale: torch.Tensor    # [n_in] f32 input scale
    k: int
    nq: int
    d: int
    td: bool
    has_react: bool


def prepare_residual_data(quad, scale, shift, *, time_dependent: bool,
                          has_react: bool, device=None) -> ResidualData:
    """The kernel layout of a QuadData (NumPy arrays or tensors) with shared
    [nQ] tables and input scaling ``scale``/``shift`` (arrays or tensors).
    Coordinates are cast to f32 BEFORE scaling, as on the general path, so
    both round identically."""
    if quad.N.ndim != 1:
        raise ValueError("per-node test tables (test_order=2) are not ported yet")
    k, nq, n_in = quad.coords.shape
    d = quad.dN.shape[-1]
    def dev(a):  # f32 device tensor (host arrays copied: they may be read-only)
        if isinstance(a, torch.Tensor):
            return a.to(dtype=torch.float32, device=device)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    xs = ((dev(quad.coords) - dev(shift)) * dev(scale)).reshape(k * nq, n_in).T.contiguous()
    rows = [quad.kappa] + [quad.vel[:, :, j] for j in range(d)] + [quad.src]
    if has_react:
        rows.append(quad.react)
    flds = torch.stack([dev(a).reshape(k * nq) for a in rows])
    tab = torch.cat([dev(quad.N).reshape(nq, 1), dev(quad.w).reshape(nq, 1),
                     dev(quad.dN).reshape(nq, d)], dim=1)
    return ResidualData(xs, flds, tab.contiguous(), dev(scale).reshape(n_in).clone(),
                        int(k), int(nq), int(d),
                        bool(time_dependent), bool(has_react))


# ---------------------------------------------------------------------------
# plain PyTorch version


def _act_triple(activation):
    if activation == "tanh":
        return torch.tanh, (lambda a: 1.0 - a * a), (lambda a, sp: -2.0 * a * sp)
    if activation == "sigmoid":
        return (torch.sigmoid, (lambda a: a * (1.0 - a)),
                (lambda a, sp: (1.0 - 2.0 * a) * sp))
    raise ValueError(f"activation '{activation}' is not supported by the fused "
                     "residual (tanh|sigmoid; sin comes with the SIREN port)")


def _dir_coeffs(data: ResidualData):
    """Per-point direction c [n_in, P], u coefficient cu [P] (or None) and
    source term csrc [P] — the math of ``_dir_coeffs``."""
    n_in, p = data.xs.shape
    d = data.d
    n_q = data.tab[:, 0].repeat(data.k)
    w_q = data.tab[:, 1].repeat(data.k)
    kappa = data.flds[0]
    rows = [w_q * data.scale[j] * (data.flds[1 + j] * n_q
                                   + kappa * data.tab[:, 2 + j].repeat(data.k))
            for j in range(d)]
    if data.td:
        rows.append(w_q * data.scale[d] * n_q)
    rows += [torch.zeros_like(kappa)] * (n_in - len(rows))
    cu = w_q * n_q * data.flds[2 + d] if data.has_react else None
    return torch.stack(rows), cu, -w_q * n_q * data.flds[1 + d]


def _wt_layout(params):
    return ([layer["w"].T for layer in params], [layer["b"][:, None] for layer in params])


def _forward_states(wts, bs, data, activation, c):
    """Hidden-layer activations a_l and tangent pre-activations pre_l [H_l, P]."""
    act, act_p, _ = _act_triple(activation)
    a = act(wts[0] @ data.xs + bs[0])
    acts, pres = [a], [wts[0] @ c]
    for wt, b in zip(wts[1:-1], bs[1:-1]):
        t = act_p(a) * pres[-1]
        a = act(wt @ a + b)
        acts.append(a)
        pres.append(wt @ t)
    return acts, pres


def dir_residual_fwd_plain(params, data: ResidualData, activation: str = "tanh"):
    """r [K] by plain PyTorch ops (any device)."""
    _, act_p, _ = _act_triple(activation)
    wts, bs = _wt_layout(params)
    c, cu, csrc = _dir_coeffs(data)
    acts, pres = _forward_states(wts, bs, data, activation, c)
    a = acts[-1]
    dd = (wts[-1] @ (act_p(a) * pres[-1]))[0]
    contrib = dd + csrc
    if cu is not None:
        contrib = contrib + cu * (wts[-1] @ a + bs[-1])[0]
    return contrib.reshape(data.k, data.nq).sum(dim=1)


def dir_residual_bwd_plain(params, data: ResidualData, activation: str, gr):
    """Closed-form parameter gradients for the cotangent gr [K]: a list of
    ``{'w', 'b'}`` in the parameters' layout.  Mirrors ``_dir_bwd_kernel``."""
    _, act_p, act_pp = _act_triple(activation)
    wts, bs = _wt_layout(params)
    c, cu, _ = _dir_coeffs(data)
    acts, pres = _forward_states(wts, bs, data, activation, c)
    g_tan = gr.repeat_interleave(data.nq)[None, :]             # [1, P]
    g_val = g_tan * cu if cu is not None else torch.zeros_like(g_tan)
    tans = [act_p(a) * pre for a, pre in zip(acts, pres)]
    n = len(params)
    d_wts, d_bs = [None] * n, [None] * n
    d_wts[-1] = g_tan @ tans[-1].T + g_val @ acts[-1].T
    d_bs[-1] = g_val.sum(dim=1, keepdim=True)
    ga = wts[-1].T * g_val                                     # [H, P]
    gj = wts[-1].T * g_tan
    for l in range(n - 2, -1, -1):
        sp = act_p(acts[l])
        spp = act_pp(acts[l], sp)
        gz = sp * ga + spp * (gj * pres[l])
        gp = sp * gj
        x_in, t_in = (data.xs, c) if l == 0 else (acts[l - 1], tans[l - 1])
        d_wts[l] = gz @ x_in.T + gp @ t_in.T
        d_bs[l] = gz.sum(dim=1, keepdim=True)
        if l > 0:
            ga = wts[l].T @ gz
            gj = wts[l].T @ gp
    return [{"w": dw.T, "b": db[:, 0]} for dw, db in zip(d_wts, d_bs)]


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library (every ``csrc/*.cu``, built once by ``ops/build.py``)
    with this module's entry points declared."""
    lib = build.load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vr_dir_residual_n_params.argtypes = [i32, i32]
    lib.vr_dir_residual_fwd.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.vr_dir_residual_bwd_blocks.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.vr_dir_residual_bwd.argtypes = [ptr] * 7 + [i32, ptr] + [i32] * 9 + [ptr]
    for fn in (lib.vr_dir_residual_n_params, lib.vr_dir_residual_fwd,
               lib.vr_dir_residual_bwd_blocks, lib.vr_dir_residual_bwd):
        fn.restype = i32
    return lib


def padded_width(params) -> int:
    """Hidden width the kernel is instantiated for: the widest hidden layer
    rounded up to a multiple of 8."""
    return -(-max(layer["w"].shape[1] for layer in params[:-1]) // 8) * 8


def _offsets(hp: int, n_hidden: int):
    """(w offset, b offset) of each layer in the packed buffer (mirrors the
    vr_off_* helpers of dir_residual.cu), and the padded total."""
    offs = [(0, 4 * hp)]
    for l in range(1, n_hidden):
        w = 5 * hp + (l - 1) * (hp * hp + hp)
        offs.append((w, w + hp * hp))
    w_out = 5 * hp + (n_hidden - 1) * (hp * hp + hp)
    offs.append((w_out, w_out + hp))
    return offs, -(-(w_out + hp + 1) // 4) * 4


def _check_kernel_args(params, data: ResidualData, activation):
    _act_triple(activation)  # raises on what the kernel does not take
    n_in = data.xs.shape[0]
    if n_in >= MAX_IN:
        raise ValueError(f"the fused residual kernel takes n_in <= {MAX_IN - 1}, got {n_in}")
    if len(params) < 2 or params[-1]["w"].shape[1] != 1:
        raise ValueError("the fused residual kernel needs >= 1 hidden layer and 1 output")
    widest = max(layer["w"].shape[1] for layer in params[:-1])
    if widest > MAX_HIDDEN:
        raise ValueError(f"hidden width {widest} > {MAX_HIDDEN} is not supported by the kernel")
    dev = data.xs.device
    for t in (data.xs, data.flds, data.tab, data.scale,
              *[layer[k] for layer in params for k in ("w", "b")]):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("the fused residual kernel takes f32 tensors on one device")
    for t in (data.xs, data.flds, data.tab, data.scale):
        if not t.is_contiguous():
            raise ValueError("the fused residual data must be contiguous")


def pack_params(params, hp: int) -> torch.Tensor:
    """Zero-padded packed parameter buffer of the kernel (layout: see the
    header of csrc/dir_residual.cu)."""
    offs, total = _offsets(hp, len(params) - 1)
    buf = torch.zeros(total, dtype=torch.float32, device=params[0]["w"].device)
    for l, (layer, (ow, ob)) in enumerate(zip(params, offs)):
        w, b = layer["w"].detach(), layer["b"].detach()
        fan_in, fan_out = w.shape
        if l == len(params) - 1:
            buf[ow:ow + fan_in] = w[:, 0]
        else:
            cols = 4 if l == 0 else hp
            buf[ow:ow + hp * cols].view(hp, cols)[:fan_out, :fan_in] = w.T
        buf[ob:ob + fan_out] = b
    return buf


def unpack_grads(buf: torch.Tensor, params, hp: int):
    """Packed gradient buffer -> list of ``{'w', 'b'}`` in the parameters' shapes."""
    offs, _ = _offsets(hp, len(params) - 1)
    out = []
    for l, (layer, (ow, ob)) in enumerate(zip(params, offs)):
        fan_in, fan_out = layer["w"].shape
        if l == len(params) - 1:
            dw = buf[ow:ow + fan_in][:, None]
        else:
            cols = 4 if l == 0 else hp
            dw = buf[ow:ow + hp * cols].view(hp, cols)[:fan_out, :fan_in].T
        out.append({"w": dw.contiguous(), "b": buf[ob:ob + fan_out].clone()})
    return out


def _common_args(data: ResidualData, params, activation, hp):
    return [data.k, data.nq, data.xs.shape[0], data.d, int(data.td),
            int(data.has_react), len(params) - 1, hp, ACTIVATIONS[activation]]


def _packed(lib, params):
    """(hp, packed parameters), the layout checked against the library's."""
    hp = padded_width(params)
    packed = pack_params(params, hp)
    if packed.numel() != lib.vr_dir_residual_n_params(hp, len(params) - 1):
        raise RuntimeError("packed parameter layout differs from dir_residual.cu's")
    return hp, packed


def kernel_fwd(lib, params, data: ResidualData, activation: str, stream=None):
    """Launch the forward kernel of ``lib`` (no device dispatch; the caller
    guarantees the tensors suit it).  Returns r [K]."""
    hp, packed = _packed(lib, params)
    r = torch.empty(data.k, dtype=torch.float32, device=data.xs.device)
    err = lib.vr_dir_residual_fwd(
        data.xs.data_ptr(), data.flds.data_ptr(), data.tab.data_ptr(),
        data.scale.data_ptr(), packed.data_ptr(), r.data_ptr(),
        *_common_args(data, params, activation, hp), stream)
    build.raise_on(err, "dir_residual_fwd")
    return r


def kernel_bwd(lib, params, data: ResidualData, activation: str, gr, stream=None):
    """Launch the backward kernels of ``lib``.  Returns ``{'w', 'b'}`` grads."""
    hp, packed = _packed(lib, params)
    n_hidden = len(params) - 1
    blocks = ctypes.c_int(0)
    build.raise_on(lib.vr_dir_residual_bwd_blocks(data.k, data.nq, data.d, n_hidden, hp,
                                             ctypes.byref(blocks)),
              "dir_residual_bwd_blocks")
    npp = packed.numel()
    partials = torch.empty(blocks.value * npp, dtype=torch.float32, device=data.xs.device)
    grad = torch.empty(npp, dtype=torch.float32, device=data.xs.device)
    gr = gr.detach().to(torch.float32).contiguous()
    err = lib.vr_dir_residual_bwd(
        data.xs.data_ptr(), data.flds.data_ptr(), data.tab.data_ptr(),
        data.scale.data_ptr(), packed.data_ptr(), gr.data_ptr(), partials.data_ptr(),
        blocks.value, grad.data_ptr(), *_common_args(data, params, activation, hp), stream)
    build.raise_on(err, "dir_residual_bwd")
    return unpack_grads(grad, params, hp)


def _route(data: ResidualData) -> str:
    kind = data.xs.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"fused residual: unsupported device '{kind}'")
    return kind


def dir_residual_fwd(params, data: ResidualData, activation: str = "tanh"):
    """r [K]: the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if _route(data) == "cpu":
        return dir_residual_fwd_plain(params, data, activation)
    _check_kernel_args(params, data, activation)
    r = kernel_fwd(load_library(), params, data, activation,
                   torch.cuda.current_stream(data.xs.device).cuda_stream)
    dir_residual_fwd.launches += 1
    return r


def dir_residual_bwd(params, data: ResidualData, activation: str, gr):
    """Parameter gradients for cotangent gr [K]; dispatch as dir_residual_fwd."""
    if _route(data) == "cpu":
        return dir_residual_bwd_plain(params, data, activation, gr)
    _check_kernel_args(params, data, activation)
    grads = kernel_bwd(load_library(), params, data, activation, gr,
                       torch.cuda.current_stream(data.xs.device).cuda_stream)
    dir_residual_bwd.launches += 1
    return grads


dir_residual_fwd.launches = 0
dir_residual_bwd.launches = 0


class DirResidualFn(torch.autograd.Function):
    """r = residual(params); backward by the closed form (kernel or plain)."""

    @staticmethod
    def forward(ctx, data, activation, *flat):
        params = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
        ctx.data, ctx.activation = data, activation
        ctx.save_for_backward(*flat)
        return dir_residual_fwd(params, data, activation)

    @staticmethod
    def backward(ctx, gr):
        flat = ctx.saved_tensors
        params = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
        grads = dir_residual_bwd(params, ctx.data, ctx.activation, gr)
        return (None, None, *[g[k] for g in grads for k in ("w", "b")])


def fused_residual(params, data: ResidualData, activation: str = "tanh"):
    """Weak residual r [K] through :class:`DirResidualFn`, differentiable in
    ``params``; ``data`` from :func:`prepare_residual_data` (built once per
    ``train`` call)."""
    flat = [layer[k] for layer in params for k in ("w", "b")]
    return DirResidualFn.apply(data, activation, *flat)
