"""Fused weak residual: plain PyTorch versions + Hopper CUDA kernels.

Counterpart of the JAX package's ``ops/pallas_residual.py`` kernels: the
directional ones (``_dirq_residual_fn``, G > 1, and
``_fused_residual_fn(directional=True)``, G = 1, with ``n_ff = 0`` (K1/K2) or
behind a Fourier-feature embedding, ``n_ff > 0`` (K2-FF)), the
precomputed-coefficient kernel ``_dirp_residual_fn`` (K4) and the
jacobian-panel kernel ``_fused_residual_fn(directional=False)`` (K3).  For every
test function k they compute

    r_k = sum_q [ c(k,q) . du/dxs + cu(k,q) u + csrc(k,q) ]
          (+ w_q N_q u (b . grad u), the nonlinear advection term, K3 only),
    c_j = w_q scale_j (vel_j N_q + kappa dN_qj)   (j < d),   c_t = w_q scale_t N_q,
    cu  = w_q N_q react,   csrc = -w_q N_q src,

and the closed-form parameter backward (gradients flow to the parameters only;
the quadrature data is constant).  The directional kernels push ONE tangent,
along c, through the MLP beside the activations.  With Fourier features
(``ResidualData.bt`` = 2 pi B^T) layer 0 takes the embedding [sin | cos](bt xs)
and its tangent along c (``_embed_dir``).  K4 takes c, cu and csrc per point
from :func:`prepare_residual_coeffs` (:class:`CoeffData`), which folds into
them the test tables (shared [nQ] or per-node [K, nQ]: order-2 test spaces,
adaptively refined hats), the input scale and, for exact BC/IC, the ansatz
u = A + B n.  K3 (``ResidualData.jac``, set by ``jacobian``) pushes the value and
all n_in unit-tangent panels, so the integrand sees u and grad u themselves:
the Burgers term u (b . grad u), bilinear in them, has no single direction.

Two implementations share one signature:

* ``*_plain``: straightforward vectorised PyTorch (``dir_residual_*_plain``
  mirrors ``_dir_bwd_kernel`` step by step; ``jac_residual_*_plain`` is the
  plain K5 forward / backward with K3's integrand and its point cotangents).
* ``csrc/dir_residual.cu`` (K1/K2, K4) and ``csrc/ff_mlp.cu`` (K2-FF, K3, and
  K4 for nets wider than 64): hand-written CUDA for sm_90a, built with
  ``nvcc`` (``ops/build.py``, with every other ``csrc/*.cu``) into a plain-C
  shared library at first use and called through ``ctypes``.

``dir_residual_fwd`` / ``_bwd`` (K1/K2), ``dir_residual_ff_fwd`` / ``_bwd``
(K2-FF), ``dirp_residual_fwd`` / ``_bwd`` (K4), ``dirp_residual_ff_fwd`` /
``_bwd`` (K4 on ``ff_mlp.cu``, hidden width 65..256) and ``jac_residual_fwd`` /
``_bwd`` (K3) dispatch on the device of the data: CPU tensors take the plain
version, CUDA tensors launch the kernel (or raise), anything else raises.
Every one takes tanh, sigmoid and sin (SIREN nets; each CUDA source has sin
instantiations of its own, ``ff_mlp.cu``'s in ``csrc/ff_mlp_sin.cu``).
Each counts its kernel launches in ``.launches``; the backwards on ``ff_mlp.cu``
also count, in ``.wgmma_launches``, those that took its wgmma engine (the launcher
reports the engine it chose).  ``DirResidualFn`` is the
autograd glue for all of them (:func:`_residual_fns` picks the pair),
``fused_residual`` the loss's entry.  ``csrc/ff_mlp.cu`` also runs without an
embedding (``bt`` None: layer 0 reads the scaled coordinates): on CUDA a plain
net wider than ``dir_residual.cu`` takes (hidden width 65..256) goes through
its kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import build

MAX_IN = 4          # kernel's padded input width: n_in <= 4
MAX_HIDDEN = 64
ACTIVATIONS = {"tanh": 0, "sigmoid": 1, "sin": 2}


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
    bt: Optional[torch.Tensor] = None  # [F, n_in] 2 pi B^T of a Fourier-feature net
    nl: Optional[torch.Tensor] = None  # [d] f32 Burgers direction b (K3 only)
    jac: bool = False                  # the jacobian-panel residual K3


class CoeffData(NamedTuple):
    """Fixed per-point data of the precoeff residual (K4), p = k * nq + q.
    Built once per training call by :func:`prepare_residual_coeffs`."""

    xs: torch.Tensor               # [n_in, P] f32 scaled coordinates
    cdir: torch.Tensor             # [n_in, P] f32 direction c (zero rows: MOR inputs)
    csrc: torch.Tensor             # [P] f32 additive term
    cu: Optional[torch.Tensor]     # [P] f32 coefficient of u, or None
    k: int
    nq: int

    @property
    def bt(self):
        """No Fourier-feature embedding: K4 runs plain MLPs only."""
        return None


def _as_f32(a, device):
    """f32 tensor on ``device``; host arrays are cast to f32 on the host (and
    copied: they may be read-only), as the JAX package casts them."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=torch.float32, device=device)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def prepare_residual_data(quad, scale, shift, *, time_dependent: bool,
                          has_react: bool, device=None, fourier_bt=None, nl_vec=None,
                          jacobian: bool = False) -> ResidualData:
    """The kernel layout of a QuadData (NumPy arrays or tensors) with shared
    [nQ] tables and input scaling ``scale``/``shift`` (arrays or tensors, or
    both None: raw coordinates and a unit scale column, as the JAX package
    does without input scaling).  Coordinates are cast to f32 BEFORE scaling,
    as on the general path, so both round identically.  ``fourier_bt`` (2 pi
    B^T [F, n_in]) marks the data of a Fourier-feature net (kernel K2-FF).
    ``jacobian`` marks the data of the jacobian-panel residual K3
    (``_fused_residual_fn(directional=False)``), which takes no embedding;
    ``nl_vec`` (the constant [d] Burgers direction b) supplies its nonlinear
    term and needs ``jacobian=True``."""
    if quad.N.ndim != 1:
        raise ValueError("per-node test tables (test_order=2, refined hats) take the "
                         "precoeff residual: prepare_residual_coeffs")
    k, nq, n_in = quad.coords.shape
    d = quad.dN.shape[-1]
    jac = bool(jacobian)
    if nl_vec is not None and not jac:
        raise ValueError("nl_vec rides the jacobian-panel residual only: pass jacobian=True")
    if jac and fourier_bt is not None:
        raise ValueError("the jacobian-panel residual takes no Fourier-feature embedding")
    nl = None
    if nl_vec is not None:
        nl = torch.as_tensor(np.atleast_1d(np.asarray(nl_vec)), dtype=torch.float32,
                             device=device).reshape(-1)
        if nl.numel() != d:
            raise ValueError(f"nl_vec has {nl.numel()} entries; d={d}")
    dev = functools.partial(_as_f32, device=device)
    xs = dev(quad.coords)
    if scale is None:
        scale = torch.ones(n_in)
    else:
        xs = (xs - dev(shift)) * dev(scale)
    xs = xs.reshape(k * nq, n_in).T.contiguous()
    rows = [quad.kappa] + [quad.vel[:, :, j] for j in range(d)] + [quad.src]
    if has_react:
        rows.append(quad.react)
    flds = torch.stack([dev(a).reshape(k * nq) for a in rows])
    tab = torch.cat([dev(quad.N).reshape(nq, 1), dev(quad.w).reshape(nq, 1),
                     dev(quad.dN).reshape(nq, d)], dim=1)
    return ResidualData(xs, flds, tab.contiguous(), dev(scale).reshape(n_in).clone(),
                        int(k), int(nq), int(d),
                        bool(time_dependent), bool(has_react),
                        None if fourier_bt is None else dev(fourier_bt).contiguous(), nl, jac)


def prepare_residual_coeffs(quad, scale, shift, *, time_dependent: bool, has_react: bool,
                            hard=None, device=None) -> CoeffData:
    """The precoeff residual's data (K4) of a QuadData with shared [nQ] OR
    per-node [K, nQ] tables: the formulas and f32 casts of the JAX package's
    ``prepare_residual_coeffs``, in the port's [rows, P] layout.

    ``hard``: the exact-BC/IC tables (``fem/hardbc.py::HardQuad``, host f64
    or tensors) of the ansatz u = A + B n, which makes the residual affine in
    the raw net's outputs, so it folds into the coefficients:

        direction row j : w sc_j B (vel_j N + kappa dN_j),   time row: w sc_d B N
        cu   : w (Bt N + (vel . dB) N + kappa dB . dN [+ react B N])
        csrc : w ((At N + (vel . dA) N + kappa dA . dN [+ react A N]) - src N)

    (steady problems drop At / Bt).  cu is always present in hard mode.
    Inputs beyond x (and t), the MOR parameters, get zero direction rows."""
    k, nq, n_in = quad.coords.shape
    d = quad.dN.shape[-1]
    td = bool(time_dependent)
    dev = functools.partial(_as_f32, device=device)
    xs = dev(quad.coords)
    if scale is None:
        sc = torch.ones(n_in, device=xs.device)
    else:
        xs = (xs - dev(shift)) * dev(scale)
        sc = dev(scale).reshape(-1)

    def kq(a):  # a table, shared [nQ] or per-node [K, nQ], as [K, nQ]
        a = dev(a)
        return a.expand(k, nq) if a.ndim == 1 else a

    n_kq, w_kq = kq(quad.N), kq(quad.w)
    dn_kq = dev(quad.dN)
    if dn_kq.ndim == 2:
        dn_kq = dn_kq.expand(k, nq, d)
    kappa, vel, src = dev(quad.kappa), dev(quad.vel), dev(quad.src)
    if hard is None:
        rows = [w_kq * sc[j] * (vel[:, :, j] * n_kq + kappa * dn_kq[:, :, j])
                for j in range(d)]
        if td:
            rows.append(w_kq * sc[d] * n_kq)
        csrc = -w_kq * n_kq * src
        cu = w_kq * n_kq * dev(quad.react) if has_react else None
    else:
        B, dB, dA = dev(hard.B), dev(hard.dB), dev(hard.dA)
        rows = [w_kq * sc[j] * B * (vel[:, :, j] * n_kq + kappa * dn_kq[:, :, j])
                for j in range(d)]
        if td:
            rows.append(w_kq * sc[d] * B * n_kq)
        vdb = sum(vel[:, :, j] * dB[:, :, j] for j in range(d))
        kdbdn = sum(dB[:, :, j] * dn_kq[:, :, j] for j in range(d))
        vda = sum(vel[:, :, j] * dA[:, :, j] for j in range(d))
        kdadn = sum(dA[:, :, j] * dn_kq[:, :, j] for j in range(d))
        cu_kq = vdb * n_kq + kappa * kdbdn
        cs_kq = vda * n_kq + kappa * kdadn - src * n_kq
        if td:
            cu_kq = cu_kq + dev(hard.Bt) * n_kq
            cs_kq = cs_kq + dev(hard.At) * n_kq
        if has_react:
            react = dev(quad.react)
            cu_kq = cu_kq + react * B * n_kq
            cs_kq = cs_kq + react * dev(hard.A) * n_kq
        cu, csrc = w_kq * cu_kq, w_kq * cs_kq
    rows += [torch.zeros_like(kappa)] * (n_in - len(rows))
    return CoeffData(xs.reshape(k * nq, n_in).T.contiguous(),
                     torch.stack([r.reshape(k * nq) for r in rows]).contiguous(),
                     csrc.reshape(k * nq).contiguous(),
                     None if cu is None else cu.reshape(k * nq).contiguous(),
                     int(k), int(nq))


# ---------------------------------------------------------------------------
# plain PyTorch version


def _act_triple(activation):
    """(act, act'(z, a), act''(z, a, act')) of the kernels (the JAX package's
    ``pallas_mlp._act_pair``): tanh and sigmoid derive both from the output
    a, sin (SIREN nets) from the pre-activation z."""
    if activation == "tanh":
        return torch.tanh, (lambda z, a: 1.0 - a * a), (lambda z, a, sp: -2.0 * a * sp)
    if activation == "sigmoid":
        return (torch.sigmoid, (lambda z, a: a * (1.0 - a)),
                (lambda z, a, sp: (1.0 - 2.0 * a) * sp))
    if activation == "sin":
        return torch.sin, (lambda z, a: torch.cos(z)), (lambda z, a, sp: -a)
    raise ValueError(f"unknown activation '{activation}' (tanh|sigmoid|sin)")


def _dir_coeffs(data):
    """Per-point direction c [n_in, P], u coefficient cu [P] (or None) and
    source term csrc [P] — the math of ``_dir_coeffs``; a CoeffData (K4)
    carries them precomputed."""
    if isinstance(data, CoeffData):
        return data.cdir, data.cu, data.csrc
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


def _small_k(w, xs):
    """w [H, n] @ xs [n, P] as the sum over n in order (the JAX kernels'
    ``_small_k_mm``)."""
    acc = w[:, 0:1] * xs[0:1]
    for j in range(1, w.shape[1]):
        acc = acc + w[:, j:j + 1] * xs[j:j + 1]
    return acc


def _layer0_inputs(data: ResidualData, c):
    """The layer-0 input pair (x0, t0) [n, P]: the scaled points and the
    direction c, or under Fourier features the embedding [sin | cos](bt xs)
    and its directional tangent [cos | -sin](bt xs) * (bt c) (``_embed_dir``)."""
    if data.bt is None:
        return data.xs, c
    ang, pc = _small_k(data.bt, data.xs), _small_k(data.bt, c)
    sn, cs = torch.sin(ang), torch.cos(ang)
    return torch.cat([sn, cs]), torch.cat([cs * pc, -sn * pc])


def _forward_states(wts, bs, x0, t0, activation):
    """Hidden-layer pre-activations z_l, activations a_l and tangent
    pre-activations pre_l [H_l, P] from the layer-0 input pair (x0, t0)."""
    act, act_p, _ = _act_triple(activation)
    zs = [wts[0] @ x0 + bs[0]]
    acts, pres = [act(zs[0])], [wts[0] @ t0]
    for wt, b in zip(wts[1:-1], bs[1:-1]):
        t = act_p(zs[-1], acts[-1]) * pres[-1]
        zs.append(wt @ acts[-1] + b)
        acts.append(act(zs[-1]))
        pres.append(wt @ t)
    return zs, acts, pres


def dir_residual_fwd_plain(params, data, activation: str = "tanh"):
    """r [K] by plain PyTorch ops (any device); with ``data.bt`` the
    Fourier-feature net (the plain version of K2-FF), with a CoeffData the
    precomputed coefficients (K4's plain version, the forward of
    ``_dirp_fwd_kernel``: c = cdir, r_k = sum_q dd + csrc [+ cu u])."""
    _, act_p, _ = _act_triple(activation)
    wts, bs = _wt_layout(params)
    c, cu, csrc = _dir_coeffs(data)
    zs, acts, pres = _forward_states(wts, bs, *_layer0_inputs(data, c), activation)
    a = acts[-1]
    dd = (wts[-1] @ (act_p(zs[-1], a) * pres[-1]))[0]
    contrib = dd + csrc
    if cu is not None:
        contrib = contrib + cu * (wts[-1] @ a + bs[-1])[0]
    return contrib.reshape(data.k, data.nq).sum(dim=1)


def dir_residual_bwd_plain(params, data, activation: str, gr):
    """Closed-form parameter gradients for the cotangent gr [K]: a list of
    ``{'w', 'b'}`` in the parameters' layout.  Mirrors ``_dir_bwd_kernel``
    (with ``data.bt``: its Fourier-feature case, whose layer-0 weight gradient
    is taken against the embedded pair; with a CoeffData: K4's
    ``_dir_blocked_bwd``, c = cdir and the value cotangent gr * cu)."""
    _, act_p, act_pp = _act_triple(activation)
    wts, bs = _wt_layout(params)
    c, cu, _ = _dir_coeffs(data)
    x0, t0 = _layer0_inputs(data, c)
    zs, acts, pres = _forward_states(wts, bs, x0, t0, activation)
    g_tan = gr.repeat_interleave(data.nq)[None, :]             # [1, P]
    g_val = g_tan * cu if cu is not None else torch.zeros_like(g_tan)
    tans = [act_p(z, a) * pre for z, a, pre in zip(zs, acts, pres)]
    n = len(params)
    d_wts, d_bs = [None] * n, [None] * n
    d_wts[-1] = g_tan @ tans[-1].T + g_val @ acts[-1].T
    d_bs[-1] = g_val.sum(dim=1, keepdim=True)
    ga = wts[-1].T * g_val                                     # [H, P]
    gj = wts[-1].T * g_tan
    for l in range(n - 2, -1, -1):
        sp = act_p(zs[l], acts[l])
        spp = act_pp(zs[l], acts[l], sp)
        gz = sp * ga + spp * (gj * pres[l])
        gp = sp * gj
        x_in, t_in = (x0, t0) if l == 0 else (acts[l - 1], tans[l - 1])
        d_wts[l] = gz @ x_in.T + gp @ t_in.T
        d_bs[l] = gz.sum(dim=1, keepdim=True)
        if l > 0:
            ga = wts[l].T @ gz
            gj = wts[l].T @ gp
    return [{"w": dw.T, "b": db[:, 0]} for dw, db in zip(d_wts, d_bs)]


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch


@functools.lru_cache(maxsize=None)
def load_library(defines: tuple = ()) -> ctypes.CDLL:
    """The kernel library (every ``csrc/*.cu``, built once by ``ops/build.py``;
    ``defines``: a measurement build) with this module's entry points declared."""
    lib = build.load_library(defines)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vr_dir_residual_n_params.argtypes = [i32, i32]
    lib.vr_dir_residual_fwd.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
    lib.vr_dir_residual_bwd_blocks.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
    lib.vr_dir_residual_bwd.argtypes = [ptr] * 7 + [i32, ptr] + [i32] * 9 + [ptr]
    lib.vr_dirp_residual_fwd.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
    lib.vr_dirp_residual_bwd_blocks.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.vr_dirp_residual_bwd.argtypes = [ptr] * 7 + [i32, ptr] + [i32] * 7 + [ptr]
    lib.ff_n_params_c.argtypes = [i32] * 3
    lib.ff_res_fwd.argtypes = [ptr] * 8 + [i32] * 10 + [ptr]
    lib.ff_res_bwd_blocks.argtypes = [i32] * 7 + [ctypes.POINTER(i32)]
    lib.ff_res_bwd.argtypes = [ptr] * 8 + [i32, ptr] + [i32] * 10 + [ptr, ctypes.POINTER(i32)]
    lib.ff_pre_fwd.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    lib.ff_pre_bwd_blocks.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.ff_pre_bwd.argtypes = [ptr] * 7 + [i32, ptr] + [i32] * 6 + [ptr, ctypes.POINTER(i32)]
    lib.ff_jac_fwd.argtypes = [ptr] * 8 + [i32] * 9 + [ptr]
    lib.ff_jac_bwd_blocks.argtypes = [i32] * 7 + [ctypes.POINTER(i32)]
    lib.ff_jac_bwd.argtypes = [ptr] * 8 + [i32, ptr] + [i32] * 9 + [ptr, ctypes.POINTER(i32)]
    lib.ff_launch_shape.argtypes = ([i32, i32, ctypes.c_int64] + [i32] * 4
                                    + [ctypes.POINTER(i32)] * 4)
    lib.vr_launch_shape.argtypes = [i32] * 8 + [ctypes.POINTER(i32)]
    for fn in (lib.vr_dir_residual_n_params, lib.vr_dir_residual_fwd,
               lib.vr_dir_residual_bwd_blocks, lib.vr_dir_residual_bwd,
               lib.vr_dirp_residual_fwd, lib.vr_dirp_residual_bwd_blocks,
               lib.vr_dirp_residual_bwd, lib.ff_n_params_c,
               lib.ff_res_fwd, lib.ff_res_bwd_blocks, lib.ff_res_bwd,
               lib.ff_pre_fwd, lib.ff_pre_bwd_blocks, lib.ff_pre_bwd,
               lib.ff_jac_fwd, lib.ff_jac_bwd_blocks, lib.ff_jac_bwd, lib.ff_launch_shape,
               lib.vr_launch_shape):
        fn.restype = i32
    return lib


def padded_width(params) -> int:
    """Hidden width the kernel is instantiated for: the widest hidden layer
    rounded up to a multiple of 8."""
    return -(-max(layer["w"].shape[1] for layer in params[:-1]) // 8) * 8


def _offsets(hp: int, n_hidden: int):
    """(w offset, b offset) of each layer in the packed buffer (mirrors the
    vj_off_* helpers of csrc/tc3xtf32.cuh), and the padded total."""
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
    if not 1 <= n_in <= MAX_IN:
        raise ValueError(f"the fused residual kernel takes 1 <= n_in <= {MAX_IN}, got {n_in}")
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
    header of csrc/tc3xtf32.cuh)."""
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


def _fwd_buffers(data):
    """A residual forward's workspace, one contribution per point [K nq], and r [K]."""
    dev = data.xs.device
    return (torch.empty(data.k * data.nq, dtype=torch.float32, device=dev),
            torch.empty(data.k, dtype=torch.float32, device=dev))


def kernel_fwd(lib, params, data: ResidualData, activation: str, stream=None):
    """Launch the forward kernel of ``lib`` (no device dispatch; the caller
    guarantees the tensors suit it).  Returns r [K]."""
    hp, packed = _packed(lib, params)
    contrib, r = _fwd_buffers(data)
    err = lib.vr_dir_residual_fwd(
        data.xs.data_ptr(), data.flds.data_ptr(), data.tab.data_ptr(),
        data.scale.data_ptr(), packed.data_ptr(), contrib.data_ptr(), r.data_ptr(),
        *_common_args(data, params, activation, hp), stream)
    build.raise_on(err, "dir_residual_fwd")
    return r


def kernel_bwd(lib, params, data: ResidualData, activation: str, gr, stream=None):
    """Launch the backward kernels of ``lib``.  Returns ``{'w', 'b'}`` grads."""
    hp, packed = _packed(lib, params)
    n_hidden = len(params) - 1
    blocks = ctypes.c_int(0)
    raise_on_fit(params, lib.vr_dir_residual_bwd_blocks(
        data.k, data.nq, data.d, n_hidden, hp, ACTIVATIONS[activation], ctypes.byref(blocks)),
        f"dir_residual.cu dir_residual_bwd_blocks, {activation}")
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


def _route(data) -> str:
    """The device kind of ``data``: "cpu" (the plain versions) or "cuda" (the
    kernels, for every activation); anything else raises."""
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


# ---------------------------------------------------------------------------
# K4: the precoeff residual (csrc/dir_residual.cu, precoeff mode)


def _check_dirp_args(params, data: CoeffData, activation):
    """Raise on what K4's kernels do not take."""
    _act_triple(activation)
    n_in = data.xs.shape[0]
    if not 1 <= n_in <= MAX_IN:
        raise ValueError(f"the precoeff residual kernel takes 1 <= n_in <= {MAX_IN}, got {n_in}")
    if len(params) < 2 or params[-1]["w"].shape[1] != 1:
        raise ValueError("the precoeff residual kernel needs >= 1 hidden layer and 1 output")
    if params[0]["w"].shape[0] != n_in:
        raise ValueError(f"layer 0 takes {params[0]['w'].shape[0]} inputs, not {n_in}")
    widest = max(layer["w"].shape[1] for layer in params[:-1])
    if widest > MAX_HIDDEN:
        raise ValueError(
            f"hidden width {widest} > {MAX_HIDDEN} is not supported by dir_residual.cu's "
            "precoeff mode (wider nets take ff_mlp.cu's: dirp_residual_ff_fwd)")
    tensors = [data.xs, data.cdir, data.csrc] + ([] if data.cu is None else [data.cu])
    dev = data.xs.device
    for t in tensors + [layer[k] for layer in params for k in ("w", "b")]:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("the precoeff residual kernel takes f32 tensors on one device")
    _check_coeff_data(data)


def _dirp_args(data: CoeffData, params, activation, hp):
    return [data.k, data.nq, data.xs.shape[0], int(data.cu is not None), len(params) - 1, hp,
            ACTIVATIONS[activation]]


def kernel_dirp_fwd(lib, params, data: CoeffData, activation: str, stream=None):
    """Launch K4's forward of ``lib`` (no device dispatch).  Returns r [K]."""
    hp, packed = _packed(lib, params)
    contrib, r = _fwd_buffers(data)
    build.raise_on(lib.vr_dirp_residual_fwd(
        data.xs.data_ptr(), data.cdir.data_ptr(), data.csrc.data_ptr(), _ptr(data.cu),
        packed.data_ptr(), contrib.data_ptr(), r.data_ptr(),
        *_dirp_args(data, params, activation, hp), stream), "dirp_residual_fwd")
    return r


def kernel_dirp_bwd(lib, params, data: CoeffData, activation: str, gr, stream=None):
    """Launch K4's backward kernels of ``lib``.  Returns ``{'w', 'b'}`` grads."""
    hp, packed = _packed(lib, params)
    blocks = ctypes.c_int(0)
    raise_on_fit(params, lib.vr_dirp_residual_bwd_blocks(
        data.k, data.nq, len(params) - 1, hp, ACTIVATIONS[activation], ctypes.byref(blocks)),
        f"dir_residual.cu dirp_residual_bwd_blocks, {activation}")
    dev = data.xs.device
    partials = torch.empty(blocks.value * packed.numel(), dtype=torch.float32, device=dev)
    grad = torch.empty(packed.numel(), dtype=torch.float32, device=dev)
    gr = gr.detach().to(torch.float32).contiguous()
    build.raise_on(lib.vr_dirp_residual_bwd(
        data.xs.data_ptr(), data.cdir.data_ptr(), data.csrc.data_ptr(), _ptr(data.cu),
        packed.data_ptr(), gr.data_ptr(), partials.data_ptr(), blocks.value, grad.data_ptr(),
        *_dirp_args(data, params, activation, hp), stream), "dirp_residual_bwd")
    return unpack_grads(grad, params, hp)


def dirp_residual_fwd(params, data: CoeffData, activation: str = "tanh"):
    """K4: r [K] from precomputed coefficients: the CUDA kernel for CUDA
    tensors, the plain version for CPU ones."""
    if _route(data) == "cpu":
        return dir_residual_fwd_plain(params, data, activation)
    _check_dirp_args(params, data, activation)
    r = kernel_dirp_fwd(load_library(), params, data, activation,
                        torch.cuda.current_stream(data.xs.device).cuda_stream)
    dirp_residual_fwd.launches += 1
    return r


def dirp_residual_bwd(params, data: CoeffData, activation: str, gr):
    """K4's parameter gradients for cotangent gr [K]; dispatch as
    ``dirp_residual_fwd``."""
    if _route(data) == "cpu":
        return dir_residual_bwd_plain(params, data, activation, gr)
    _check_dirp_args(params, data, activation)
    grads = kernel_dirp_bwd(load_library(), params, data, activation, gr,
                            torch.cuda.current_stream(data.xs.device).cuda_stream)
    dirp_residual_bwd.launches += 1
    return grads


dirp_residual_fwd.launches = 0
dirp_residual_bwd.launches = 0


# ---------------------------------------------------------------------------
# K2-FF: the Fourier-feature net's residual (csrc/ff_mlp.cu, residual mode)

FF_MAX_HIDDEN = 256
FF_MAX_FEATURES = 128
# csrc/tc3xtf32.cuh's VJ_DOES_NOT_FIT: not even one block of the net fits in shared memory
# (ff_mlp.cu's launchers; the backward's block queries of dir_residual.cu and
# value_and_jac.cu, where sin keeps one more row per point and hidden layer: cos z)
DOES_NOT_FIT = 1001


def ff_dims(params, embedded: bool = True):
    """(hp, fp): hidden width padded to a multiple of 32 and the feature count
    padded to a multiple of 16, the widths csrc/ff_mlp.cu is run at; fp = 0
    for a net without an embedding."""
    hp = -(-max(layer["w"].shape[1] for layer in params[:-1]) // 32) * 32
    fp = -(-(params[0]["w"].shape[0] // 2) // 16) * 16 if embedded else 0
    return hp, fp


def ff_ke(fp: int) -> int:
    """Layer 0's packed input rows: 2 fp, or one 32-row K-slice holding the
    n_in <= 4 coordinates of a net without an embedding (fp = 0)."""
    return 2 * fp if fp else 32


@functools.lru_cache(maxsize=64)
def ff_pack_index(shapes, hp: int, fp: int, device):
    """(dst, total): the flat position in csrc/ff_mlp.cu's packed buffer of every
    element of the leaves ``w_0, b_0, w_1, b_1, ...`` concatenated (``shapes``:
    the w shapes), and the buffer size.  Weights keep the [fan_in, fan_out]
    layout, zero-padded to hp columns; layer 0's rows are the F sin features
    then the F cos features, each block padded to fp rows (fp = 0: the
    coordinates, padded to ``ff_ke(0)`` rows)."""
    ke, n_hidden = ff_ke(fp), len(shapes) - 1
    parts, off = [], 0
    for l, (fan_in, fan_out) in enumerate(shapes):
        rows = torch.arange(fan_in)
        if l == 0 and fp:
            f = fan_in // 2
            rows = torch.where(rows < f, rows, rows - f + fp)
        cols = hp if l < n_hidden else 1
        w_dst = off + rows[:, None] * cols + torch.arange(fan_out)[None, :]
        off += (ke if l == 0 else hp) * cols
        parts += [w_dst.reshape(-1), off + torch.arange(fan_out)]
        off += hp if l < n_hidden else 1
    return torch.cat(parts).to(device), -(-off // 4) * 4


def ff_pack(params, hp: int, fp: int) -> torch.Tensor:
    """Zero-padded packed buffer of ``params`` (or of a parameter tangent)."""
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    dst, total = ff_pack_index(tuple(tuple(layer["w"].shape) for layer in params), hp, fp,
                               leaves[0].device)
    buf = torch.zeros(total, dtype=torch.float32, device=leaves[0].device)
    buf[dst] = torch.cat([t.detach().reshape(-1) for t in leaves]).to(torch.float32)
    return buf


def ff_unpack(buf: torch.Tensor, params, hp: int, fp: int):
    """Packed gradient -> list of ``{'w', 'b'}`` in the parameters' shapes."""
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    dst, _ = ff_pack_index(tuple(tuple(layer["w"].shape) for layer in params), hp, fp,
                           buf.device)
    flat = buf[dst].split([t.numel() for t in leaves])
    return [{"w": flat[2 * l].view(layer["w"].shape), "b": flat[2 * l + 1]}
            for l, layer in enumerate(params)]


def ff_bt(bt: Optional[torch.Tensor], fp: int) -> Optional[torch.Tensor]:
    """2 pi B^T [F, n_in] zero-padded to the kernel's [fp, 4] (None: no embedding)."""
    if bt is None:
        return None
    out = torch.zeros((fp, 4), dtype=torch.float32, device=bt.device)
    out[:bt.shape[0], :bt.shape[1]] = bt
    return out


def check_ff_args(params, bt, tensors, activation):
    """Raise on what csrc/ff_mlp.cu does not take (``bt`` None: a net
    without an embedding on the points ``tensors[0]`` [n_in, P])."""
    _act_triple(activation)
    n_feat, n_in = (None, tensors[0].shape[0]) if bt is None else bt.shape
    if not 1 <= n_in <= 4:
        raise ValueError(f"the Fourier-feature kernels take 1 <= n_in <= 4, got {n_in}")
    if n_feat is not None and n_feat > FF_MAX_FEATURES:
        raise ValueError(f"{n_feat} Fourier features > {FF_MAX_FEATURES} are not supported")
    if len(params) < 2 or params[-1]["w"].shape[1] != 1:
        raise ValueError("the Fourier-feature kernels need >= 1 hidden layer and 1 output")
    fan_in = n_in if n_feat is None else 2 * n_feat
    if params[0]["w"].shape[0] != fan_in:
        raise ValueError(f"layer 0 takes {params[0]['w'].shape[0]} inputs, not {fan_in}")
    widest = max(layer["w"].shape[1] for layer in params[:-1])
    if widest > FF_MAX_HIDDEN:
        raise ValueError(f"hidden width {widest} > {FF_MAX_HIDDEN} is not supported by the "
                         "Fourier-feature kernels")
    dev = tensors[0].device
    for t in ((() if bt is None else (bt,)) + tuple(tensors)
              + tuple(layer[k] for layer in params for k in ("w", "b"))):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("the Fourier-feature kernels take f32 tensors on one device")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the Fourier-feature kernels take contiguous data")


def raise_on_fit(params, err: int, what: str):
    """Raise on a launcher's result: a ValueError naming the width and depth where
    the net does not fit a block's shared memory (:data:`DOES_NOT_FIT`), else as
    ``build.raise_on``."""
    if err == DOES_NOT_FIT:
        widest = max(layer["w"].shape[1] for layer in params[:-1])
        raise ValueError(f"hidden width {widest} at depth {len(params) - 1} needs more shared "
                         f"memory than a block has ({what})")
    build.raise_on(err, what)


def _ff_packed(lib, params, embedded: bool = True):
    hp, fp = ff_dims(params, embedded)
    packed = ff_pack(params, hp, fp)
    if packed.numel() != lib.ff_n_params_c(hp, ff_ke(fp), len(params) - 1):
        raise RuntimeError("packed parameter layout differs from ff_mlp.cu's")
    return hp, fp, packed


def ff_launch_shape(kind: str, panels: int, p: int, ke: int, n_hidden: int, hp: int,
                    activation: str = "tanh") -> dict:
    """The launch shape csrc/ff_mlp.cu takes on the current card for its stacked
    forward (``kind`` "fwd") or backward ("bwd") over ``panels`` panels (K2-FF and
    wide K4: 2; K7 and K3: 1 + n_in), or for K8 ("jvp", panels 1 + n_in), of the
    ``activation``'s instantiation: threads per block, blocks resident per SM,
    blocks of the grid and whether the backward takes its wgmma engine (False for the
    other kinds)."""
    out = [ctypes.c_int(0) for _ in range(4)]
    build.raise_on(load_library().ff_launch_shape(
        ("fwd", "bwd", "jvp").index(kind), panels, p, ke, n_hidden, hp,
        ACTIVATIONS[activation], *map(ctypes.byref, out)),
        "ff_launch_shape")
    threads, per_sm, blocks, wgmma = (v.value for v in out)
    return {"threads": threads, "blocks_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32,
            "blocks": blocks, "wgmma": bool(wgmma)}


def dir_launch_shape(kind: str, params, data, activation: str) -> dict:
    """The launch shape csrc/dir_residual.cu takes on the current card for the K1/K2
    (``ResidualData``) or K4 (``CoeffData``) forward (``kind`` "fwd") or backward
    ("bwd") of ``params`` on ``data``: threads per block, blocks resident per SM,
    warps per SM, blocks of the grid, points per tile and shared memory bytes per block."""
    shape = (ctypes.c_int * 5)()
    pre = isinstance(data, CoeffData)
    raise_on_fit(params, load_library().vr_launch_shape(
        ("fwd", "bwd").index(kind), data.k, data.nq, 0 if pre else data.d, len(params) - 1,
        padded_width(params), ACTIVATIONS[activation], int(pre), shape),
        f"dir_residual.cu dir_launch_shape, {activation}")
    threads, per_sm, blocks, tile, smem = shape
    return {"threads": threads, "blocks_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32,
            "blocks": blocks, "tile": tile, "smem_bytes": smem}


def _ff_res_args(data: ResidualData, params, activation, hp, fp):
    return [data.k, data.nq, data.xs.shape[0], data.d, int(data.td), int(data.has_react),
            ff_ke(fp), len(params) - 1, hp, ACTIVATIONS[activation]]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def kernel_ff_fwd(lib, params, data: ResidualData, activation: str, stream=None):
    """Launch K2-FF's forward of ``lib`` (no device dispatch).  Returns r [K]."""
    hp, fp, packed = _ff_packed(lib, params, data.bt is not None)
    bt = ff_bt(data.bt, fp)
    contrib, r = _fwd_buffers(data)
    raise_on_fit(params, lib.ff_res_fwd(
        data.xs.data_ptr(), data.flds.data_ptr(), data.tab.data_ptr(), data.scale.data_ptr(),
        _ptr(bt), packed.data_ptr(), contrib.data_ptr(), r.data_ptr(),
        *_ff_res_args(data, params, activation, hp, fp), stream), "dir_residual_ff_fwd")
    return r


def kernel_ff_bwd(lib, params, data: ResidualData, activation: str, gr, stream=None):
    """Launch K2-FF's backward of ``lib``.  Returns the ``{'w', 'b'}`` grads and
    whether the launch took the wgmma engine."""
    hp, fp, packed = _ff_packed(lib, params, data.bt is not None)
    dev = data.xs.device
    bt = ff_bt(data.bt, fp)
    blocks = ctypes.c_int(0)
    raise_on_fit(params, lib.ff_res_bwd_blocks(data.k, data.nq, data.d, ff_ke(fp),
                                               len(params) - 1, hp, ACTIVATIONS[activation],
                                               ctypes.byref(blocks)),
                 f"dir_residual_ff_bwd_blocks, {activation}")
    partials = torch.empty(blocks.value * packed.numel(), dtype=torch.float32, device=dev)
    grad = torch.empty(packed.numel(), dtype=torch.float32, device=dev)
    gr = gr.detach().to(torch.float32).contiguous()
    wgmma = ctypes.c_int(0)
    raise_on_fit(params, lib.ff_res_bwd(
        data.xs.data_ptr(), data.flds.data_ptr(), data.tab.data_ptr(), data.scale.data_ptr(),
        _ptr(bt), packed.data_ptr(), gr.data_ptr(), partials.data_ptr(), blocks.value,
        grad.data_ptr(), *_ff_res_args(data, params, activation, hp, fp), stream,
        ctypes.byref(wgmma)), "dir_residual_ff_bwd")
    return ff_unpack(grad, params, hp, fp), bool(wgmma.value)


def _check_ff_data(params, data: ResidualData, activation):
    check_ff_args(params, data.bt, (data.xs, data.flds, data.tab, data.scale), activation)


def dir_residual_ff_fwd(params, data: ResidualData, activation: str = "tanh"):
    """K2-FF: r [K] of the Fourier-feature net (``data.bt`` set; None: a plain
    net through the same kernels): the CUDA kernel for CUDA tensors, the plain
    version for CPU ones."""
    if _route(data) == "cpu":
        return dir_residual_fwd_plain(params, data, activation)
    _check_ff_data(params, data, activation)
    r = kernel_ff_fwd(load_library(), params, data, activation,
                      torch.cuda.current_stream(data.xs.device).cuda_stream)
    dir_residual_ff_fwd.launches += 1
    return r


def dir_residual_ff_bwd(params, data: ResidualData, activation: str, gr):
    """K2-FF's parameter gradients for cotangent gr [K]; dispatch as
    ``dir_residual_ff_fwd``."""
    if _route(data) == "cpu":
        return dir_residual_bwd_plain(params, data, activation, gr)
    _check_ff_data(params, data, activation)
    grads, wgmma = kernel_ff_bwd(load_library(), params, data, activation, gr,
                                 torch.cuda.current_stream(data.xs.device).cuda_stream)
    dir_residual_ff_bwd.launches += 1
    dir_residual_ff_bwd.wgmma_launches += wgmma
    return grads


dir_residual_ff_fwd.launches = 0
dir_residual_ff_bwd.launches = 0
dir_residual_ff_bwd.wgmma_launches = 0


# ---------------------------------------------------------------------------
# K4 for nets wider than 64 (csrc/ff_mlp.cu, precoeff mode)


def _check_coeff_data(data: CoeffData):
    """Raise on a CoeffData whose rows are not contiguous [n_in, P] / [P]."""
    tensors = [data.xs, data.cdir, data.csrc] + ([] if data.cu is None else [data.cu])
    p = data.k * data.nq
    if (any(not t.is_contiguous() for t in tensors) or data.xs.shape[1] != p
            or data.cdir.shape != data.xs.shape or any(t.shape != (p,) for t in tensors[2:])):
        raise ValueError("the precoeff residual data must be contiguous [n_in, P] / [P] rows")


def _check_dirp_ff_args(params, data: CoeffData, activation):
    """Raise on what ff_mlp.cu's precoeff mode does not take."""
    check_ff_args(params, None, [data.xs, data.cdir, data.csrc]
                  + ([] if data.cu is None else [data.cu]), activation)
    _check_coeff_data(data)


def _ff_pre_args(data: CoeffData, params, activation, hp):
    return [data.k, data.nq, data.xs.shape[0], len(params) - 1, hp, ACTIVATIONS[activation]]


def kernel_dirp_ff_fwd(lib, params, data: CoeffData, activation: str, stream=None):
    """Launch ff_mlp.cu's precoeff forward (K4, wide nets) of ``lib``: r [K]."""
    hp, _, packed = _ff_packed(lib, params, False)
    contrib, r = _fwd_buffers(data)
    raise_on_fit(params, lib.ff_pre_fwd(
        data.xs.data_ptr(), data.cdir.data_ptr(), data.csrc.data_ptr(), _ptr(data.cu),
        packed.data_ptr(), contrib.data_ptr(), r.data_ptr(),
        *_ff_pre_args(data, params, activation, hp), stream), "dirp_residual_ff_fwd")
    return r


def kernel_dirp_ff_bwd(lib, params, data: CoeffData, activation: str, gr, stream=None):
    """Launch ff_mlp.cu's precoeff backward (K4, wide nets): ``{'w', 'b'}`` grads and
    whether the launch took the wgmma engine."""
    hp, _, packed = _ff_packed(lib, params, False)
    dev = data.xs.device
    blocks = ctypes.c_int(0)
    raise_on_fit(params, lib.ff_pre_bwd_blocks(data.k, data.nq, len(params) - 1, hp,
                                               ACTIVATIONS[activation], ctypes.byref(blocks)),
                 f"dirp_residual_ff_bwd_blocks, {activation}")
    partials = torch.empty(blocks.value * packed.numel(), dtype=torch.float32, device=dev)
    grad = torch.empty(packed.numel(), dtype=torch.float32, device=dev)
    gr = gr.detach().to(torch.float32).contiguous()
    wgmma = ctypes.c_int(0)
    raise_on_fit(params, lib.ff_pre_bwd(
        data.xs.data_ptr(), data.cdir.data_ptr(), data.csrc.data_ptr(), _ptr(data.cu),
        packed.data_ptr(), gr.data_ptr(), partials.data_ptr(), blocks.value, grad.data_ptr(),
        *_ff_pre_args(data, params, activation, hp), stream, ctypes.byref(wgmma)),
        "dirp_residual_ff_bwd")
    return ff_unpack(grad, params, hp, 0), bool(wgmma.value)


def dirp_residual_ff_fwd(params, data: CoeffData, activation: str = "tanh"):
    """K4 for a plain net of hidden width 65..256 (csrc/ff_mlp.cu): the CUDA
    kernel for CUDA tensors, the plain version for CPU ones."""
    if _route(data) == "cpu":
        return dir_residual_fwd_plain(params, data, activation)
    _check_dirp_ff_args(params, data, activation)
    r = kernel_dirp_ff_fwd(load_library(), params, data, activation,
                           torch.cuda.current_stream(data.xs.device).cuda_stream)
    dirp_residual_ff_fwd.launches += 1
    return r


def dirp_residual_ff_bwd(params, data: CoeffData, activation: str, gr):
    """Its parameter gradients for cotangent gr [K]; dispatch as
    ``dirp_residual_ff_fwd``."""
    if _route(data) == "cpu":
        return dir_residual_bwd_plain(params, data, activation, gr)
    _check_dirp_ff_args(params, data, activation)
    grads, wgmma = kernel_dirp_ff_bwd(load_library(), params, data, activation, gr,
                                      torch.cuda.current_stream(data.xs.device).cuda_stream)
    dirp_residual_ff_bwd.launches += 1
    dirp_residual_ff_bwd.wgmma_launches += wgmma
    return grads


dirp_residual_ff_fwd.launches = 0
dirp_residual_ff_bwd.launches = 0
dirp_residual_ff_bwd.wgmma_launches = 0


# ---------------------------------------------------------------------------
# K3: the jacobian-panel residual (csrc/ff_mlp.cu, jacobian mode)
#
# value_and_jac imports this module, so its plain K5 functions are imported
# where they are called.


def _nl_terms(data: ResidualData, du):
    """(w_q N_q [P], b . grad u [P]) of the nonlinear term: grad u in the
    original coordinates is du/dxs_j * scale_j, j < d (never the time row or a
    MOR input)."""
    wn = (data.tab[:, 1] * data.tab[:, 0]).repeat(data.k)
    dub = None
    for j in range(data.d):
        term = (data.nl[j] * data.scale[j]) * du[j]
        dub = term if dub is None else dub + term
    return wn, dub


def jac_residual_fwd_plain(params, data: ResidualData, activation: str = "tanh"):
    """K3's plain version, r [K]: u and du/dxs by the plain K5 forward on the
    scaled points, then the integrand of ``_fused_fwd_kernel`` (the
    coefficients of ``_integrand_coeffs``, plus w N u (b . grad u) with
    ``data.nl``), summed over q."""
    from .value_and_jac import vj_fwd_plain

    out = vj_fwd_plain(params, data.xs, activation)
    u, du = out[0], out[1:]
    c, cu, contrib = _dir_coeffs(data)
    for j in range(c.shape[0]):
        contrib = contrib + c[j] * du[j]
    if cu is not None:
        contrib = contrib + cu * u
    if data.nl is not None:
        wn, dub = _nl_terms(data, du)
        contrib = contrib + wn * (u * dub)
    return contrib.reshape(data.k, data.nq).sum(dim=1)


def jac_residual_bwd_plain(params, data: ResidualData, activation: str, gr):
    """K3's plain parameter gradients for the cotangent gr [K]: the point
    cotangents of ``_fused_bwd_kernel``,
        g_u    = gr cu + gr w N (b . grad u),
        g_du_j = gr c_j + gr w N u b_j scale_j   (j < d; MOR rows get 0),
    handed to the plain K5 backward."""
    from .value_and_jac import vj_bwd_plain, vj_fwd_plain

    c, cu, _ = _dir_coeffs(data)
    g = gr.to(torch.float32).repeat_interleave(data.nq)
    rows = [g * cu if cu is not None else torch.zeros_like(g)]
    rows += [g * c[j] for j in range(c.shape[0])]
    if data.nl is not None:
        out = vj_fwd_plain(params, data.xs, activation)
        wn, dub = _nl_terms(data, out[1:])
        gw = g * wn
        rows[0] = rows[0] + gw * dub
        gcu = gw * out[0]
        for j in range(data.d):
            rows[1 + j] = rows[1 + j] + (data.nl[j] * data.scale[j]) * gcu
    return vj_bwd_plain(params, data.xs, activation, torch.stack(rows))


def _check_jac_data(params, data: ResidualData, activation):
    """Raise on what ff_mlp.cu's jacobian mode does not take."""
    extra = [] if data.nl is None else [data.nl]
    check_ff_args(params, None, [data.xs, data.flds, data.tab, data.scale] + extra, activation)
    if data.bt is not None:
        raise ValueError("the jacobian-panel residual takes no Fourier-feature embedding")
    if data.xs.shape[0] < data.d or (data.nl is not None and data.nl.shape != (data.d,)):
        raise ValueError("the jacobian-panel residual needs n_in >= d and a [d] nl vector")


def _ff_jac_args(data: ResidualData, params, activation, hp):
    return [data.k, data.nq, data.xs.shape[0], data.d, int(data.td), int(data.has_react),
            len(params) - 1, hp, ACTIVATIONS[activation]]


def kernel_jac_fwd(lib, params, data: ResidualData, activation: str, stream=None):
    """Launch K3's forward of ``lib`` (no device dispatch).  Returns r [K]."""
    hp, _, packed = _ff_packed(lib, params, False)
    contrib, r = _fwd_buffers(data)
    raise_on_fit(params, lib.ff_jac_fwd(
        data.xs.data_ptr(), data.flds.data_ptr(), data.tab.data_ptr(), data.scale.data_ptr(),
        _ptr(data.nl), packed.data_ptr(), contrib.data_ptr(), r.data_ptr(),
        *_ff_jac_args(data, params, activation, hp), stream), "jac_residual_fwd")
    return r


def kernel_jac_bwd(lib, params, data: ResidualData, activation: str, gr, stream=None):
    """Launch K3's backward of ``lib``.  Returns the ``{'w', 'b'}`` grads and whether
    the launch took the wgmma engine."""
    hp, _, packed = _ff_packed(lib, params, False)
    dev = data.xs.device
    blocks = ctypes.c_int(0)
    raise_on_fit(params, lib.ff_jac_bwd_blocks(data.k, data.nq, data.xs.shape[0], data.d,
                                               len(params) - 1, hp, ACTIVATIONS[activation],
                                               ctypes.byref(blocks)),
                 f"jac_residual_bwd_blocks, {activation}")
    partials = torch.empty(blocks.value * packed.numel(), dtype=torch.float32, device=dev)
    grad = torch.empty(packed.numel(), dtype=torch.float32, device=dev)
    gr = gr.detach().to(torch.float32).contiguous()
    wgmma = ctypes.c_int(0)
    raise_on_fit(params, lib.ff_jac_bwd(
        data.xs.data_ptr(), data.flds.data_ptr(), data.tab.data_ptr(), data.scale.data_ptr(),
        _ptr(data.nl), packed.data_ptr(), gr.data_ptr(), partials.data_ptr(), blocks.value,
        grad.data_ptr(), *_ff_jac_args(data, params, activation, hp), stream,
        ctypes.byref(wgmma)), "jac_residual_bwd")
    return ff_unpack(grad, params, hp, 0), bool(wgmma.value)


def jac_residual_fwd(params, data: ResidualData, activation: str = "tanh"):
    """K3: r [K] of the jacobian-panel residual (nonlinear advection with
    ``data.nl``): the CUDA kernel for CUDA tensors, the plain version for CPU
    ones."""
    if _route(data) == "cpu":
        return jac_residual_fwd_plain(params, data, activation)
    _check_jac_data(params, data, activation)
    r = kernel_jac_fwd(load_library(), params, data, activation,
                       torch.cuda.current_stream(data.xs.device).cuda_stream)
    jac_residual_fwd.launches += 1
    return r


def jac_residual_bwd(params, data: ResidualData, activation: str, gr):
    """K3's parameter gradients for cotangent gr [K]; dispatch as
    ``jac_residual_fwd``."""
    if _route(data) == "cpu":
        return jac_residual_bwd_plain(params, data, activation, gr)
    _check_jac_data(params, data, activation)
    grads, wgmma = kernel_jac_bwd(load_library(), params, data, activation, gr,
                                  torch.cuda.current_stream(data.xs.device).cuda_stream)
    jac_residual_bwd.launches += 1
    jac_residual_bwd.wgmma_launches += wgmma
    return grads


jac_residual_fwd.launches = 0
jac_residual_bwd.launches = 0
jac_residual_bwd.wgmma_launches = 0


def uses_ff_kernels(params, on_cuda: bool, embedded: bool) -> bool:
    """Whether a net runs on csrc/ff_mlp.cu: a Fourier-feature net, or on
    CUDA a plain net wider than dir_residual.cu / value_and_jac.cu take
    (the jacobian-panel residual K3 runs there at every width)."""
    return embedded or (on_cuda and len(params) > 1
                        and max(layer["w"].shape[1] for layer in params[:-1]) > MAX_HIDDEN)


def _residual_fns(params, data):
    """(forward, backward) wrappers for ``data``: K4 for a CoeffData (on CUDA
    through ff_mlp.cu for a net wider than 64); K3 for the jacobian-panel
    layout (``data.jac``, set by ``jacobian``); K1/K2 for a plain net, K2-FF's
    kernels when ``data.bt`` is set or, on CUDA, a plain net is wider than
    K1/K2 take."""
    if isinstance(data, CoeffData):
        if uses_ff_kernels(params, data.xs.is_cuda, False):
            return dirp_residual_ff_fwd, dirp_residual_ff_bwd
        return dirp_residual_fwd, dirp_residual_bwd
    if data.jac:
        return jac_residual_fwd, jac_residual_bwd
    if uses_ff_kernels(params, data.xs.is_cuda, data.bt is not None):
        return dir_residual_ff_fwd, dir_residual_ff_bwd
    return dir_residual_fwd, dir_residual_bwd


class DirResidualFn(torch.autograd.Function):
    """r = residual(params); backward by the closed form (kernel or plain),
    through the wrappers :func:`_residual_fns` picks."""

    @staticmethod
    def forward(ctx, data, activation, *flat):
        params = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
        ctx.data, ctx.activation = data, activation
        ctx.save_for_backward(*flat)
        fwd, ctx.bwd = _residual_fns(params, data)
        return fwd(params, data, activation)

    @staticmethod
    def backward(ctx, gr):
        flat = ctx.saved_tensors
        params = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
        grads = ctx.bwd(params, ctx.data, ctx.activation, gr)
        return (None, None, *[g[k] for g in grads for k in ("w", "b")])


def fused_residual(params, data, activation: str = "tanh"):
    """Weak residual r [K] through :class:`DirResidualFn`, differentiable in
    ``params``; ``data`` from :func:`prepare_residual_data` (K1/K2, K2-FF;
    K3 with ``jacobian``) or :func:`prepare_residual_coeffs`
    (K4), built once per ``train`` call."""
    flat = [layer[k] for layer in params for k in ("w", "b")]
    return DirResidualFn.apply(data, activation, *flat)
