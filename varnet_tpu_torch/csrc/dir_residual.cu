// Directional fused weak-residual kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels ops/pallas_residual.py::_dirq_residual_fn (q-blocked, G > 1)
// and ::_fused_residual_fn(directional=True) (G = 1, no Fourier features) of the JAX
// package (K1/K2, "table mode"), and ::_dirp_residual_fn, the precomputed-coefficient
// variant (K4, "precoeff mode").  All compute, for every test function k,
//
//     r_k = sum_q [ c(k,q) . du/dxs + cu(k,q) u + csrc(k,q) ],
//     c_j = w_q scale_j (vel_j N_q + kappa dN_qj)  (j < d),   c_t = w_q scale_t N_q,
//     cu  = w_q N_q react,                                       csrc = -w_q N_q src,
//
// where u is the MLP trial function at the scaled quadrature point xs and c . du/dxs
// is ONE forward-mode directional tangent pushed through the net alongside the
// activations (the 2-panel recurrence of _dir_forward_from).  The backward is the
// closed form of _dir_bwd_kernel: recompute the forward, back-propagate the pair
// (value, tangent) cotangents including the act'' term, and reduce the per-point
// outer products into dW/db.
//
// What bounds it: arithmetic.  At width (20, 20) forward plus backward is about 10 kFLOP
// per quadrature point against about 28 bytes read (3 coordinates + 4 field values), so
// the kernels sit far above the memory roofline and keep every intermediate on chip:
// nothing but one f32 per point and r (forward) and one gradient partial per block
// (backward) is written to device memory.
//
// Forward (vr_fwd_kernel): the hidden products on the tensor cores in 3xTF32, on stacked
// panels (csrc/tc3xtf32.cuh), as K5's forward: one warp per group of 16 points stacks
// their value and directional-tangent panels [a; t] as two 16-row tiles and pushes them
// through the hidden layers in place, with no block-wide sync; layer 0, the activations
// and the output row stay on the CUDA cores.  Points are tiled without regard to test
// functions: the warp writes each point's contribution, and vr_qsum_kernel sums each test
// function's nq of them (csrc/tc3xtf32.cuh), a warp per test function in a fixed order.  So the forward takes
// any nq, and its launch depends on none (one f32 per point written and read again:
// 35 MB at the flagship mesh, ~10 us of the card's memory time).
//
// Backward (vr_bwd_kernel): the hidden products on the tensor cores in 3xTF32, on
// stacked panels (csrc/tc3xtf32.cuh, the design of K5's backward with one tangent
// panel).  A block takes a tile of T points and stacks their value and directional-
// tangent panels [a; t] as the M = 2T rows of one operand.  Per hidden layer: the
// recompute Z = S W_l^T, the cotangents G_{l-1} = G_l W_l and the weight gradient
// dW_l += G_l^T S_{l-1} (depth M) run as mma.sync.m16n8k8 tiles; layer 0 (n_in <= 4), the
// output row, the activations and the epilogues gz = act' ga + (act''/act') gj t,
// gp = act' gj stay on the CUDA cores.  Each warp owns R fixed dW units -- a row block
// of 16 rows of dW_l over one of C chunks of the tile's rows, its A fragment split once
// per k-step for all HP / 8 column tiles -- and keeps their sums in registers for the
// block's whole walk over its tiles; the block writes one partial row per chunk (a net
// too deep for 2 units per warp sums 16 x 8 tiles in a shared-memory partial instead,
// R = 0, as K5's backward does).  The sums of the biases, layer 0's weights and the output
// row ride the epilogues, each thread summing its column over its share of the points.
// T, the threads per block and (R, C) come from the occupancy calculator (bwd_config,
// dw_plan).
//
// Precoeff mode (K4) reads c, csrc and cu per point from device memory instead of
// forming them from the field rows and the shared [nq] table: the host folded the test
// tables (shared [nq] or per-node [K, nq]: order-2 test spaces, refined hats), the input
// scale and, for exact BC/IC, the affine ansatz u = A + B n into them
// (ops/fused_residual.py::prepare_residual_coeffs).  Only the point reader (vr_load,
// vr_form) differs; the forward and backward bodies are K1's.  It reads 2 n_in + 1 floats
// per point (+ 1 for cu) against n_in + 2 + d (+ 1 for reaction) in table mode, still far
// below the work per point, so K4 is bound by operations like K1.
//
// TPU -> Hopper translation.  The TPU grid runs in order and sums dW across grid steps
// in place; here blocks run in no order, so the backward is persistent (each block
// walks a fixed, strided set of point tiles and accumulates its own partial) and a
// second kernel sums the partials in block order.  No atomics: the gradients are
// bit-reproducible for a given card.  The TPU's q-major lane layout, G-blocking with
// block-diagonal weights and VMEM tile pickers only fed the 128-row MXU and are gone:
// points are [rows, P] (P = K * nq, point p = k * nq + q), so loads are coalesced.
//
// Activations: tanh and sigmoid (act 0 / 1) share one instantiation per width, act'
// and act'' read back from the output a; sin (act 2, SIREN nets, the JAX kernels'
// activation="sin") has instantiations of its own (SIN), since act' = cos z is no
// function of a and the backward's act'' term is -a p, p the tangent's pre-activation.
// The forward keeps cos z in registers from the value tile for the tangent tile
// (vj_forward_group_sin); the backward keeps [a; p] in its slots and cos z in rows of its
// own (Cz, T per hidden layer: 1.5x the stacked state), and forms the tangent t = cos(z)
// p as the products load it (vj_stack_layer_sin, vj_dw_rows_by).  Keeping t as well,
// or forming p again as the JAX kernel does, would double the state or the recompute;
// dividing t by cos z fails where cos z vanishes.
//
// Hidden widths are zero-padded to HP (a multiple of 8, at most 64): padded units carry
// zero weights and biases, contribute exactly nothing, and get gradients that the
// wrapper discards.  Packed parameter layout: see csrc/tc3xtf32.cuh; the gradient uses
// the same layout.  varnet_tpu_torch/ops/fused_residual.py mirrors it.

#include "tc3xtf32.cuh"

#define VR_MAX_IN VJ_MAX_IN

struct VrProblem {
  const float* xs;     // [n_in][P] scaled coordinates
  const float* flds;   // table mode: [2 + d (+1)][P]: kappa, vel_0..vel_{d-1}, src[, react]
  const float* tab;    // table mode: [nq][2 + d]: N, w, dN_0..dN_{d-1}
  const float* scale;  // table mode: [n_in]
  const float* cdir;   // precoeff mode: [n_in][P] directions (zero rows for MOR inputs)
  const float* csrc;   // precoeff mode: [P] additive term
  const float* cu;     // precoeff mode: [P] coefficient of u (when has_react)
  long long P;         // K * nq
  int k, nq, n_in, d, td, has_react, n_hidden, act, pre;
};

// Floats of the shared-memory quadrature table (none in precoeff mode), padded to 4.
__host__ __device__ inline int vr_tab_floats(const VrProblem& pb) {
  return pb.pre ? 0 : (pb.nq * (2 + pb.d) + 3) / 4 * 4;
}

// Cooperative load of the quadrature table and the input scale (table mode).
__device__ __forceinline__ void vr_load_tab(const VrProblem& pb, float* sTab, float* sScale) {
  if (pb.pre) return;
  const int ntab = pb.nq * (2 + pb.d);
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) sTab[i] = pb.tab[i];
  if (threadIdx.x < VR_MAX_IN)
    sScale[threadIdx.x] = threadIdx.x < pb.n_in ? pb.scale[threadIdx.x] : 0.0f;
}

// The raw inputs of point p = k nq + q, zeros for an invalid point (p >= P): the scaled
// coordinates x; in precoeff mode the direction v = cdir and f = (csrc, cu); in table mode
// the velocity v and f = (kappa, src, react).  Only loads from device memory, so a
// prefetch of the next tile's inputs does not wait for them.
struct VrRaw {
  float x[VR_MAX_IN], v[VR_MAX_IN], f[3];
  int q;
};

__device__ __forceinline__ void vr_load(const VrProblem& pb, long long p, int q, bool valid,
                                        VrRaw& in) {
#pragma unroll
  for (int j = 0; j < VR_MAX_IN; ++j) in.x[j] = in.v[j] = 0.0f;
  in.f[0] = in.f[1] = in.f[2] = 0.0f;
  in.q = valid ? q : 0;
  if (!valid) return;
#pragma unroll
  for (int j = 0; j < VR_MAX_IN; ++j)
    if (j < pb.n_in) in.x[j] = pb.xs[j * pb.P + p];
  if (pb.pre) {
#pragma unroll
    for (int j = 0; j < VR_MAX_IN; ++j)
      if (j < pb.n_in) in.v[j] = pb.cdir[j * pb.P + p];
    in.f[0] = pb.csrc[p];
    if (pb.has_react) in.f[1] = pb.cu[p];
    return;
  }
  in.f[0] = pb.flds[p];
#pragma unroll
  for (int j = 0; j < VR_MAX_IN; ++j)
    if (j < pb.d) in.v[j] = pb.flds[(1 + j) * pb.P + p];
  in.f[1] = pb.flds[(1 + pb.d) * pb.P + p];
  if (pb.has_react) in.f[2] = pb.flds[(2 + pb.d) * pb.P + p];
}

// The direction c and the u / source coefficients of a point from its raw inputs: read
// (precoeff mode) or formed from the fields and row q of the table (the math of
// _dir_coeffs).
__device__ __forceinline__ void vr_form(const VrProblem& pb, const float* sTab,
                                        const float* sScale, const VrRaw& in,
                                        float c[VR_MAX_IN], float& cu, float& csrc) {
  if (pb.pre) {
#pragma unroll
    for (int j = 0; j < VR_MAX_IN; ++j) c[j] = in.v[j];
    csrc = in.f[0];
    cu = in.f[1];
    return;
  }
  const float* row = sTab + in.q * (2 + pb.d);
  const float n_q = row[0], w_q = row[1], kappa = in.f[0];
#pragma unroll
  for (int j = 0; j < VR_MAX_IN; ++j) {
    c[j] = 0.0f;
    if (j < pb.d)
      c[j] = w_q * sScale[j] * (in.v[j] * n_q + kappa * row[2 + j]);
    else if (j == pb.d && pb.td)
      c[j] = w_q * sScale[j] * n_q;
  }
  csrc = -w_q * n_q * in.f[1];
  cu = pb.has_react ? w_q * n_q * in.f[2] : 0.0f;
}

// ------------------------------------------------------------------------------------
// Forward, persistent, one warp per group of 16 points (as K5's forward): the group's
// value and directional-tangent tiles [a; t] (rows t, then 16 + t) in one slot of the
// warp's own that every hidden layer overwrites in place (vj_forward_tile, the value tile
// first: the tangent tile reads act'(a) from the value rows the same lanes wrote), no
// block-wide sync after the parameters are loaded.  Shared memory: the small parameters,
// W_l (f32, [out][LD]), and per warp the group's coordinates X [16][4], directions C
// [16][4] and its slot [32][LD].  Lane t < 16 loads point t's raw inputs of group j + 1
// into registers (vr_load) while group j is computed, and forms c from them with the
// table row (vr_form; the table straight from device memory, cached: nothing here is
// sized by nq) when its turn comes.  Output: lane r takes row r's dot product with w_out
// in four chains added pairwise (u on the value rows, dd = w_out . t on the tangent rows),
// and lane t writes contrib[p] = dd + csrc (+ cu u); vr_qsum_kernel sums each test
// function's nq contributions.  SIN: the activation is sin (pb.act 2), whose act' = cos z
// the hidden layers keep in registers from the value tile for the tangent tile
// (vj_forward_group_sin); the slot and its size are the same.
template <int HP, bool SIN>
__global__ void __launch_bounds__(256)
    vr_fwd_kernel(VrProblem pb, const float* __restrict__ params, float* __restrict__ contrib,
                  long long n_groups) {
  constexpr int LD = kVjLd<HP>;
  extern __shared__ float4 vr_smem4[];
  float* smem = reinterpret_cast<float*>(vr_smem4);
  const int Lh = pb.n_hidden, act = pb.act;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  float* sSm = smem;
  float* sW = sSm + vj_small_size(HP, Lh);
  float4* X = reinterpret_cast<float4*>(sW + (Lh - 1) * HP * LD +
                                        warp * (2 * VR_MAX_IN * 16 + 32 * LD));
  float4* C = X + 16;
  float* S = reinterpret_cast<float*>(C + 16);
  vj_load_params<HP>(params, Lh, sSm, sW);
  __syncthreads();
  const float4* W0 = reinterpret_cast<const float4*>(sSm);
  const float4* wout4 = reinterpret_cast<const float4*>(sSm + 4 * HP + Lh * HP);
  const float bout = sSm[4 * HP + Lh * HP + HP];
  float scale[VR_MAX_IN];
#pragma unroll
  for (int j = 0; j < VR_MAX_IN; ++j) scale[j] = !pb.pre && j < pb.n_in ? pb.scale[j] : 0.0f;
  const long long stride = (long long)gridDim.x * nwarp;
  VrRaw raw;
  auto fetch = [&](long long grp) {
    const long long p = grp * 16 + (lane & 15);
    const bool valid = lane < 16 && p < pb.P;
    const int q = valid && !pb.pre ? (int)(p % pb.nq) : 0;
    vr_load(pb, p, q, valid, raw);
  };
  long long grp = (long long)blockIdx.x * nwarp + warp;
  fetch(grp);
  for (; grp < n_groups; grp += stride) {
    float c[VR_MAX_IN], cu, csrc;
    vr_form(pb, pb.tab, scale, raw, c, cu, csrc);
    if (lane < 16) {
      X[lane] = make_float4(raw.x[0], raw.x[1], raw.x[2], raw.x[3]);
      C[lane] = make_float4(c[0], c[1], c[2], c[3]);
    }
    __syncwarp();
    fetch(grp + stride);
    // layer 0 on the CUDA cores: a_0 = act(W0 x + b0), t_0 = act'(a_0) W0 c
    for (int e = lane; e < 16 * HP; e += 32) {
      const int t = e / HP, i = e % HP;
      const float4 w = W0[i], x = X[t], d = C[t];
      float z = sSm[4 * HP + i], pre = 0.0f;
      z = fmaf(w.x, x.x, z);
      pre = fmaf(w.x, d.x, pre);
      z = fmaf(w.y, x.y, z);
      pre = fmaf(w.y, d.y, pre);
      z = fmaf(w.z, x.z, z);
      pre = fmaf(w.z, d.z, pre);
      z = fmaf(w.w, x.w, z);
      pre = fmaf(w.w, d.w, pre);
      float a, sp;
      vj_act_sp<SIN>(z, act, a, sp);
      S[t * LD + i] = a;
      S[(16 + t) * LD + i] = sp * pre;
    }
    __syncwarp();
    for (int l = 1; l < Lh; ++l) {
      const float* W = sW + (l - 1) * HP * LD;
      const float* b = sSm + 4 * HP + l * HP;
      if constexpr (SIN) {
        vj_forward_group_sin<HP>(S, 2, W, b);
      } else {
        vj_forward_tile<HP>(S, S, W, b, true, nullptr, act);
        vj_forward_tile<HP>(S + 16 * LD, S + 16 * LD, W, b, false, S, act);
      }
    }
    __syncwarp();
    // the output row, four chains (a cancelling row shows one long chain's rounding);
    // the 16-byte reads of the rows at stride LD are conflict-free
    const float4* s4 = reinterpret_cast<const float4*>(S + lane * LD);
    float as[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i4 = 0; i4 < HP / 4; ++i4) {
      const float4 a = s4[i4], w = wout4[i4];
      as[0] = fmaf(w.x, a.x, as[0]);
      as[1] = fmaf(w.y, a.y, as[1]);
      as[2] = fmaf(w.z, a.z, as[2]);
      as[3] = fmaf(w.w, a.w, as[3]);
    }
    const float v = (as[0] + as[1]) + (as[2] + as[3]);
    const float dd = __shfl_down_sync(0xffffffffu, v, 16);
    const long long p = grp * 16 + lane;
    if (lane < 16 && p < pb.P) {
      float out = dd + csrc;
      if (pb.has_react) out = fmaf(cu, v + bout, out);
      contrib[p] = out;
    }
    __syncwarp();
  }
}

// The backward's inputs of point p (zeros past P): coordinates x, direction c and the
// output cotangents g_val = gr cu (0 without reaction) and g_tan = gr.
struct VrIn {
  float x[VR_MAX_IN], c[VR_MAX_IN], g_val, g_tan;
};

__device__ __forceinline__ void vr_bwd_point(const VrProblem& pb, const float* sTab,
                                             const float* sScale, const float* gr, long long p,
                                             VrIn& in) {
  const bool valid = p < pb.P;
  const long long k = valid ? p / pb.nq : 0;
  VrRaw raw;
  vr_load(pb, p, (int)(p - k * pb.nq), valid, raw);
#pragma unroll
  for (int j = 0; j < VR_MAX_IN; ++j) in.x[j] = raw.x[j];
  float cu, csrc;
  vr_form(pb, sTab, sScale, raw, in.c, cu, csrc);
  in.g_tan = valid ? gr[k] : 0.0f;
  in.g_val = pb.has_react ? in.g_tan * cu : 0.0f;
}

// ------------------------------------------------------------------------------------
// Backward, persistent over tiles of T points (a multiple of 16).  Shared memory:
//   sGg  [G][small]         per epilogue group g: the partial of W0, the biases, w_out and
//                           b_out (layout of vj_small_size)
//   sGW  [Lh-1][HP][HP]     R == 0 only: the partial of the hidden W_l
//   sSm, sW                 the small parameters and W_l (f32, [out][LD])
//   sTab, sScale            table mode: the quadrature table and the input scale
//   X, C [4][T], GO [2][T]  the tile's coordinates, directions and output cotangents
//                           (g_val, g_tan)
//   S    [Lh][2T][LD]       slot l: [a_l; t_l] (rows t, then T + t); going down
//                           [gz_l; gp_l], then G_{l-1} = [ga; gj] of the layer below.
//   Cz   [Lh][T][LD]        SIN only: cos z_l; slot l then keeps the tangent's
//                           pre-activation p_l in place of t_l = cos(z_l) p_l, which the
//                           products form as they load (vj_stack_layer_sin,
//                           vj_dw_rows_by): the act'' term is -a p, and where cos z
//                           vanishes no function of (a, t) gives p.
// The epilogues run on G = blockDim / HP groups of HP threads, thread (g, i) on column i
// of points t = g, g + G, ...; it sums its share of db_l, dW0, dw_out and b_out over the
// whole walk (in registers, db_l in its group's shared partial), and the groups' sums
// are added in group order at the end.  Each warp owns the dW units (layer l >= 1, row
// block of 16 rows, chunk c of the tile's 2T rows) un = warp + k nwarp, k < R, of
// the list over all hidden layers, and sums each unit's HP / 8 tiles in dw[k] over the
// whole walk; the block writes one partial row per chunk.  Point tile j + 1's inputs are
// read into registers while tile j is computed.
template <int HP, int R, bool SIN>
__global__ void __launch_bounds__(256, 2)
    vr_bwd_kernel(VrProblem pb, const float* __restrict__ params,
                  const float* __restrict__ gr, float* __restrict__ partials,
                  long long n_tiles, int T, int chunks) {
  constexpr int LD = kVjLd<HP>;
  constexpr int NT = HP / 8, MT = (HP + 15) / 16;
  constexpr int U = MT * NT;  // dW_l tiles per layer (R == 0)
  extern __shared__ float4 vr_smem4[];
  float* smem = reinterpret_cast<float*>(vr_smem4);
  const int Lh = pb.n_hidden, act = pb.act;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, nwarp = nthr >> 5;
  const int lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int rows = 2 * T, slot = rows * LD, nsm = vj_small_size(HP, Lh);
  const int G = nthr / HP, eg = tid / HP, ei = tid % HP;
  const bool ep = eg < G;  // this thread runs epilogue column ei of group eg
  const int nw = R == 0 ? (Lh - 1) * HP * HP : 0;
  float* sGg = smem;
  float* sGW = sGg + G * nsm;
  float* sSm = sGW + nw;
  float* sW = sSm + nsm;
  float* sTab = sW + (Lh - 1) * HP * LD;
  float* sScale = sTab + vr_tab_floats(pb);
  float* X = sScale + VR_MAX_IN;
  float* C = X + VR_MAX_IN * T;
  float* GO = C + VR_MAX_IN * T;
  float* S = GO + 2 * T;
  float* Cz = S + Lh * slot;  // SIN only
  for (int u = tid; u < G * nsm + nw; u += nthr) sGg[u] = 0.0f;
  vj_load_params<HP>(params, Lh, sSm, sW);
  vr_load_tab(pb, sTab, sScale);
  __syncthreads();
  const float* W0 = sSm;
  const float* wout = sSm + 4 * HP + Lh * HP;
  float dw[R > 0 ? R : 1][NT][4];
#pragma unroll
  for (int k = 0; k < (R > 0 ? R : 1); ++k) vj_zero<HP>(dw[k]);
  float s_w0[VR_MAX_IN] = {0.0f, 0.0f, 0.0f, 0.0f}, s_wout = 0.0f, s_bout = 0.0f;
  VrIn in;
  if (tid < T) vr_bwd_point(pb, sTab, sScale, gr, (long long)blockIdx.x * T + tid, in);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    if (tid < T) {
#pragma unroll
      for (int j = 0; j < VR_MAX_IN; ++j) {
        X[j * T + tid] = in.x[j];
        C[j * T + tid] = in.c[j];
      }
      GO[tid] = in.g_val;
      GO[T + tid] = in.g_tan;
    }
    __syncthreads();
    if (tid < T) vr_bwd_point(pb, sTab, sScale, gr, (tile + gridDim.x) * T + tid, in);
    // forward recompute, every layer's slot kept.  Layer 0 on the CUDA cores: a_0 =
    // act(W0 x + b0), t_0 = act'(a_0) W0 c (SIN: p_0 = W0 c and cos z_0); the hidden
    // layers on the tensor cores
    for (int u = tid; u < T * HP; u += nthr) {
      const int t = u / HP, i = u % HP;
      float z = sSm[4 * HP + i], pre = 0.0f;
#pragma unroll
      for (int c = 0; c < VR_MAX_IN; ++c) {
        z = fmaf(W0[i * 4 + c], X[c * T + t], z);
        pre = fmaf(W0[i * 4 + c], C[c * T + t], pre);
      }
      float a, sp;
      vj_act_sp<SIN>(z, act, a, sp);
      S[t * LD + i] = a;
      if constexpr (SIN) {
        S[(T + t) * LD + i] = pre;
        Cz[t * LD + i] = sp;
      } else {
        S[(T + t) * LD + i] = sp * pre;
      }
    }
    __syncthreads();
    for (int l = 1; l < Lh; ++l) {
      if constexpr (SIN)
        vj_stack_layer_sin<HP>(S + (l - 1) * slot, Cz + (l - 1) * T * LD, S + l * slot,
                               Cz + l * T * LD, sW + (l - 1) * HP * LD, sSm + 4 * HP + l * HP,
                               T, 2);
      else
        vj_stack_layer<HP>(S + (l - 1) * slot, S + l * slot, sW + (l - 1) * HP * LD,
                           sSm + 4 * HP + l * HP, T, 2, act);
    }

    for (int l = Lh - 1; l >= 0; --l) {
      float* Sl = S + l * slot;
      const float* Gin = S + (l + 1) * slot;  // G_l = [ga; gj]_l, below the top layer
      const bool top = l == Lh - 1;
      // epilogue on the CUDA cores, in place: [a; t]_l -> [gz; gp]_l with
      // gz = act' ga + (act''/act') gj t and gp = act' gj (SIN: [a; p]_l, gz = cos(z) ga
      // - a gj p); the sums of db_l (and at the top the output row's dw_out += g_val a +
      // g_tan t, db_out += g_val; at layer 0 dW0 += gz x^T + gp c^T)
      if (ep) {
        float db = 0.0f;
        for (int t = eg; t < T; t += G) {
          const int r = t * LD + ei;  // the value row; the tangent's T rows on
          const float a = Sl[r], tt = Sl[r + T * LD];
          const float sp = SIN ? Cz[l * T * LD + t * LD + ei] : vj_dact(a, act);
          float ga, gj;
          if (top) {
            const float gv = GO[t], gt = GO[T + t];
            ga = wout[ei] * gv;
            gj = wout[ei] * gt;
            s_wout = fmaf(gv, a, fmaf(gt, SIN ? sp * tt : tt, s_wout));
            s_bout += gv;
          } else {
            ga = Gin[r];
            gj = Gin[r + T * LD];
          }
          const float gz = SIN ? fmaf(sp, ga, -a * (gj * tt))
                               : fmaf(sp, ga, vj_ddact_ratio(a, act) * (gj * tt));
          const float gp = sp * gj;
          Sl[r] = gz;
          Sl[r + T * LD] = gp;
          db += gz;
          if (l == 0) {
#pragma unroll
            for (int c = 0; c < VR_MAX_IN; ++c)
              s_w0[c] = fmaf(gz, X[c * T + t], fmaf(gp, C[c * T + t], s_w0[c]));
          }
        }
        sGg[eg * nsm + 4 * HP + l * HP + ei] += db;
      }
      __syncthreads();
      if (l == 0) break;
      // dW_l += G_l^T S_{l-1} on the tensor cores: a row block (16 rows of dW_l) over one
      // of `chunks` chunks of the tile's rows per warp unit, or (R == 0) one 16 x 8 tile over
      // all rows
      const float* Sp = S + (l - 1) * slot;
      const float* Cp = Cz + (l - 1) * T * LD;  // SIN: S_{l-1}'s tangent rows are Cp Sp
      const auto sp_sin = [&](int r, int i) { return vj_sin_operand<HP>(Sp, Cp, T, r, i); };
      if constexpr (R > 0) {
        const int rc = rows / chunks;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int un = warp + k * nwarp;
          if (un / (MT * chunks) == l - 1) {
            const int v = un % (MT * chunks), c = v % chunks;
            float acc[NT][4];
            if constexpr (SIN)
              vj_dw_rows_by<HP>(
                  acc, Sl + c * rc * LD, [&](int r, int i) { return sp_sin(c * rc + r, i); },
                  rc, (v / chunks) * 16);
            else
              vj_dw_rows<HP>(acc, Sl + c * rc * LD, Sp + c * rc * LD, rc, (v / chunks) * 16);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) vj_add(dw[k][nt], acc[nt]);
          }
        }
      } else {
        float* gw = sGW + (l - 1) * HP * HP;
        for (int v = warp; v < U; v += nwarp) {
          const int j0 = (v / NT) * 16, i0 = (v % NT) * 8;
          float acc[4];
          if constexpr (SIN)
            vj_dw_tile_by<HP>(acc, Sl, sp_sin, rows, j0, i0);
          else
            vj_dw_tile<HP>(acc, Sl, Sp, rows, j0, i0);
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int j = j0 + gq + (h & 2 ? 8 : 0), i = i0 + 2 * q + (h & 1);
            if (j < HP) gw[j * HP + i] += acc[h];
          }
        }
      }
      __syncthreads();
      // G_{l-1} = G_l W_l, in place in slot l
      vj_cotangent_rows<HP>(Sl, sW + (l - 1) * HP * LD, rows);
    }
    __syncthreads();
  }

  // the block's partials, in the packed layout: rows chunks b + c, one per chunk c, each
  // with chunk c's dW sums; row chunks b also with the groups' sums of the small
  // parameters, in group order (the other rows hold zeros there)
  if (ep) {
    float* mine = sGg + eg * nsm;
#pragma unroll
    for (int c = 0; c < VR_MAX_IN; ++c) mine[ei * 4 + c] = s_w0[c];
    mine[4 * HP + Lh * HP + ei] = s_wout;
    if (ei == 0) mine[4 * HP + Lh * HP + HP] = s_bout;
  }
  __syncthreads();
  const int npp = vj_n_params(HP, Lh), ow = vj_off_wout(HP, Lh);
  float* out = partials + (long long)blockIdx.x * chunks * npp;
  for (int c = 0; c < chunks; ++c) {
    float* row = out + (long long)c * npp;
    for (int e = tid; e <= 4 * HP + Lh * HP + HP; e += nthr) {
      float v = 0.0f;
      for (int g = 0; c == 0 && g < G; ++g) v += sGg[g * nsm + e];
      const int b = e - 4 * HP;
      row[e < 4 * HP ? e : (b < Lh * HP ? vj_off_b(HP, b / HP) + b % HP : ow + b - Lh * HP)] = v;
    }
    for (int u = ow + HP + 1 + tid; u < npp; u += nthr) row[u] = 0.0f;
  }
  if constexpr (R > 0) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int un = warp + k * nwarp;
      if (un < MT * chunks * (Lh - 1)) {
        const int l = 1 + un / (MT * chunks), v = un % (MT * chunks), j0 = (v / chunks) * 16;
        float* row = out + (long long)(v % chunks) * npp + vj_off_w(HP, l);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int j = j0 + gq + (h & 2 ? 8 : 0), i = nt * 8 + 2 * q + (h & 1);
            if (j < HP) row[j * HP + i] = dw[k][nt][h];
          }
      }
    }
  } else {
    for (int u = tid; u < nw; u += nthr)
      out[vj_off_w(HP, 1 + u / (HP * HP)) + u % (HP * HP)] = sGW[u];
  }
}

// grad[i] = sum_b partials[b][i], in block order.
__global__ void vr_reduce_kernel(const float* __restrict__ partials, float* __restrict__ grad,
                                 int n_blocks, int npp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npp) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(long long)b * npp + i];
  grad[i] = s;
}

// ---- host launchers ----------------------------------------------------------------

namespace {

const int kTileChoices[] = {64, 32, 16};  // points per backward tile
const int kTileThreads[] = {256, 128};

// The forward's shared memory for a block of `threads`: the small parameters, W_l, and
// per warp X, C [16][4] and a slot of 32 stacked rows.
size_t fwd_smem(int hp, int n_hidden, int threads) {
  const size_t ld = hp + 4;
  return sizeof(float) * (vj_small_size(hp, n_hidden) + (size_t)(n_hidden - 1) * hp * ld +
                          (threads / 32) * (2 * VR_MAX_IN * 16 + 32 * ld));
}

// The backward's dW plan for a block of `threads` and a tile of T points: C chunks of the
// tile's 2T rows (a power of two, >= 8 rows each), so that a layer's MT C row-block units
// fill the warps, fewer when the hidden layers' units would exceed 2 per warp, and R
// units per warp (1 or 2); or, when even C = 1 needs more, R = 0 and C = 1: 16 x 8 tiles
// summed in a shared-memory partial.
void dw_plan(int hp, int n_hidden, int threads, int T, int* R, int* C) {
  const int warps = threads / 32, mt = (hp + 15) / 16;
  int c = warps / mt > 1 ? warps / mt : 1;
  if (c > 2 * T / 8) c = 2 * T / 8;
  while (c > 1 && mt * c * (n_hidden - 1) > 2 * warps) c /= 2;
  const int need = (mt * c * (n_hidden - 1) + warps - 1) / warps;
  *R = need <= 1 ? 1 : (need <= 2 ? 2 : 0);
  *C = *R ? c : 1;
}

// The backward's shared memory; sin adds its cos z rows, T per hidden layer (Cz).
size_t bwd_smem(int hp, const VrProblem& pb, int T, int threads, int R) {
  const size_t Lh = pb.n_hidden, ld = hp + 4, small = vj_small_size(hp, pb.n_hidden);
  const size_t part = (threads / hp) * small + (R == 0 ? (Lh - 1) * hp * hp : 0);
  const size_t rows = pb.act == VJ_ACT_SIN ? 3 * T : 2 * T;  // per layer: [a; t] (+ Cz)
  return sizeof(float) * (part + small + (Lh - 1) * hp * ld + vr_tab_floats(pb) +
                          VR_MAX_IN + (2 * VR_MAX_IN + 2) * (size_t)T + Lh * rows * ld);
}

template <int HP, bool SIN>
const void* bwd_kernel(int R) {
  if (R == 1) return (const void*)vr_bwd_kernel<HP, 1, SIN>;
  if (R == 2) return (const void*)vr_bwd_kernel<HP, 2, SIN>;
  return (const void*)vr_bwd_kernel<HP, 0, SIN>;
}

VrProblem make_problem(const float* xs, const float* flds, const float* tab,
                       const float* scale, int k, int nq, int n_in, int d, int td,
                       int has_react, int n_hidden, int act) {
  VrProblem pb;
  pb.xs = xs; pb.flds = flds; pb.tab = tab; pb.scale = scale;
  pb.cdir = nullptr; pb.csrc = nullptr; pb.cu = nullptr;
  pb.P = (long long)k * nq;
  pb.k = k; pb.nq = nq; pb.n_in = n_in; pb.d = d; pb.td = td; pb.has_react = has_react;
  pb.n_hidden = n_hidden; pb.act = act; pb.pre = 0;
  return pb;
}

// Precoeff mode: has_cu says whether cu is read (reaction and / or the hard-BC fold).
VrProblem make_pre_problem(const float* xs, const float* cdir, const float* csrc,
                           const float* cu, int k, int nq, int n_in, int has_cu,
                           int n_hidden, int act) {
  VrProblem pb = make_problem(xs, nullptr, nullptr, nullptr, k, nq, n_in, 0, 0, has_cu,
                              n_hidden, act);
  pb.cdir = cdir; pb.csrc = csrc; pb.cu = cu; pb.pre = 1;
  return pb;
}

// Forward: one wave of persistent blocks (vj_group_grid), then the q-sums.  contrib is
// workspace of P floats.
template <int HP, bool SIN>
int launch_fwd(const VrProblem& pb, const float* params, float* contrib, float* r,
               cudaStream_t stream) {
  if (pb.k == 0) return 0;
  if (pb.P > 0) {
    const auto smem = [&](int th) { return fwd_smem(HP, pb.n_hidden, th); };
    const long long n_groups = (pb.P + 15) / 16;
    int threads = 0, blocks = 0;
    const int err = vj_group_grid((const void*)vr_fwd_kernel<HP, SIN>, smem, n_groups,
                                  &threads, &blocks);
    if (err) return err;
    vr_fwd_kernel<HP, SIN><<<blocks, threads, smem(threads), stream>>>(pb, params, contrib,
                                                                       n_groups);
    if (const int e = (int)cudaGetLastError()) return e;
  }
  return vr_qsum(contrib, r, pb.k, pb.nq, stream);
}

// The backward's (points per tile, threads) pair that keeps the most busy warps resident
// per SM (a warp is busy when the tile has a 16-row stacked tile for it), on a tie the
// one with more blocks per SM, then the larger tile, as value_and_jac.cu's tile_grid;
// its dW plan (R, C); and the persistent grid: one wave of blocks, or fewer when there
// are fewer tiles (at least one: P = 0 writes zero partials).
struct BwdGrid {
  int T, threads, R, C, blocks;
  long long n_tiles;
  size_t smem;
  int per_sm;  // blocks resident per SM
};

template <int HP, bool SIN>
int bwd_config(const VrProblem& pb, BwdGrid* out) {
  int best = 0, per_sm_best = 0;
  bool fits = false;
  cudaError_t err;
  for (int T : kTileChoices)
    for (int threads : kTileThreads) {
      int R = 0, C = 1;
      dw_plan(HP, pb.n_hidden, threads, T, &R, &C);
      const void* fn = bwd_kernel<HP, SIN>(R);
      if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)kVjMaxSmem)) != cudaSuccess)
        return (int)err;
      const size_t smem = bwd_smem(HP, pb, T, threads, R);
      if (smem > kVjMaxSmem) continue;
      fits = true;
      int per_sm = 0;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem)) !=
          cudaSuccess)
        return (int)err;
      const int warps = threads / 32, stacked = 2 * T / 16;
      const int busy = per_sm * (warps < stacked ? warps : stacked);
      if (busy > best || (busy == best && per_sm > per_sm_best)) {
        best = busy;
        per_sm_best = per_sm;
        *out = BwdGrid{T, threads, R, C, 0, 0, smem, per_sm};
      }
    }
  if (!fits) return VJ_DOES_NOT_FIT;
  if (best == 0) return (int)cudaErrorInvalidConfiguration;
  int n_sm = 0;
  if (const int e = vj_sm_count(&n_sm)) return e;
  out->n_tiles = (pb.P + out->T - 1) / out->T;
  const long long b = (long long)per_sm_best * n_sm;
  out->blocks = (int)(b < out->n_tiles ? b : (out->n_tiles > 0 ? out->n_tiles : 1));
  return 0;
}

// Rows of the backward's partials buffer: C per block.
template <int HP, bool SIN>
int bwd_blocks(const VrProblem& pb, int* rows) {
  BwdGrid cfg;
  const int err = bwd_config<HP, SIN>(pb, &cfg);
  if (err) return err;
  *rows = cfg.blocks * cfg.C;
  return 0;
}

template <int HP, bool SIN>
int launch_bwd(const VrProblem& pb, const float* params, const float* gr, float* partials,
               int n_rows, float* grad, cudaStream_t stream) {
  BwdGrid cfg;
  int err = bwd_config<HP, SIN>(pb, &cfg);
  if (err) return err;
  if (n_rows != cfg.blocks * cfg.C) return (int)cudaErrorInvalidValue;
  const int nb = cfg.blocks;
  if (cfg.R == 1)
    vr_bwd_kernel<HP, 1, SIN><<<nb, cfg.threads, cfg.smem, stream>>>(
        pb, params, gr, partials, cfg.n_tiles, cfg.T, cfg.C);
  else if (cfg.R == 2)
    vr_bwd_kernel<HP, 2, SIN><<<nb, cfg.threads, cfg.smem, stream>>>(
        pb, params, gr, partials, cfg.n_tiles, cfg.T, cfg.C);
  else
    vr_bwd_kernel<HP, 0, SIN><<<nb, cfg.threads, cfg.smem, stream>>>(
        pb, params, gr, partials, cfg.n_tiles, cfg.T, cfg.C);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const int npp = vj_n_params(HP, pb.n_hidden);
  vr_reduce_kernel<<<(npp + 127) / 128, 128, 0, stream>>>(partials, grad, n_rows, npp);
  return (int)cudaGetLastError();
}

// The forward's (bwd 0) or backward's (bwd 1) launch shape: {threads, blocks resident per
// SM, blocks, points per tile (the forward: 16 per warp), shared memory bytes per block}.
template <int HP, bool SIN>
int launch_shape(int bwd, const VrProblem& pb, int* shape) {
  if (bwd) {
    BwdGrid cfg;
    const int err = bwd_config<HP, SIN>(pb, &cfg);
    if (err) return err;
    shape[0] = cfg.threads, shape[1] = cfg.per_sm, shape[2] = cfg.blocks, shape[3] = cfg.T;
    shape[4] = (int)cfg.smem;
    return 0;
  }
  const auto smem = [&](int th) { return fwd_smem(HP, pb.n_hidden, th); };
  shape[3] = 16;
  const int err = vj_group_grid((const void*)vr_fwd_kernel<HP, SIN>, smem, (pb.P + 15) / 16,
                                &shape[0], &shape[2], &shape[1]);
  shape[4] = err ? 0 : (int)smem(shape[0]);
  return err;
}

}  // namespace

extern "C" {

// Launch shape of the K1 (table mode) or K4 (pre 1) forward (bwd 0) or backward (bwd 1)
// on the current device: shape[5] = {threads, blocks resident per SM, blocks, points per
// tile, shared memory bytes per block}.  Returns a cudaError_t value.
int vr_launch_shape(int bwd, int k, int nq, int d, int n_hidden, int hp, int act, int pre,
                    int* shape) {
  VrProblem pb = make_problem(nullptr, nullptr, nullptr, nullptr, k, nq, 0, d, 0, 0, n_hidden,
                              act);
  pb.pre = pre;
  VJ_DISPATCH(hp, act, launch_shape<HP, SIN>(bwd, pb, shape))
}

// Packed parameter count (floats) for hidden width hp and n_hidden hidden layers.
int vr_dir_residual_n_params(int hp, int n_hidden) { return vj_n_params(hp, n_hidden); }

// Residual r [k] of the directional weak form; contrib is workspace of k * nq floats.
// Returns a cudaError_t value.
int vr_dir_residual_fwd(const float* xs, const float* flds, const float* tab,
                        const float* scale, const float* params, float* contrib, float* r,
                        int k, int nq, int n_in, int d, int td, int has_react, int n_hidden,
                        int hp, int act, void* stream) {
  const VrProblem pb = make_problem(xs, flds, tab, scale, k, nq, n_in, d, td, has_react,
                                    n_hidden, act);
  VJ_DISPATCH(hp, act, launch_fwd<HP, SIN>(pb, params, contrib, r, (cudaStream_t)stream))
}

// Rows of the backward's partials buffer for this problem on the current device.
int vr_dir_residual_bwd_blocks(int k, int nq, int d, int n_hidden, int hp, int act,
                               int* blocks) {
  const VrProblem pb = make_problem(nullptr, nullptr, nullptr, nullptr, k, nq, 0, d, 0, 0,
                                    n_hidden, act);
  VJ_DISPATCH(hp, act, bwd_blocks<HP, SIN>(pb, blocks))
}

// Packed parameter gradient grad [n_params] for the cotangent gr [k].  partials is
// workspace of n_blocks * n_params floats (n_blocks from vr_dir_residual_bwd_blocks).
int vr_dir_residual_bwd(const float* xs, const float* flds, const float* tab,
                        const float* scale, const float* params, const float* gr,
                        float* partials, int n_blocks, float* grad, int k, int nq, int n_in,
                        int d, int td, int has_react, int n_hidden, int hp, int act,
                        void* stream) {
  const VrProblem pb = make_problem(xs, flds, tab, scale, k, nq, n_in, d, td, has_react,
                                    n_hidden, act);
  VJ_DISPATCH(hp, act, launch_bwd<HP, SIN>(pb, params, gr, partials, n_blocks, grad,
                                           (cudaStream_t)stream))
}

// K4, precoeff mode: r [k] from the precomputed xs, cdir [n_in][P], csrc [P] and cu [P]
// (read when has_cu; may be null otherwise); contrib is workspace of k * nq floats.
// Returns a cudaError_t value.
int vr_dirp_residual_fwd(const float* xs, const float* cdir, const float* csrc,
                         const float* cu, const float* params, float* contrib, float* r,
                         int k, int nq, int n_in, int has_cu, int n_hidden, int hp, int act,
                         void* stream) {
  const VrProblem pb = make_pre_problem(xs, cdir, csrc, cu, k, nq, n_in, has_cu, n_hidden,
                                        act);
  VJ_DISPATCH(hp, act, launch_fwd<HP, SIN>(pb, params, contrib, r, (cudaStream_t)stream))
}

// Rows of K4's backward partials buffer for this problem on the current device.
int vr_dirp_residual_bwd_blocks(int k, int nq, int n_hidden, int hp, int act, int* blocks) {
  const VrProblem pb = make_pre_problem(nullptr, nullptr, nullptr, nullptr, k, nq, 0, 0,
                                        n_hidden, act);
  VJ_DISPATCH(hp, act, bwd_blocks<HP, SIN>(pb, blocks))
}

// K4's packed parameter gradient grad [n_params] for the cotangent gr [k]; partials as
// in vr_dir_residual_bwd (n_blocks from vr_dirp_residual_bwd_blocks).
int vr_dirp_residual_bwd(const float* xs, const float* cdir, const float* csrc,
                         const float* cu, const float* params, const float* gr,
                         float* partials, int n_blocks, float* grad, int k, int nq, int n_in,
                         int has_cu, int n_hidden, int hp, int act, void* stream) {
  const VrProblem pb = make_pre_problem(xs, cdir, csrc, cu, k, nq, n_in, has_cu, n_hidden,
                                        act);
  VJ_DISPATCH(hp, act, launch_bwd<HP, SIN>(pb, params, gr, partials, n_blocks, grad,
                                           (cudaStream_t)stream))
}

}  // extern "C"
