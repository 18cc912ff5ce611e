// MLP value + input-jacobian kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of the JAX package's ops/pallas_mlp.py:
//   vj_fwd_kernel  <- _fwd_pallas / _fwd_kernel           (K5 forward)
//   vj_bwd_kernel  <- _bwd_pallas / _bwd_kernel + _packed_bwd_tail   (K5 backward)
//   vj_jvp_kernel  <- _jvp_pallas / _jvp_kernel + _jvp_tail          (K6)
// At P points with scaled coordinates xs [n_in][P] they compute
//
//   out [1 + n_in][P]:  row 0 = u(xs), rows 1.. = du/dxs_j      (forward-mode panels
//                       a_l and J_l^j = act'(a_l) * P_l^j, P_l^j = W_l J_{l-1}^j)
//   dW, db             = sum_p of the parameter gradient for the cotangent g [1+n_in][P]
//                        of out, including the act'' term
//                        gz = sp * ga + spp * sum_j gJ_j * P_l^j           (backward)
//   dout [1 + n_in][P] = tangent of out along the parameter tangent (dW, db)   (JVP)
//
// The coordinates are constants: no gradient or tangent flows to xs.
//
// What bounds them.  Per point and hidden layer of width H the forward does (1 + n_in) H^2
// multiply-adds, the JVP and the backward three times that (JVP: W s, W ds, dW s;
// backward: recompute, cotangents G W, weight gradient G^T S), against 4 (1 + n_in) bytes
// read and written per point: far above the memory roofline, so every intermediate stays
// on chip and the bound is arithmetic.  On the CUDA cores (67 TFLOP/s f32) that bound is
// chip_smoke.py::_bounds: 7.4 ms for the backward and for the JVP at w48x3 over the
// 4,382,656 points of the flagship mesh.  The hidden layers' products are ~97% of that
// work; on the tensor cores in 3xTF32 (495 / 3 TFLOP/s) they bound it at ~3 ms.
//
// All three run the hidden products on the tensor cores, in 3xTF32, on stacked panels
// (csrc/tc3xtf32.cuh): the 1 + n panels [a; J^1..J^n] of a group of points are the rows
// of one operand, one warp per 16-row tile (vj_forward_tile).  K5 forward is the stacked
// forward alone: one warp per group of 16 points, its 1 + n tiles in turn, in place in a
// slot of its own, no block-wide sync.  K5 backward takes a tile of T points (T =
// 16..64), recomputes the forward with the same tile function spread over the block's
// warps (every layer's slot kept), then runs the cotangents and the weight gradient over
// the tile's M = (1 + n) T rows; K6 pushes (S, DS) through Z = S W^T and DZ = DS W^T +
// S dW^T.
// Layer 0 (depth n_in <= 4), the output layer (N = 1, its dot products in four chains
// added pairwise), the activations and the act' / act'' epilogues stay on the CUDA
// cores.  No thread carries a column of a point's panels.
//
// Tile state (shared memory).  The backward keeps, per hidden layer, the stacked operand
// [a_l; J_l^1..J_l^n] of its T points (M rows of H + 4 floats).
// Going down, the epilogue turns slot l into [gz_l; gp_l^j] in place, and G_{l-1} =
// G_l W_l overwrites slot l, where layer l - 1's epilogue reads it.  The JVP keeps two slots of S and DS and swaps
// them per layer.  T and the threads per block come from the occupancy calculator
// (tile_grid): at w48x2 / w48x3, n_in 3, 8-12 warps per SM against the old backward's 3.
//
// TPU -> Hopper translation.  The TPU grid runs in order and sums dW across grid steps in
// place (_bwd_kernel's accum).  Here the kernels are persistent: block b walks point tiles
// b, b + gridDim.x, ...; the backward adds each tile's dW tiles, summed over the tile's
// rows in the mma accumulators, into its shared-memory partial, every entry owned by one
// lane (no __syncthreads chain), writes the partial once, and vj_reduce_kernel sums the
// partials in block order: no atomics, bit-reproducible gradients.
//
// Activations: tanh / sigmoid (act 0 / 1) in one instantiation per width; sin (act 2,
// SIREN nets) in instantiations of its own (SIN): act' = cos z is no function of a.  The
// forward keeps cos z in registers from the value tile for the tangent tiles
// (vj_forward_group_sin); K6 holds z in its epilogues (act'' = -a); the backward keeps
// [a; P^k] in its slots and cos z in rows Cz of its own (T per hidden layer), forming
// J^k = cos(z) P^k as the products load it, since its act'' term -a sum_k gJ^k P^k needs
// P where cos z may vanish.
//
// Packed parameter layout: see csrc/tc3xtf32.cuh (the same as csrc/dir_residual.cu's).

#include "tc3xtf32.cuh"

struct VjProblem {
  const float* xs;  // [n_in][P] scaled coordinates
  long long P;
  int n_in, n_hidden, act;
};

// The tile's coordinates X [4][T] (zero past P and for c >= n_in).
__device__ __forceinline__ void vj_load_x(const VjProblem& pb, long long p0, int T, float* X) {
  for (int u = threadIdx.x; u < VJ_MAX_IN * T; u += blockDim.x) {
    const int c = u / T;
    const long long p = p0 + u % T;
    X[u] = (c < pb.n_in && p < pb.P) ? pb.xs[c * pb.P + p] : 0.0f;
  }
}

// Layer 0 of the stacked forward on the CUDA cores for np points, by threads first, first
// + step, ...: a_0 = act(W0 x + b0) and J_0^k = act'(a_0) W0[:, k] into S (point t of
// panel k at row k np + t), from the coordinates X [4][ldx].  SIN with rows Cz (the
// backward's, vj_stack_layer_sin): the tangent rows keep P_0^k = W0[:, k] and Cz cos z_0.
template <int HP, bool SIN>
__device__ __forceinline__ void vj_panels0(const float* sSm, const float* X, int ldx, float* S,
                                           int np, int n, int act, int first, int step,
                                           float* Cz = nullptr) {
  constexpr int LD = kVjLd<HP>;
  const float* W0 = sSm;
  for (int e = first; e < np * HP; e += step) {
    const int t = e / HP, i = e % HP;
    float z = sSm[4 * HP + i];
#pragma unroll
    for (int c = 0; c < VJ_MAX_IN; ++c) z = fmaf(W0[i * 4 + c], X[c * ldx + t], z);
    float a, sp;
    vj_act_sp<SIN>(z, act, a, sp);
    S[t * LD + i] = a;
    if (SIN && Cz) {
      Cz[t * LD + i] = sp;
      for (int k = 0; k < n; ++k) S[((1 + k) * np + t) * LD + i] = W0[i * 4 + k];
    } else {
      for (int k = 0; k < n; ++k) S[((1 + k) * np + t) * LD + i] = sp * W0[i * 4 + k];
    }
  }
}

// a = act(z), sp = act'(z) and spp = act''(z) (the JVP's epilogues, which hold z).
template <bool SIN>
__device__ __forceinline__ void vj_act3(float z, int act, float& a, float& sp, float& spp) {
  vj_act_sp<SIN>(z, act, a, sp);
  spp = SIN ? -a : vj_ddact(a, sp, act);
}

// ------------------------------------------------------------------------------------
// K5 forward, persistent, one warp per group of 16 points (its 1 + n panels are the 16-row
// tiles of vj_forward_tile): no block-wide sync after the weights are loaded.  Shared memory: the small parameters, W_l (f32, [out][LD]), and per
// warp the group's coordinates X [4][16] and one slot [(1 + n) 16][LD] that every hidden
// layer overwrites in place.  Group j + 1's coordinates are read into registers while
// group j is computed.  SIN: act' = cos z rides the lane's registers from the value tile
// to the tangent tiles (vj_forward_group_sin); the slot is the same.
template <int HP, bool SIN>
__global__ void __launch_bounds__(256)
    vj_fwd_kernel(VjProblem pb, const float* __restrict__ params, float* __restrict__ out,
                  long long n_groups) {
  constexpr int LD = kVjLd<HP>;
  extern __shared__ float4 vj_smem4[];
  float* smem = reinterpret_cast<float*>(vj_smem4);
  const int n = pb.n_in, Lh = pb.n_hidden, act = pb.act, panels = 1 + n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  float* sSm = smem;
  float* sW = sSm + vj_small_size(HP, Lh);
  float* X = sW + (Lh - 1) * HP * LD + warp * (VJ_MAX_IN * 16 + panels * 16 * LD);
  float* S = X + VJ_MAX_IN * 16;
  vj_load_params<HP>(params, Lh, sSm, sW);
  __syncthreads();
  const float4* wout4 = reinterpret_cast<const float4*>(sSm + 4 * HP + Lh * HP);
  const float bout = sSm[4 * HP + Lh * HP + HP];
  const long long stride = (long long)gridDim.x * nwarp;
  float xn[2];
  auto fetch = [&](long long grp) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int u = lane + 32 * r, c = u >> 4;
      const long long p = grp * 16 + (u & 15);
      xn[r] = (c < n && p < pb.P) ? pb.xs[c * pb.P + p] : 0.0f;
    }
  };
  long long grp = (long long)blockIdx.x * nwarp + warp;
  fetch(grp);
  for (; grp < n_groups; grp += stride) {
    X[lane] = xn[0];
    X[lane + 32] = xn[1];
    __syncwarp();
    fetch(grp + stride);
    vj_panels0<HP, SIN>(sSm, X, 16, S, 16, n, act, lane, 32);
    __syncwarp();
    // the hidden layers in place, the value tile first: the tangent tiles read act'(a)
    // from the value rows the same lanes wrote
    for (int l = 1; l < Lh; ++l) {
      if constexpr (SIN) {
        vj_forward_group_sin<HP>(S, panels, sW + (l - 1) * HP * LD, sSm + 4 * HP + l * HP);
      } else {
        for (int k = 0; k < panels; ++k)
          vj_forward_tile<HP>(S + k * 16 * LD, S + k * 16 * LD, sW + (l - 1) * HP * LD,
                              sSm + 4 * HP + l * HP, k == 0, k == 0 ? nullptr : S, act);
      }
    }
    __syncwarp();
    // output layer: out[k][p] = w_out . s_k (+ b_out), four chains; a panel's 16 points
    // are written by 16 consecutive lanes (and the 16-byte reads of the rows at stride LD
    // are conflict-free)
    for (int u = lane; u < panels * 16; u += 32) {
      const int k = u >> 4;
      const long long p = grp * 16 + (u & 15);
      const float4* s4 = reinterpret_cast<const float4*>(S + u * LD);
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
      if (p < pb.P) out[k * pb.P + p] = k == 0 ? v + bout : v;
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------------------------------
// K6 JVP, persistent over tiles of T points.  Shared memory: the small parameters and
// their tangent, W_l and dW_l (f32, [out][LD]), the tile's coordinates X [4][T], and two
// slots of (S, DS) [(1 + n) T][LD] (rows k T + t: the value panel, then the n tangent
// panels) that the hidden layers read from and write to in turn.  Its epilogues hold z, so
// SIN only changes act, act' and act'' (vj_act3).
template <int HP, bool SIN>
__global__ void __launch_bounds__(256)
    vj_jvp_kernel(VjProblem pb, const float* __restrict__ params,
                  const float* __restrict__ dparams, float* __restrict__ dout,
                  long long n_tiles, int T) {
  constexpr int LD = kVjLd<HP>;
  extern __shared__ float4 vj_smem4[];
  float* smem = reinterpret_cast<float*>(vj_smem4);
  const int n = pb.n_in, Lh = pb.n_hidden, act = pb.act;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, nwarp = nthr >> 5;
  const int rows = (1 + n) * T, slot = rows * LD, nsm = vj_small_size(HP, Lh);
  float* sSm = smem;
  float* sDm = sSm + nsm;
  float* sW = sDm + nsm;
  float* sD = sW + (Lh - 1) * HP * LD;
  float* X = sD + (Lh - 1) * HP * LD;
  float* buf = X + VJ_MAX_IN * T;  // S | DS of slot 0, then of slot 1
  vj_load_params<HP>(params, Lh, sSm, sW);
  vj_load_params<HP>(dparams, Lh, sDm, sD);
  __syncthreads();
  const float* W0 = sSm;
  const float* dW0 = sDm;
  const float* wout = sSm + 4 * HP + Lh * HP;
  const float* dwout = sDm + 4 * HP + Lh * HP;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = tile * T;
    vj_load_x(pb, p0, T, X);
    __syncthreads();
    // layer 0 on the CUDA cores: its input (the coordinates) has no tangent
    {
      float* S = buf;
      float* DS = buf + slot;
      for (int u = tid; u < T * HP; u += nthr) {
        const int t = u / HP, i = u % HP;
        float z = sSm[4 * HP + i], dz = sDm[4 * HP + i];
#pragma unroll
        for (int c = 0; c < VJ_MAX_IN; ++c) {
          z = fmaf(W0[i * 4 + c], X[c * T + t], z);
          dz = fmaf(dW0[i * 4 + c], X[c * T + t], dz);
        }
        float a, sp, spp;
        vj_act3<SIN>(z, act, a, sp, spp);
        const float dsp = spp * dz;
        S[t * LD + i] = a;
        DS[t * LD + i] = sp * dz;
        for (int k = 0; k < n; ++k) {
          const int r = ((1 + k) * T + t) * LD + i;
          S[r] = sp * W0[i * 4 + k];
          DS[r] = fmaf(dsp, W0[i * 4 + k], sp * dW0[i * 4 + k]);
        }
      }
    }
    __syncthreads();
    int cur = 0;
    for (int l = 1; l < Lh; ++l) {
      const float* S = buf + 2 * cur * slot;
      const float* DS = S + slot;
      float* So = buf + 2 * (1 - cur) * slot;
      float* DSo = So + slot;
      const float* W = sW + (l - 1) * HP * LD;
      const float* dW = sD + (l - 1) * HP * LD;
      // Z = S W^T and DZ = DS W^T + S dW^T on the tensor cores, one 16-row tile per warp
      for (int mt = warp; mt < rows / 16; mt += nwarp) {
        const int r0 = mt * 16;
        float z[HP / 8][4], dz[HP / 8][4];
        vj_zero<HP>(z);
        vj_zero<HP>(dz);
        auto ls = [&](int rr, int i) { return S[(r0 + rr) * LD + i]; };
        auto lds = [&](int rr, int i) { return DS[(r0 + rr) * LD + i]; };
        auto lw = [&](int i, int j) { return W[j * LD + i]; };
        auto ldw = [&](int i, int j) { return dW[j * LD + i]; };
#pragma unroll
        for (int k0 = 0; k0 < HP; k0 += 8) {
          unsigned sh[4], sl[4], dsh[4], dsl[4];
          vj_frag_a(ls, k0, sh, sl);
          vj_frag_a(lds, k0, dsh, dsl);
#pragma unroll
          for (int nt = 0; nt < HP / 8; ++nt) {
            unsigned wh[2], wl[2], dwh[2], dwl[2];
            vj_frag_b(lw, k0, nt * 8, wh, wl);
            vj_frag_b(ldw, k0, nt * 8, dwh, dwl);
            float tz[4], td[4];
            vj_mma3z(tz, sh, sl, wh, wl);
            vj_mma3z(td, dsh, dsl, wh, wl);
            vj_mma3(td, sh, sl, dwh, dwl);
            vj_add(z[nt], tz);
            vj_add(dz[nt], td);
          }
        }
        vj_rows_store<HP>(z, [&](int rr, int j, float v) { So[(r0 + rr) * LD + j] = v; });
        vj_rows_store<HP>(dz, [&](int rr, int j, float v) { DSo[(r0 + rr) * LD + j] = v; });
      }
      __syncthreads();
      // epilogue on the CUDA cores: the value panel's act, act', act'' act on every panel
      const float* b = sSm + 4 * HP + l * HP;
      const float* db = sDm + 4 * HP + l * HP;
      for (int u = tid; u < T * HP; u += nthr) {
        const int t = u / HP, i = u % HP;
        float a, sp, spp;
        vj_act3<SIN>(So[t * LD + i] + b[i], act, a, sp, spp);
        const float dzv = DSo[t * LD + i] + db[i], dsp = spp * dzv;
        So[t * LD + i] = a;
        DSo[t * LD + i] = sp * dzv;
        for (int k = 0; k < n; ++k) {
          const int r = ((1 + k) * T + t) * LD + i;
          const float zc = So[r], dzc = DSo[r];
          So[r] = sp * zc;
          DSo[r] = fmaf(dsp, zc, sp * dzc);
        }
      }
      __syncthreads();
      cur ^= 1;
    }
    // output layer on the CUDA cores: dout[k] = dw_out . s_k + w_out . ds_k (+ db_out)
    const float* S = buf + 2 * cur * slot;
    const float* DS = S + slot;
    for (int u = tid; u < rows; u += nthr) {
      const int k = u / T;
      const long long p = p0 + u % T;
      const float* s = S + u * LD;
      const float* ds = DS + u * LD;
      // the two sums in four chains each, added pairwise: the row can be a cancellation of
      // terms ~100x its size (a sigmoid net's value row), where one long chain's rounding
      // showed
      float as[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ad[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < HP; i += 4)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          as[c] = fmaf(dwout[i + c], s[i + c], as[c]);
          ad[c] = fmaf(wout[i + c], ds[i + c], ad[c]);
        }
      const float v = ((as[0] + as[1]) + (as[2] + as[3])) + ((ad[0] + ad[1]) + (ad[2] + ad[3]));
      if (p < pb.P) dout[k * pb.P + p] = k == 0 ? v + dwout[HP] : v;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------------------------
// K5 backward, persistent over tiles of T points.  Shared memory:
//   sG   [npp]            the block's gradient partial (packed layout)
//   sSm, sW               the small parameters and W_l (f32, [out][LD])
//   X [4][T], GO [1+n][T] the tile's coordinates and the cotangent g of out
//   S    [Lh][(1+n) T][LD] slot l: the stacked operand [a_l; J_l^1..J_l^n] (rows t, then
//                         k T + t); going down: [gz_l; gp_l^k], then G_{l-1} = [ga; gJ^k].
//   Cz   [Lh][T][LD]      SIN only: cos z_l; slot l then keeps the tangents'
//                         pre-activations P_l^k in place of J_l^k = cos(z_l) P_l^k, which
//                         the products form as they load (vj_stack_layer_sin,
//                         vj_dw_tile_by): the act'' term is -a sum_k gJ^k P^k, and where
//                         cos z vanishes no function of (a, J) gives P.
template <int HP, bool SIN>
__global__ void __launch_bounds__(256)
    vj_bwd_kernel(VjProblem pb, const float* __restrict__ params, const float* __restrict__ g,
                  float* __restrict__ partials, long long n_tiles, int T) {
  constexpr int LD = kVjLd<HP>;
  constexpr int NT = HP / 8;           // 8-column tiles of a width
  constexpr int MT = (HP + 15) / 16;   // 16-row tiles of dW_l
  extern __shared__ float4 vj_smem4[];
  float* smem = reinterpret_cast<float*>(vj_smem4);
  const int n = pb.n_in, Lh = pb.n_hidden, act = pb.act;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, nwarp = nthr >> 5;
  const int lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int npp = vj_n_params(HP, Lh), rows = (1 + n) * T, slot = rows * LD;
  float* sG = smem;
  float* sSm = sG + npp;
  float* sW = sSm + vj_small_size(HP, Lh);
  float* X = sW + (Lh - 1) * HP * LD;
  float* GO = X + VJ_MAX_IN * T;
  float* S = GO + (1 + n) * T;
  float* Cz = S + Lh * slot;  // SIN only
  for (int u = tid; u < npp; u += nthr) sG[u] = 0.0f;
  vj_load_params<HP>(params, Lh, sSm, sW);
  __syncthreads();
  const float* wout = sSm + 4 * HP + Lh * HP;
  const int off_wout = vj_off_wout(HP, Lh);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = tile * T;
    vj_load_x(pb, p0, T, X);
    for (int u = tid; u < (1 + n) * T; u += nthr) {
      const long long p = p0 + u % T;
      GO[u] = p < pb.P ? g[(u / T) * pb.P + p] : 0.0f;
    }
    __syncthreads();
    // forward recompute, every layer's slot kept
    vj_panels0<HP, SIN>(sSm, X, T, S, T, n, act, tid, nthr, Cz);
    __syncthreads();
    for (int l = 1; l < Lh; ++l) {
      if constexpr (SIN)
        vj_stack_layer_sin<HP>(S + (l - 1) * slot, Cz + (l - 1) * T * LD, S + l * slot,
                               Cz + l * T * LD, sW + (l - 1) * HP * LD, sSm + 4 * HP + l * HP,
                               T, 1 + n);
      else
        vj_stack_layer<HP>(S + (l - 1) * slot, S + l * slot, sW + (l - 1) * HP * LD,
                           sSm + 4 * HP + l * HP, T, 1 + n, act);
    }

    // output layer: dw_out += sum_r g_r S_top[r] (g_u a + sum_k g_k J^k), db_out += g_u;
    // one owner per entry, four chains
    {
      const float* St = S + (Lh - 1) * slot;
      const float* Ct = Cz + (Lh - 1) * T * LD;
      for (int i = tid; i <= HP; i += nthr) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (i == HP) {
          for (int t = 0; t < T; ++t) acc[t & 3] += GO[t];
        } else {
          for (int r = 0; r < rows; r += 4)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float s = SIN ? vj_sin_operand<HP>(St, Ct, T, r + c, i) : St[(r + c) * LD + i];
              acc[c] = fmaf(GO[r + c], s, acc[c]);
            }
        }
        sG[off_wout + i] += (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    }
    __syncthreads();

    for (int l = Lh - 1; l >= 0; --l) {
      float* Sl = S + l * slot;
      const float* Gin = S + (l + 1) * slot;  // G_l = [ga; gJ^k]_l, below the top layer
      const bool top = l == Lh - 1;
      // epilogue on the CUDA cores, in place: [a; J^k]_l -> [gz; gp^k]_l with
      // gz = act' ga + (act''/act') sum_k gJ^k J^k and gp^k = act' gJ^k (SIN: [a; P^k]_l,
      // gz = cos(z) ga - a sum_k gJ^k P^k)
      for (int u = tid; u < T * HP; u += nthr) {
        const int t = u / HP, i = u % HP;
        const float a = Sl[t * LD + i];
        const float sp = SIN ? Cz[l * T * LD + t * LD + i] : vj_dact(a, act);
        const float ga = top ? wout[i] * GO[t] : Gin[t * LD + i];
        float acc = 0.0f;
        for (int k = 0; k < n; ++k) {
          const int r = ((1 + k) * T + t) * LD + i;
          const float gj = top ? wout[i] * GO[(1 + k) * T + t] : Gin[r];
          acc = fmaf(gj, Sl[r], acc);
          Sl[r] = sp * gj;
        }
        Sl[t * LD + i] = SIN ? fmaf(sp, ga, -a * acc) : fmaf(sp, ga, vj_ddact_ratio(a, act) * acc);
      }
      __syncthreads();
      // db_l (and at layer 0, dW_0 = gz x^T + sum_t gp^c) on the CUDA cores
      for (int i = tid; i < HP; i += nthr) {
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int t = 0; t < T; ++t) s[t & 3] += Sl[t * LD + i];
        sG[vj_off_b(HP, l) + i] += (s[0] + s[1]) + (s[2] + s[3]);
      }
      if (l == 0) {
        for (int u = tid; u < HP * n; u += nthr) {
          const int i = u / n, c = u % n;
          float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int t = 0; t < T; ++t)
            s[t & 3] += fmaf(Sl[t * LD + i], X[c * T + t], Sl[((1 + c) * T + t) * LD + i]);
          sG[i * 4 + c] += (s[0] + s[1]) + (s[2] + s[3]);
        }
        break;
      }
      // dW_l += G_l^T S_{l-1}: one 16 x 8 tile of dW_l per warp unit, the depth the
      // tile's rows; each tile is added to sG by the lanes that hold it
      {
        const int off_w = vj_off_w(HP, l);
        const float* Sp = S + (l - 1) * slot;
        const float* Cp = Cz + (l - 1) * T * LD;
        for (int un = warp; un < MT * NT; un += nwarp) {
          const int j0 = (un / NT) * 16, i0 = (un % NT) * 8;
          float acc[4];
          if constexpr (SIN)
            vj_dw_tile_by<HP>(
                acc, Sl, [&](int r, int i) { return vj_sin_operand<HP>(Sp, Cp, T, r, i); }, rows,
                j0, i0);
          else
            vj_dw_tile<HP>(acc, Sl, Sp, rows, j0, i0);
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int j = j0 + gq + (h & 2 ? 8 : 0), i = i0 + 2 * q + (h & 1);
            if (j < HP) sG[off_w + j * HP + i] += acc[h];
          }
        }
      }
      __syncthreads();
      // G_{l-1} = G_l W_l, in place in slot l
      vj_cotangent_rows<HP>(Sl, sW + (l - 1) * HP * LD, rows);
    }
    __syncthreads();
  }
  for (int u = tid; u < npp; u += nthr) partials[(long long)blockIdx.x * npp + u] = sG[u];
}

// grad[i] = sum_b partials[b][i], in block order.
__global__ void vj_reduce_kernel(const float* __restrict__ partials, float* __restrict__ grad,
                                 int n_blocks, int npp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npp) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(long long)b * npp + i];
  grad[i] = s;
}

// ---- host launchers ----------------------------------------------------------------

namespace {

const int kTileChoices[] = {64, 32, 16};  // points per tile (K5 backward, K6)
const int kTileThreads[] = {256, 128};

enum Kind { kFwd, kJvp, kBwd };

// Shared memory (bytes) of a block: for a tile of T points (K5 backward, K6), or of T
// threads (K5 forward: a group's coordinates and slot per warp).  sin adds the backward's
// cos z rows, T per hidden layer.
size_t smem_bytes(Kind kind, int hp, int n_hidden, int n_in, int T, bool sin) {
  const size_t npp = vj_n_params(hp, n_hidden), h = hp, ld = hp + 4;
  const size_t rows = (size_t)(1 + n_in) * T, small = vj_small_size(hp, n_hidden);
  const size_t hidden = (size_t)(n_hidden - 1) * h * ld;
  switch (kind) {
    case kFwd:
      return sizeof(float) * (small + hidden + (T / 32) * (VJ_MAX_IN * 16 + (1 + n_in) * 16 * ld));
    case kJvp:
      return sizeof(float) * (2 * small + 2 * hidden + VJ_MAX_IN * T + 4 * rows * ld);
    default:
      return sizeof(float) * (npp + small + hidden + (VJ_MAX_IN + 1 + n_in) * T +
                              n_hidden * (rows + (sin ? T : 0)) * ld);
  }
}

template <int HP, bool SIN>
const void* kernel_of(Kind kind) {
  switch (kind) {
    case kFwd: return (const void*)vj_fwd_kernel<HP, SIN>;
    case kJvp: return (const void*)vj_jvp_kernel<HP, SIN>;
    default: return (const void*)vj_bwd_kernel<HP, SIN>;
  }
}

int allow_smem(const void* fn) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kVjMaxSmem);
}

// K5 backward and K6: the (points per tile, threads) pair that keeps the most busy
// warps resident per SM (a warp is busy when the tile has a 16-row stacked tile for it),
// on a tie the one with more blocks per SM (their __syncthreads overlap; on an H100 at
// w48x3: K5 bwd 30.8 against 32.6 ms, K6 17.2 against 17.6, scripts/ab_vj.py), then the
// larger tile; and the persistent grid: one wave of blocks, or fewer when
// there are fewer tiles.
struct TileGrid {
  int T, threads, blocks;
  long long n_tiles;
  size_t smem;
  int per_sm;  // blocks resident per SM
};

template <int HP, bool SIN>
int tile_grid(Kind kind, const VjProblem& pb, TileGrid* out) {
  const void* fn = kernel_of<HP, SIN>(kind);
  int err = allow_smem(fn);
  if (err) return err;
  int best = 0, per_sm_best = 0;
  bool fits = false;
  for (int T : kTileChoices)
    for (int threads : kTileThreads) {
      const size_t smem = smem_bytes(kind, HP, pb.n_hidden, pb.n_in, T, SIN);
      if (smem > kVjMaxSmem) continue;
      fits = true;
      int per_sm = 0;
      if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                                     smem)))
        return err;
      const int warps = threads / 32, stacked = (1 + pb.n_in) * T / 16;
      const int busy = per_sm * (warps < stacked ? warps : stacked);
      if (busy > best || (busy == best && per_sm > per_sm_best)) {
        best = busy;
        per_sm_best = per_sm;
        *out = TileGrid{T, threads, 0, 0, smem, per_sm};
      }
    }
  if (!fits) return VJ_DOES_NOT_FIT;
  if (best == 0) return (int)cudaErrorInvalidConfiguration;
  int n_sm = 0;
  if ((err = vj_sm_count(&n_sm))) return err;
  out->n_tiles = (pb.P + out->T - 1) / out->T;
  const long long b = (long long)per_sm_best * n_sm;
  out->blocks = (int)(b < out->n_tiles ? b : (out->n_tiles > 0 ? out->n_tiles : 1));
  return 0;
}

// K5 forward: one wave of persistent blocks (vj_group_grid).
template <int HP, bool SIN>
int launch_fwd(const VjProblem& pb, const float* params, float* out, cudaStream_t stream) {
  const auto smem = [&](int th) {
    return smem_bytes(kFwd, HP, pb.n_hidden, pb.n_in, th, SIN);
  };
  const long long n_groups = (pb.P + 15) / 16;
  int threads = 0, blocks = 0;
  const int err = vj_group_grid(kernel_of<HP, SIN>(kFwd), smem, n_groups, &threads, &blocks);
  if (err) return err;
  vj_fwd_kernel<HP, SIN><<<blocks, threads, smem(threads), stream>>>(pb, params, out,
                                                                     n_groups);
  return (int)cudaGetLastError();
}

template <int HP, bool SIN>
int launch_jvp(const VjProblem& pb, const float* params, const float* dparams, float* out,
               cudaStream_t stream) {
  TileGrid tg;
  int err = tile_grid<HP, SIN>(kJvp, pb, &tg);
  if (err) return err;
  vj_jvp_kernel<HP, SIN><<<tg.blocks, tg.threads, tg.smem, stream>>>(pb, params, dparams, out,
                                                                     tg.n_tiles, tg.T);
  return (int)cudaGetLastError();
}

template <int HP, bool SIN>
int bwd_blocks(const VjProblem& pb, int* blocks) {
  TileGrid tg;
  int err = tile_grid<HP, SIN>(kBwd, pb, &tg);
  if (err) return err;
  *blocks = tg.blocks;
  return 0;
}

template <int HP, bool SIN>
int launch_bwd(const VjProblem& pb, const float* params, const float* g, float* partials,
               int n_blocks, float* grad, cudaStream_t stream) {
  TileGrid tg;
  int err = tile_grid<HP, SIN>(kBwd, pb, &tg);
  if (err) return err;
  if (n_blocks != tg.blocks) return (int)cudaErrorInvalidValue;
  vj_bwd_kernel<HP, SIN><<<n_blocks, tg.threads, tg.smem, stream>>>(pb, params, g, partials,
                                                                    tg.n_tiles, tg.T);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const int npp = vj_n_params(HP, pb.n_hidden);
  vj_reduce_kernel<<<(npp + 127) / 128, 128, 0, stream>>>(partials, grad, n_blocks, npp);
  return (int)cudaGetLastError();
}

// The launch shape of kind: {threads, blocks resident per SM, blocks, points per tile (the
// forward: 16 per warp), shared memory bytes per block}.
template <int HP, bool SIN>
int launch_shape(Kind kind, const VjProblem& pb, int* shape) {
  if (kind == kFwd) {
    const auto smem = [&](int th) {
      return smem_bytes(kFwd, HP, pb.n_hidden, pb.n_in, th, SIN);
    };
    shape[3] = 16;
    const int err = vj_group_grid(kernel_of<HP, SIN>(kFwd), smem, (pb.P + 15) / 16,
                                  &shape[0], &shape[2], &shape[1]);
    shape[4] = err ? 0 : (int)smem(shape[0]);
    return err;
  }
  TileGrid tg;
  const int err = tile_grid<HP, SIN>(kind, pb, &tg);
  if (err) return err;
  shape[0] = tg.threads, shape[1] = tg.per_sm, shape[2] = tg.blocks, shape[3] = tg.T;
  shape[4] = (int)tg.smem;
  return 0;
}

VjProblem make_problem(const float* xs, long long P, int n_in, int n_hidden, int act) {
  VjProblem pb;
  pb.xs = xs; pb.P = P; pb.n_in = n_in; pb.n_hidden = n_hidden; pb.act = act;
  return pb;
}

bool bad_shape(long long P, int n_in, int n_hidden) {
  return P < 0 || n_in < 1 || n_in > VJ_MAX_IN || n_hidden < 1;
}

}  // namespace

extern "C" {

// Packed parameter count (floats) for hidden width hp and n_hidden hidden layers.
int vj_n_params_c(int hp, int n_hidden) { return vj_n_params(hp, n_hidden); }

// out [1 + n_in][P] = (u, du/dxs) at the scaled points xs [n_in][P].
// Returns a cudaError_t value.
int vj_fwd(const float* xs, const float* params, float* out, long long P, int n_in,
           int n_hidden, int hp, int act, void* stream) {
  if (bad_shape(P, n_in, n_hidden)) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const VjProblem pb = make_problem(xs, P, n_in, n_hidden, act);
  VJ_DISPATCH(hp, act, launch_fwd<HP, SIN>(pb, params, out, (cudaStream_t)stream))
}

// dout [1 + n_in][P]: tangent of out along the packed parameter tangent dparams.
int vj_jvp(const float* xs, const float* params, const float* dparams, float* dout,
           long long P, int n_in, int n_hidden, int hp, int act, void* stream) {
  if (bad_shape(P, n_in, n_hidden)) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const VjProblem pb = make_problem(xs, P, n_in, n_hidden, act);
  VJ_DISPATCH(hp, act, launch_jvp<HP, SIN>(pb, params, dparams, dout, (cudaStream_t)stream))
}

// Launch shape of K5 forward (kind 0), K6 (1) or K5 backward (2) on the current device:
// shape[5] = {threads, blocks resident per SM, blocks, points per tile, shared memory
// bytes per block}.
int vj_launch_shape(int kind, long long P, int n_in, int n_hidden, int hp, int act,
                    int* shape) {
  if (bad_shape(P, n_in, n_hidden) || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  const VjProblem pb = make_problem(nullptr, P, n_in, n_hidden, act);
  VJ_DISPATCH(hp, act, launch_shape<HP, SIN>((Kind)kind, pb, shape))
}

// Number of backward blocks (rows of the partials buffer) on the current device.
int vj_bwd_blocks(long long P, int n_in, int n_hidden, int hp, int act, int* blocks) {
  if (bad_shape(P, n_in, n_hidden)) return (int)cudaErrorInvalidValue;
  const VjProblem pb = make_problem(nullptr, P, n_in, n_hidden, act);
  VJ_DISPATCH(hp, act, bwd_blocks<HP, SIN>(pb, blocks))
}

// Packed parameter gradient grad [n_params] for the cotangent g [1 + n_in][P] of out.
// partials is workspace of n_blocks * n_params floats (n_blocks from vj_bwd_blocks).
int vj_bwd(const float* xs, const float* g, const float* params, float* partials,
           int n_blocks, float* grad, long long P, int n_in, int n_hidden, int hp, int act,
           void* stream) {
  if (bad_shape(P, n_in, n_hidden)) return (int)cudaErrorInvalidValue;
  const VjProblem pb = make_problem(xs, P, n_in, n_hidden, act);
  VJ_DISPATCH(hp, act, launch_bwd<HP, SIN>(pb, params, g, partials, n_blocks, grad,
                                           (cudaStream_t)stream))
}

}  // extern "C"
