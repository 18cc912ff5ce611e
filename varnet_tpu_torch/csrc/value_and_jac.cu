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
// K5 forward: one thread per point, its panels in its own shared-memory column, weights
// read as float4 broadcasts, f32 on the CUDA cores (unchanged since it was ported).
//
// K5 backward and K6: the hidden products on the tensor cores.  As the TPU kernels pack
// the value panel and the n tangent panels into one [H, (1 + n) T] operand for the MXU, a
// block here takes a tile of T points (T = 16..64) and stacks its 1 + n panels as the rows
// of one operand, row r = k T + t (panel k, point t), M = (1 + n) T.  Each hidden layer is
// then a few [M x H] x [H x H] products of mma.sync.m16n8k8 tf32 tiles, one warp per
// 16-row tile for all H columns (its A fragments reused across them):
//   forward recompute  Z = [a; J^1..J^n]_{l-1} W_l^T     (K5 bwd; K6: Z = S W^T and
//   cotangents         G_{l-1} = G_l W_l                   DZ = DS W^T + S dW^T)
//   weight gradient    dW_l += G_l^T [a; J^1..J^n]_{l-1}   (depth: the tile's M rows)
// Precision: 3xTF32.  Each operand is split at fragment load, x_hi = cvt.rna.tf32(x),
// x_lo = cvt.rna.tf32(x - x_hi), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi is summed
// in f32: single TF32 keeps ~3 digits and misses the 1e-4 gates by 5-18x, 3xTF32 sits at
// f32's own distance from f64 (tests/test_torch_tf32_split.py).  The tensor core's own
// f32 sum truncates, so each k-step's products go to a fresh tile that is added to the
// running sum on the CUDA cores (vj_add).  The output layer's dot products run in four
// chains, added pairwise.  The weights are kept
// once, in f32, in shared memory ([out][in], row stride H + 4: the A and B fragment loads
// of S W^T are conflict-free, the transposed reads of G W and G^T S two-way); two split
// copies would not fit beside the tile state at H 64 x 4 hidden layers.  Layer 0 (depth
// n_in <= 4), the output layer (N = 1), the activations and the act' / act'' epilogues
// stay on the CUDA cores.  No thread carries a column of a point's panels.
//
// Tile state (shared memory).  The backward keeps, per hidden layer, the stacked operand
// [a_l; J_l^1..J_l^n] of its T points (M rows of H + 4 floats; the act'' term is formed
// from J, see vj_ddact_ratio).  Going down, the epilogue turns slot l into [gz_l; gp_l^j]
// in place, and G_{l-1} = G_l W_l overwrites slot l (each warp reads all of its 16 rows
// before it writes them), where layer l - 1's epilogue reads it.  The JVP keeps two slots
// of S and DS and swaps them per layer.  T and the threads per block come from the
// occupancy calculator (tile_grid): at w48x2 / w48x3, n_in 3, 8-12 warps per SM against
// the old backward's 3.
//
// TPU -> Hopper translation.  The TPU grid runs in order and sums dW across grid steps in
// place (_bwd_kernel's accum).  Here both kernels are persistent: block b walks point
// tiles b, b + gridDim.x, ...; the backward adds each tile's dW tiles, summed over the
// tile's rows in the mma accumulators, into its shared-memory partial, every entry owned
// by one lane (no __syncthreads chain), writes the partial once, and vj_reduce_kernel sums
// the partials in block order: no atomics, bit-reproducible gradients.
//
// Packed parameter layout (floats; the same as csrc/dir_residual.cu, see
// ops/fused_residual.py::pack_params): hidden widths zero-padded to HP (a multiple of 8,
// at most 64), n_in padded to 4:
//   W0 [HP][4] | b0 [HP] | (W_l [HP][HP] | b_l [HP]) for l = 1..L-1 | w_out [HP] | b_out
//   | pad to 4.         (W stored [fan_out][fan_in], i.e. w.T)
// Gradients and parameter tangents use the same layout.

#include <cuda_runtime.h>
#include <math.h>

#define VJ_MAX_IN 4

__host__ __device__ inline int vj_off_w(int hp, int l) {  // l >= 1
  return 5 * hp + (l - 1) * (hp * hp + hp);
}
__host__ __device__ inline int vj_off_b(int hp, int l) {
  return l == 0 ? 4 * hp : vj_off_w(hp, l) + hp * hp;
}
__host__ __device__ inline int vj_off_wout(int hp, int n_hidden) {
  return 5 * hp + (n_hidden - 1) * (hp * hp + hp);
}
__host__ __device__ inline int vj_n_params(int hp, int n_hidden) {
  return (vj_off_wout(hp, n_hidden) + hp + 1 + 3) / 4 * 4;
}

// act: 0 = tanh, 1 = sigmoid.  Derivatives are functions of the output a.
__device__ __forceinline__ float vj_act(float z, int act) {
  return act == 0 ? tanhf(z) : 1.0f / (1.0f + expf(-z));
}
__device__ __forceinline__ float vj_dact(float a, int act) {
  return act == 0 ? 1.0f - a * a : a * (1.0f - a);
}
__device__ __forceinline__ float vj_ddact(float a, float sp, int act) {
  return act == 0 ? -2.0f * a * sp : (1.0f - 2.0f * a) * sp;
}

struct VjProblem {
  const float* xs;  // [n_in][P] scaled coordinates
  long long P;
  int n_in, n_hidden, act;
};

__device__ __forceinline__ void vj_load(const float* src, float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ void vj_coords(const VjProblem& pb, long long p, bool valid,
                                          float x[VJ_MAX_IN]) {
#pragma unroll
  for (int j = 0; j < VJ_MAX_IN; ++j)
    x[j] = (valid && j < pb.n_in) ? pb.xs[j * pb.P + p] : 0.0f;
}

// sum_i w[i] v[i] over a weight row in shared memory (16-byte aligned), two chains.
template <int HP>
__device__ __forceinline__ float vj_dot(const float* w, const float v[HP]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int i4 = 0; i4 < HP / 4; ++i4) {
    const float4 q = w4[i4];
    s0 = fmaf(q.x, v[4 * i4 + 0], s0);
    s1 = fmaf(q.y, v[4 * i4 + 1], s1);
    s0 = fmaf(q.z, v[4 * i4 + 2], s0);
    s1 = fmaf(q.w, v[4 * i4 + 3], s1);
  }
  return s0 + s1;
}

template <int HP>
__device__ __forceinline__ void vj_load_col(const float* col, int ld, float v[HP]) {
#pragma unroll
  for (int i = 0; i < HP; ++i) v[i] = col[i * ld];
}

// ------------------------------------------------------------------------------------
// K5 forward: one thread per point.  The thread's column (stride ld = blockDim.x) holds
// the current layer's panels: rows [k * HP + i], k = 0 the activation, k = 1 + j the
// jacobian panel J^j.
template <int HP>
__global__ void vj_fwd_kernel(VjProblem pb, const float* __restrict__ params,
                              float* __restrict__ out) {
  extern __shared__ float4 vj_smem4[];
  float* smem = reinterpret_cast<float*>(vj_smem4);
  const int ld = blockDim.x, n = pb.n_in, Lh = pb.n_hidden, act = pb.act;
  const int npp = vj_n_params(HP, Lh);
  float* sW = smem;
  vj_load(params, sW, npp);
  __syncthreads();

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p < pb.P;
  float x[VJ_MAX_IN];
  vj_coords(pb, p, valid, x);
  float* col = sW + npp + threadIdx.x;

  const float* b0 = sW + vj_off_b(HP, 0);
  for (int j = 0; j < HP; ++j) {
    const float* w0 = sW + 4 * j;
    float z = b0[j];
#pragma unroll
    for (int i = 0; i < VJ_MAX_IN; ++i) z = fmaf(w0[i], x[i], z);
    const float a = vj_act(z, act), sp = vj_dact(a, act);
    col[j * ld] = a;
    for (int k = 0; k < n; ++k) col[((1 + k) * HP + j) * ld] = sp * w0[k];
  }
  float v[HP];
  for (int l = 1; l < Lh; ++l) {
    const float* W = sW + vj_off_w(HP, l);
    const float* b = sW + vj_off_b(HP, l);
    vj_load_col<HP>(col, ld, v);
    for (int j = 0; j < HP; ++j) col[j * ld] = vj_act(b[j] + vj_dot<HP>(W + j * HP, v), act);
    for (int k = 0; k < n; ++k) {
      float* pk = col + (1 + k) * HP * ld;
      vj_load_col<HP>(pk, ld, v);
      for (int j = 0; j < HP; ++j)
        pk[j * ld] = vj_dact(col[j * ld], act) * vj_dot<HP>(W + j * HP, v);
    }
  }
  const float* wout = sW + vj_off_wout(HP, Lh);
  if (!valid) return;
  for (int k = 0; k <= n; ++k) {
    vj_load_col<HP>(col + k * HP * ld, ld, v);
    const float s = vj_dot<HP>(wout, v);
    out[k * pb.P + p] = k == 0 ? s + wout[HP] : s;
  }
}

// ------------------------------------------------------------------------------------
// Tensor-core helpers: 3xTF32 mma.sync.m16n8k8 on fragments split at load.
//
// Fragment layout (PTX ISA, m16n8k8 .tf32), lane = 4 gq + q:
//   A [16 x 8]: a0 (gq, q), a1 (gq + 8, q), a2 (gq, q + 4), a3 (gq + 8, q + 4)
//   B [8 x 8]:  b0 (k = q, n = gq), b1 (k = q + 4, n = gq)
//   C [16 x 8]: c0 (gq, 2q), c1 (gq, 2q + 1), c2 (gq + 8, 2q), c3 (gq + 8, 2q + 1)

__device__ __forceinline__ unsigned vj_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void vj_split(float x, unsigned& hi, unsigned& lo) {
  hi = vj_tf32(x);
  lo = vj_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void vj_mma(float c[4], const unsigned a[4], const unsigned b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// t += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void vj_mma3(float t[4], const unsigned ah[4], const unsigned al[4],
                                        const unsigned bh[2], const unsigned bl[2]) {
  vj_mma(t, al, bh);
  vj_mma(t, ah, bl);
  vj_mma(t, ah, bh);
}

// The tensor core's f32 sum truncates; a running sum kept in its accumulator would take
// that truncation at every k-step, at the running sum's size (a deep sigmoid net's
// cancelling JVP row missed the 1e-4 gate by that).  So each k-step's products are summed
// in a fresh tile t (vj_mma3) and added to the running sum c here, rounding to nearest.
__device__ __forceinline__ void vj_add(float c[4], const float t[4]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) c[h] += t[h];
}

// The A fragment of rows 0..15, columns k0..k0+7 of a(row, col), split.
template <class LoadA>
__device__ __forceinline__ void vj_frag_a(LoadA a, int k0, unsigned hi[4], unsigned lo[4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  vj_split(a(gq, k0 + q), hi[0], lo[0]);
  vj_split(a(gq + 8, k0 + q), hi[1], lo[1]);
  vj_split(a(gq, k0 + q + 4), hi[2], lo[2]);
  vj_split(a(gq + 8, k0 + q + 4), hi[3], lo[3]);
}

// The B fragment of rows k0..k0+7, columns n0..n0+7 of b(k, n), split.
template <class LoadB>
__device__ __forceinline__ void vj_frag_b(LoadB b, int k0, int n0, unsigned hi[2],
                                          unsigned lo[2]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  vj_split(b(k0 + q, n0 + gq), hi[0], lo[0]);
  vj_split(b(k0 + q + 4, n0 + gq), hi[1], lo[1]);
}

// acc[nt] (16 x 8 tile nt of a 16 x HP product) += A [16 x HP] B [HP x HP].
template <int HP, class LoadA, class LoadB>
__device__ __forceinline__ void vj_rows_mma(float acc[HP / 8][4], LoadA a, LoadB b) {
#pragma unroll
  for (int k0 = 0; k0 < HP; k0 += 8) {
    unsigned ah[4], al[4];
    vj_frag_a(a, k0, ah, al);
#pragma unroll
    for (int nt = 0; nt < HP / 8; ++nt) {
      unsigned bh[2], bl[2];
      vj_frag_b(b, k0, nt * 8, bh, bl);
      float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      vj_mma3(t, ah, al, bh, bl);
      vj_add(acc[nt], t);
    }
  }
}

// out(row, col, value) for every entry of the 16 x HP accumulator tile.
template <int HP, class Store>
__device__ __forceinline__ void vj_rows_store(const float acc[HP / 8][4], Store out) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nt = 0; nt < HP / 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 4; ++h) out(gq + (h & 2 ? 8 : 0), nt * 8 + 2 * q + (h & 1), acc[nt][h]);
  }
}

template <int HP>
__device__ __forceinline__ void vj_zero(float acc[HP / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < HP / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
}

// Row stride (floats) of the weights and of the tile slots in shared memory: an odd
// multiple of 4 when HP is a multiple of 8, so the 8 rows x 4 columns of a fragment load
// hit 32 different banks.
template <int HP>
constexpr int kVjLd = HP + 4;

// The small parameters in shared memory: W0 [HP][4] | b_l [HP] for l = 0..Lh-1 | w_out
// [HP] | b_out, padded to 4.
__host__ __device__ inline int vj_small_size(int hp, int n_hidden) {
  return (4 * hp + (n_hidden + 1) * hp + 1 + 3) / 4 * 4;
}

// Copy the small parameters and the hidden weights W_l (l = 1..Lh-1) of a packed buffer
// into shared memory (sW: [(l - 1) HP + j][LD], W_l[j][i] at column i).
template <int HP>
__device__ void vj_load_params(const float* __restrict__ params, int Lh, float* sSm, float* sW) {
  constexpr int LD = kVjLd<HP>;
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int u = tid; u < 5 * HP; u += nthr) sSm[u] = params[u];  // W0 | b0
  for (int l = 1; l < Lh; ++l)
    for (int i = tid; i < HP; i += nthr) sSm[4 * HP + l * HP + i] = params[vj_off_b(HP, l) + i];
  const int ow = vj_off_wout(HP, Lh);
  for (int i = tid; i <= HP; i += nthr) sSm[4 * HP + Lh * HP + i] = params[ow + i];
  for (int u = tid; u < (Lh - 1) * HP * HP; u += nthr) {
    const int l = 1 + u / (HP * HP), j = (u / HP) % HP, i = u % HP;
    sW[((l - 1) * HP + j) * LD + i] = params[vj_off_w(HP, l) + j * HP + i];
  }
}

// ------------------------------------------------------------------------------------
// K6 JVP, persistent over tiles of T points.  Shared memory: the small parameters and
// their tangent, W_l and dW_l (f32, [out][LD]), the tile's coordinates X [4][T], and two
// slots of (S, DS) [(1 + n) T][LD] (rows k T + t: the value panel, then the n tangent
// panels) that the hidden layers read from and write to in turn.
template <int HP>
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
    for (int u = tid; u < VJ_MAX_IN * T; u += nthr) {
      const int c = u / T;
      const long long p = p0 + u % T;
      X[u] = (c < n && p < pb.P) ? pb.xs[c * pb.P + p] : 0.0f;
    }
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
        const float a = vj_act(z, act), sp = vj_dact(a, act), spp = vj_ddact(a, sp, act);
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
            float tz[4] = {0.0f, 0.0f, 0.0f, 0.0f}, td[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            vj_mma3(tz, sh, sl, wh, wl);
            vj_mma3(td, dsh, dsl, wh, wl);
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
        const float a = vj_act(So[t * LD + i] + b[i], act);
        const float sp = vj_dact(a, act), spp = vj_ddact(a, sp, act);
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
// J, not the pre-activation P, is kept: the act'' term needs spp P = (act''/act') J,
// and act''/act' is -2a (tanh) or 1 - 2a (sigmoid), so every product reads its operand
// straight from a slot.
__device__ __forceinline__ float vj_ddact_ratio(float a, int act) {
  return act == 0 ? -2.0f * a : 1.0f - 2.0f * a;
}

template <int HP>
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
  for (int u = tid; u < npp; u += nthr) sG[u] = 0.0f;
  vj_load_params<HP>(params, Lh, sSm, sW);
  __syncthreads();
  const float* W0 = sSm;
  const float* wout = sSm + 4 * HP + Lh * HP;
  const int off_wout = vj_off_wout(HP, Lh);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = tile * T;
    for (int u = tid; u < (VJ_MAX_IN + 1 + n) * T; u += nthr) {
      const int c = u / T;
      const long long p = p0 + u % T;
      const bool valid = p < pb.P;
      if (c < VJ_MAX_IN)
        X[u] = (valid && c < n) ? pb.xs[c * pb.P + p] : 0.0f;
      else
        GO[u - VJ_MAX_IN * T] = valid ? g[(c - VJ_MAX_IN) * pb.P + p] : 0.0f;
    }
    __syncthreads();

    // forward recompute.  Layer 0 on the CUDA cores: a_0, and J_0^k = act'(a_0) W0[:, k].
    for (int u = tid; u < T * HP; u += nthr) {
      const int t = u / HP, i = u % HP;
      float z = sSm[4 * HP + i];
#pragma unroll
      for (int c = 0; c < VJ_MAX_IN; ++c) z = fmaf(W0[i * 4 + c], X[c * T + t], z);
      const float a = vj_act(z, act), sp = vj_dact(a, act);
      S[t * LD + i] = a;
      for (int k = 0; k < n; ++k) S[((1 + k) * T + t) * LD + i] = sp * W0[i * 4 + k];
    }
    __syncthreads();
    // hidden layers: Z = S_{l-1} W_l^T on the tensor cores; a_l = act(z + b) for the
    // value rows, z (= P_l^k) for the tangent rows, which then become J_l^k = act'(a_l) z
    for (int l = 1; l < Lh; ++l) {
      const float* Sin = S + (l - 1) * slot;
      float* Sout = S + l * slot;
      const float* W = sW + (l - 1) * HP * LD;
      const float* b = sSm + 4 * HP + l * HP;
      for (int mt = warp; mt < rows / 16; mt += nwarp) {
        const int r0 = mt * 16;
        const bool value = r0 < T;  // a 16-row tile lies in one panel
        float acc[NT][4];
        vj_zero<HP>(acc);
        vj_rows_mma<HP>(
            acc, [&](int rr, int i) { return Sin[(r0 + rr) * LD + i]; },
            [&](int i, int j) { return W[j * LD + i]; });
        vj_rows_store<HP>(acc, [&](int rr, int j, float v) {
          Sout[(r0 + rr) * LD + j] = value ? vj_act(v + b[j], act) : v;
        });
      }
      __syncthreads();
      for (int u = tid; u < T * HP; u += nthr) {
        const int t = u / HP, i = u % HP;
        const float sp = vj_dact(Sout[t * LD + i], act);
        for (int k = 1; k <= n; ++k) Sout[(k * T + t) * LD + i] *= sp;
      }
      __syncthreads();
    }

    // output layer: dw_out += sum_r g_r S_top[r] (g_u a + sum_k g_k J^k), db_out += g_u;
    // one owner per entry, four chains
    {
      const float* St = S + (Lh - 1) * slot;
      for (int i = tid; i <= HP; i += nthr) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (i == HP) {
          for (int t = 0; t < T; ++t) acc[t & 3] += GO[t];
        } else {
          for (int r = 0; r < rows; r += 4)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] = fmaf(GO[r + c], St[(r + c) * LD + i], acc[c]);
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
      // gz = act' ga + (act''/act') sum_k gJ^k J^k and gp^k = act' gJ^k
      for (int u = tid; u < T * HP; u += nthr) {
        const int t = u / HP, i = u % HP;
        const float a = Sl[t * LD + i];
        const float sp = vj_dact(a, act);
        const float ga = top ? wout[i] * GO[t] : Gin[t * LD + i];
        float acc = 0.0f;
        for (int k = 0; k < n; ++k) {
          const int r = ((1 + k) * T + t) * LD + i;
          const float gj = top ? wout[i] * GO[(1 + k) * T + t] : Gin[r];
          acc = fmaf(gj, Sl[r], acc);
          Sl[r] = sp * gj;
        }
        Sl[t * LD + i] = fmaf(sp, ga, vj_ddact_ratio(a, act) * acc);
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
        const float* Sp = S + (l - 1) * slot;
        const int off_w = vj_off_w(HP, l);
        for (int un = warp; un < MT * NT; un += nwarp) {
          const int j0 = (un / NT) * 16, i0 = (un % NT) * 8;
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          // the k-steps' fresh tiles are independent: unrolled, their loads and mma
          // overlap (one warp's unit is otherwise one chain of dependent mma)
#pragma unroll 2
          for (int r0 = 0; r0 < rows; r0 += 8) {
            unsigned ah[4], al[4], bh[2], bl[2];
            vj_frag_a(
                [&](int jj, int r) {
                  return j0 + jj < HP ? Sl[(r0 + r) * LD + j0 + jj] : 0.0f;
                },
                0, ah, al);
            vj_frag_b([&](int r, int i) { return Sp[(r0 + r) * LD + i]; }, 0, i0, bh, bl);
            float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            vj_mma3(t, ah, al, bh, bl);
            vj_add(acc, t);
          }
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int j = j0 + gq + (h & 2 ? 8 : 0), i = i0 + 2 * q + (h & 1);
            if (j < HP) sG[off_w + j * HP + i] += acc[h];
          }
        }
      }
      __syncthreads();
      // G_{l-1} = G_l W_l, in place in slot l: a warp reads all of its 16 rows first
      {
        const float* W = sW + (l - 1) * HP * LD;
        for (int mt = warp; mt < rows / 16; mt += nwarp) {
          const int r0 = mt * 16;
          float acc[NT][4];
          vj_zero<HP>(acc);
          vj_rows_mma<HP>(
              acc, [&](int rr, int j) { return Sl[(r0 + rr) * LD + j]; },
              [&](int j, int i) { return W[j * LD + i]; });
          __syncwarp();
          vj_rows_store<HP>(acc, [&](int rr, int i, float v) { Sl[(r0 + rr) * LD + i] = v; });
        }
      }
      __syncthreads();
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

const int kThreadChoices[] = {256, 224, 192, 160, 128, 96, 64, 32};  // K5 forward
const int kTileChoices[] = {64, 32, 16};  // points per tile (K5 backward, K6)
const int kTileThreads[] = {256, 128};
const size_t kMaxSmem = 227 * 1024;  // a block's shared-memory limit on sm_90

enum Kind { kFwd, kJvp, kBwd };

// Shared memory (bytes) of a block: of T threads (forward), or for a tile of T points.
size_t smem_bytes(Kind kind, int hp, int n_hidden, int n_in, int T) {
  const size_t npp = vj_n_params(hp, n_hidden), h = hp, ld = hp + 4;
  const size_t rows = (size_t)(1 + n_in) * T, small = vj_small_size(hp, n_hidden);
  const size_t hidden = (size_t)(n_hidden - 1) * h * ld;
  switch (kind) {
    case kFwd:
      return sizeof(float) * (npp + (1 + n_in) * h * T);
    case kJvp:
      return sizeof(float) * (2 * small + 2 * hidden + VJ_MAX_IN * T + 4 * rows * ld);
    default:
      return sizeof(float) * (npp + small + hidden + (VJ_MAX_IN + 1 + n_in) * T +
                              n_hidden * rows * ld);
  }
}

template <int HP>
const void* kernel_of(Kind kind) {
  switch (kind) {
    case kFwd: return (const void*)vj_fwd_kernel<HP>;
    case kJvp: return (const void*)vj_jvp_kernel<HP>;
    default: return (const void*)vj_bwd_kernel<HP>;
  }
}

int allow_smem(const void* fn) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kMaxSmem);
}

// K5 forward: the block size that keeps the most threads resident per SM (shared
// memory and registers, from the occupancy calculator).
template <int HP>
int pick_block(int n_hidden, int n_in, int* threads) {
  const void* fn = kernel_of<HP>(kFwd);
  int err = allow_smem(fn);
  if (err) return err;
  int best_T = 0, best_per_sm = 0;
  for (int T : kThreadChoices) {
    const size_t smem = smem_bytes(kFwd, HP, n_hidden, n_in, T);
    if (smem > kMaxSmem) continue;
    int per_sm = 0;
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, T, smem)))
      return err;
    if (per_sm * T > best_per_sm * best_T) {
      best_T = T;
      best_per_sm = per_sm;
    }
  }
  if (best_T == 0) return (int)cudaErrorInvalidConfiguration;
  *threads = best_T;
  return 0;
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
};

template <int HP>
int tile_grid(Kind kind, const VjProblem& pb, TileGrid* out) {
  const void* fn = kernel_of<HP>(kind);
  int err = allow_smem(fn);
  if (err) return err;
  int best = 0, per_sm_best = 0;
  for (int T : kTileChoices)
    for (int threads : kTileThreads) {
      const size_t smem = smem_bytes(kind, HP, pb.n_hidden, pb.n_in, T);
      if (smem > kMaxSmem) continue;
      int per_sm = 0;
      if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                                     smem)))
        return err;
      const int warps = threads / 32, stacked = (1 + pb.n_in) * T / 16;
      const int busy = per_sm * (warps < stacked ? warps : stacked);
      if (busy > best || (busy == best && per_sm > per_sm_best)) {
        best = busy;
        per_sm_best = per_sm;
        *out = TileGrid{T, threads, 0, 0, smem};
      }
    }
  if (best == 0) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, n_sm = 0;
  cudaError_t cerr;
  if ((cerr = cudaGetDevice(&dev)) != cudaSuccess) return (int)cerr;
  if ((cerr = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)cerr;
  out->n_tiles = (pb.P + out->T - 1) / out->T;
  const long long b = (long long)per_sm_best * n_sm;
  out->blocks = (int)(b < out->n_tiles ? b : (out->n_tiles > 0 ? out->n_tiles : 1));
  return 0;
}

template <int HP>
int launch_fwd(const VjProblem& pb, const float* params, float* out, cudaStream_t stream) {
  int T = 0;
  int err = pick_block<HP>(pb.n_hidden, pb.n_in, &T);
  if (err) return err;
  const size_t smem = smem_bytes(kFwd, HP, pb.n_hidden, pb.n_in, T);
  const long long grid = (pb.P + T - 1) / T;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  vj_fwd_kernel<HP><<<(unsigned)grid, T, smem, stream>>>(pb, params, out);
  return (int)cudaGetLastError();
}

template <int HP>
int launch_jvp(const VjProblem& pb, const float* params, const float* dparams, float* out,
               cudaStream_t stream) {
  TileGrid tg;
  int err = tile_grid<HP>(kJvp, pb, &tg);
  if (err) return err;
  vj_jvp_kernel<HP><<<tg.blocks, tg.threads, tg.smem, stream>>>(pb, params, dparams, out,
                                                                tg.n_tiles, tg.T);
  return (int)cudaGetLastError();
}

template <int HP>
int bwd_blocks(const VjProblem& pb, int* blocks) {
  TileGrid tg;
  int err = tile_grid<HP>(kBwd, pb, &tg);
  if (err) return err;
  *blocks = tg.blocks;
  return 0;
}

template <int HP>
int launch_bwd(const VjProblem& pb, const float* params, const float* g, float* partials,
               int n_blocks, float* grad, cudaStream_t stream) {
  TileGrid tg;
  int err = tile_grid<HP>(kBwd, pb, &tg);
  if (err) return err;
  if (n_blocks != tg.blocks) return (int)cudaErrorInvalidValue;
  vj_bwd_kernel<HP><<<n_blocks, tg.threads, tg.smem, stream>>>(pb, params, g, partials,
                                                               tg.n_tiles, tg.T);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const int npp = vj_n_params(HP, pb.n_hidden);
  vj_reduce_kernel<<<(npp + 127) / 128, 128, 0, stream>>>(partials, grad, n_blocks, npp);
  return (int)cudaGetLastError();
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

#define VJ_DISPATCH(hp, CALL)                                      \
  switch (hp) {                                                    \
    case 8: { constexpr int HP = 8; return CALL; }                 \
    case 16: { constexpr int HP = 16; return CALL; }               \
    case 24: { constexpr int HP = 24; return CALL; }               \
    case 32: { constexpr int HP = 32; return CALL; }               \
    case 40: { constexpr int HP = 40; return CALL; }               \
    case 48: { constexpr int HP = 48; return CALL; }               \
    case 56: { constexpr int HP = 56; return CALL; }               \
    case 64: { constexpr int HP = 64; return CALL; }               \
    default: return (int)cudaErrorInvalidValue;                    \
  }

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
  VJ_DISPATCH(hp, launch_fwd<HP>(pb, params, out, (cudaStream_t)stream))
}

// dout [1 + n_in][P]: tangent of out along the packed parameter tangent dparams.
int vj_jvp(const float* xs, const float* params, const float* dparams, float* dout,
           long long P, int n_in, int n_hidden, int hp, int act, void* stream) {
  if (bad_shape(P, n_in, n_hidden)) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const VjProblem pb = make_problem(xs, P, n_in, n_hidden, act);
  VJ_DISPATCH(hp, launch_jvp<HP>(pb, params, dparams, dout, (cudaStream_t)stream))
}

// Number of backward blocks (rows of the partials buffer) on the current device.
int vj_bwd_blocks(long long P, int n_in, int n_hidden, int hp, int* blocks) {
  if (bad_shape(P, n_in, n_hidden)) return (int)cudaErrorInvalidValue;
  const VjProblem pb = make_problem(nullptr, P, n_in, n_hidden, 0);
  VJ_DISPATCH(hp, bwd_blocks<HP>(pb, blocks))
}

// Packed parameter gradient grad [n_params] for the cotangent g [1 + n_in][P] of out.
// partials is workspace of n_blocks * n_params floats (n_blocks from vj_bwd_blocks).
int vj_bwd(const float* xs, const float* g, const float* params, float* partials,
           int n_blocks, float* grad, long long P, int n_in, int n_hidden, int hp, int act,
           void* stream) {
  if (bad_shape(P, n_in, n_hidden)) return (int)cudaErrorInvalidValue;
  const VjProblem pb = make_problem(xs, P, n_in, n_hidden, act);
  VJ_DISPATCH(hp, launch_bwd<HP>(pb, params, g, partials, n_blocks, grad,
                                 (cudaStream_t)stream))
}

}  // extern "C"
