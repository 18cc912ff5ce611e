// MLP value + input-jacobian kernels for Hopper (sm_90a), f32 on the CUDA cores.
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
// What bounds them: f32 FMA throughput on the CUDA cores.  Per point and hidden layer
// of width H the forward does (1 + n_in) H^2 FMAs, the JVP and the backward about three
// times that (JVP: W s, dW s, W ds; backward: recompute, cotangent propagation, dW
// outer products), against 4 (1 + n_in) bytes read and written per point: far above
// the memory roofline.  So every intermediate stays on chip.  Each thread owns one point and keeps
// that point's panels in its own shared-memory column (threads on neighbouring columns:
// conflict-free); weights sit in shared memory and are read as float4 broadcasts.  Only
// out / dout (forward, JVP) and one gradient partial per block (backward) are written.
//
// Where the per-point state lives.  The forward and the JVP keep only the current
// layer: (1 + n_in) H floats (forward) and (2 (1 + n_in) + 1) H (JVP: s, ds and dsp),
// overwriting a panel in place once its inputs are in registers.  The backward needs
// every hidden layer's activation a_l and tangent pre-activations P_l^j (layer 0's
// P_0^j is the W_0 column, not stored): L H + (L - 1) n_in H floats; going down the
// layers the same slots are reused for the cotangents.  That state bounds the backward:
// at w48x3 (440 floats, 1.7 KB per point) a block of 96 threads fills the SM's shared
// memory, 3 warps per SM, and the kernel is latency-bound.  Block sizes are the ones
// that keep the most threads resident per SM (occupancy calculator).
//
// TPU -> Hopper translation.  The TPU grid runs in order and sums dW across grid steps
// in place (_bwd_kernel's accum); here the backward is persistent (each block walks a
// fixed, strided set of point tiles into its own partial) and vj_reduce_kernel sums the
// partials in block order: no atomics, bit-reproducible gradients.  The lane-packed
// [H, (1 + n) T] panels only fed the MXU; here the panels are loops over rows.
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
#define VJ_MAX_SPLIT 8  // point chunks per tile in vj_block_outer

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

// out[r] = vj_dot(w + r * HP, v) for the 4 consecutive rows r of W, in vj_dot's
// summation order: eight independent FMA chains instead of two.  The backward, at 3
// warps per SM, has little else to hide shared-memory latency with: 86 -> 76 ms at
// w48x3 on an H100.  The forward measured slower with it (8.3 -> 10.4 ms) and the JVP
// no faster, so they keep vj_dot.
template <int HP>
__device__ __forceinline__ void vj_dot4(const float* w, const float v[HP], float out[4]) {
  float s[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll
  for (int i4 = 0; i4 < HP / 4; ++i4) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 q = reinterpret_cast<const float4*>(w + r * HP)[i4];
      s[r][0] = fmaf(q.x, v[4 * i4 + 0], s[r][0]);
      s[r][1] = fmaf(q.y, v[4 * i4 + 1], s[r][1]);
      s[r][0] = fmaf(q.z, v[4 * i4 + 2], s[r][0]);
      s[r][1] = fmaf(q.w, v[4 * i4 + 3], s[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) out[r] = s[r][0] + s[r][1];
}

// out[c] = sum_i W[i][m0 + c] v[i], c < 4: four entries of W^T v from float4 loads of
// W's rows (W [HP][HP] in shared memory, m0 a multiple of 4).
template <int HP>
__device__ __forceinline__ void vj_dot4_t(const float* W, int m0, const float v[HP],
                                          float out[4]) {
  float s[4][2];
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c][0] = s[c][1] = 0.0f;
#pragma unroll
  for (int i = 0; i < HP; i += 2) {
    const float4 q0 = *reinterpret_cast<const float4*>(W + i * HP + m0);
    const float4 q1 = *reinterpret_cast<const float4*>(W + (i + 1) * HP + m0);
    s[0][0] = fmaf(q0.x, v[i], s[0][0]);
    s[1][0] = fmaf(q0.y, v[i], s[1][0]);
    s[2][0] = fmaf(q0.z, v[i], s[2][0]);
    s[3][0] = fmaf(q0.w, v[i], s[3][0]);
    s[0][1] = fmaf(q1.x, v[i + 1], s[0][1]);
    s[1][1] = fmaf(q1.y, v[i + 1], s[1][1]);
    s[2][1] = fmaf(q1.z, v[i + 1], s[2][1]);
    s[3][1] = fmaf(q1.w, v[i + 1], s[3][1]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = s[c][0] + s[c][1];
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
// K6 JVP: one thread per point.  Column rows: s panels [k * HP + i] (k = 0..n), then
// ds panels [(1 + n + k) * HP + i], then dsp [(2 + 2n) * HP + i] of the current layer.
template <int HP>
__global__ void vj_jvp_kernel(VjProblem pb, const float* __restrict__ params,
                              const float* __restrict__ dparams, float* __restrict__ dout) {
  extern __shared__ float4 vj_smem4[];
  float* smem = reinterpret_cast<float*>(vj_smem4);
  const int ld = blockDim.x, n = pb.n_in, Lh = pb.n_hidden, act = pb.act;
  const int npp = vj_n_params(HP, Lh);
  float* sW = smem;
  float* sD = sW + npp;
  vj_load(params, sW, npp);
  vj_load(dparams, sD, npp);
  __syncthreads();

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p < pb.P;
  float x[VJ_MAX_IN];
  vj_coords(pb, p, valid, x);
  float* S = sD + npp + threadIdx.x;      // s panels
  float* DS = S + (1 + n) * HP * ld;      // ds panels
  float* DSP = DS + (1 + n) * HP * ld;    // dsp of the current layer

  {
    const float* b0 = sW + vj_off_b(HP, 0);
    const float* db0 = sD + vj_off_b(HP, 0);
    for (int j = 0; j < HP; ++j) {
      const float* w0 = sW + 4 * j;
      const float* dw0 = sD + 4 * j;
      float z = b0[j], dz = db0[j];
#pragma unroll
      for (int i = 0; i < VJ_MAX_IN; ++i) {
        z = fmaf(w0[i], x[i], z);
        dz = fmaf(dw0[i], x[i], dz);
      }
      const float a = vj_act(z, act), sp = vj_dact(a, act), spp = vj_ddact(a, sp, act);
      const float dsp = spp * dz;
      S[j * ld] = a;
      DS[j * ld] = sp * dz;
      for (int k = 0; k < n; ++k) {
        S[((1 + k) * HP + j) * ld] = sp * w0[k];
        DS[((1 + k) * HP + j) * ld] = fmaf(dsp, w0[k], sp * dw0[k]);
      }
    }
  }
  float v[HP], dv[HP];
  for (int l = 1; l < Lh; ++l) {
    const float* W = sW + vj_off_w(HP, l);
    const float* dW = sD + vj_off_w(HP, l);
    const float* b = sW + vj_off_b(HP, l);
    const float* db = sD + vj_off_b(HP, l);
    vj_load_col<HP>(S, ld, v);
    vj_load_col<HP>(DS, ld, dv);
    for (int j = 0; j < HP; ++j) {
      const float z = b[j] + vj_dot<HP>(W + j * HP, v);
      const float dz = db[j] + vj_dot<HP>(dW + j * HP, v) + vj_dot<HP>(W + j * HP, dv);
      const float a = vj_act(z, act), sp = vj_dact(a, act), spp = vj_ddact(a, sp, act);
      S[j * ld] = a;
      DS[j * ld] = sp * dz;
      DSP[j * ld] = spp * dz;
    }
    for (int k = 1; k <= n; ++k) {
      float* sk = S + k * HP * ld;
      float* dsk = DS + k * HP * ld;
      vj_load_col<HP>(sk, ld, v);
      vj_load_col<HP>(dsk, ld, dv);
      for (int j = 0; j < HP; ++j) {
        const float zc = vj_dot<HP>(W + j * HP, v);
        const float dzc = vj_dot<HP>(dW + j * HP, v) + vj_dot<HP>(W + j * HP, dv);
        const float sp = vj_dact(S[j * ld], act);
        sk[j * ld] = sp * zc;
        dsk[j * ld] = fmaf(DSP[j * ld], zc, sp * dzc);
      }
    }
  }
  const float* wout = sW + vj_off_wout(HP, Lh);
  const float* dwout = sD + vj_off_wout(HP, Lh);
  if (!valid) return;
  for (int k = 0; k <= n; ++k) {
    vj_load_col<HP>(S + k * HP * ld, ld, v);
    vj_load_col<HP>(DS + k * HP * ld, ld, dv);
    const float s = vj_dot<HP>(dwout, v) + vj_dot<HP>(wout, dv);
    dout[k * pb.P + p] = k == 0 ? s + dwout[HP] : s;
  }
}

// ------------------------------------------------------------------------------------
// K5 backward.
//
// Block-cooperative outer-product reduction over the block's T points, for one layer:
//   sG[off_w + i * Cpack + m] += sum_p G0[i][p] in0[m][p] + sum_k GK_k[i][p] t_k[m][p]
//   sG[off_b + i]             += sum_p G0[i][p]
// for rows i < R and columns m < C (multiples of 4; RT rows per thread tile), panels
// k < n.  The tangent inputs are t_k[m] = act'(in0[m]) * pre_k[m], where pre_k is read
// from PreK (rows [k * HP + m]) or, when PreK is null, is the W_0 column sW0[m * 4 + k];
// with unit_in (layer 0) they are the unit vectors t_k[m] = (m == k) and in0 = xs.
// Each thread owns an RT x 4 register tile over one of S contiguous point chunks; the
// chunks' tiles are added to sG one chunk after another, so every sum has a fixed order.
// Ends with __syncthreads().
template <int RT, int HP>
__device__ __forceinline__ void vj_block_outer(float* sG, int R, int C, int Cpack, int n,
                                               const float* G0, const float* GK,
                                               int gk_stride, const float* in0,
                                               const float* PreK, const float* sW0,
                                               bool unit_in, int act, int ld, int T,
                                               int off_w, int off_b) {
  const int n_col = C / 4;
  const int n_tiles = (R / RT) * n_col;
  int S = T / n_tiles;
  S = S < 1 ? 1 : (S > VJ_MAX_SPLIT ? VJ_MAX_SPLIT : S);
  const int chunk = (T + S - 1) / S;
  for (int base = 0; base < n_tiles * S; base += blockDim.x) {
    const int u = base + threadIdx.x;
    const bool active = u < n_tiles * S;
    const int tile = u % n_tiles, s = u / n_tiles;
    const int i0 = (tile / n_col) * RT, m0 = (tile % n_col) * 4;
    float acc[RT][4], bias[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      bias[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    }
    if (active) {
      const int j1 = (s + 1) * chunk < T ? (s + 1) * chunk : T;
      for (int j = s * chunk; j < j1; ++j) {
        float a[4], sp[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          a[c] = in0[(m0 + c) * ld + j];
          sp[c] = vj_dact(a[c], act);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float g = G0[(i0 + r) * ld + j];
          bias[r] += g;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(g, a[c], acc[r][c]);
        }
        for (int k = 0; k < n; ++k) {
          float t[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = m0 + c;
            if (unit_in)
              t[c] = m == k ? 1.0f : 0.0f;
            else
              t[c] = sp[c] * (PreK ? PreK[(k * HP + m) * ld + j] : sW0[m * 4 + k]);
          }
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float g = GK[(k * gk_stride + i0 + r) * ld + j];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(g, t[c], acc[r][c]);
          }
        }
      }
    }
    for (int k = 0; k < S; ++k) {
      if (active && s == k) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) sG[off_w + (i0 + r) * Cpack + m0 + c] += acc[r][c];
          if (m0 == 0) sG[off_b + i0 + r] += bias[r];
        }
      }
      __syncthreads();
    }
  }
}

// Persistent backward: block b walks point tiles b, b + gridDim.x, ... of blockDim.x
// points, accumulating its gradient partial in shared memory, and writes it to
// partials[b] once.  Per point (column stride ld = T + 1):
//   A  [Lh][HP]          a_l; later gz_l, then ga_{l-1} = W_l^T gz_l
//   PR [max(Lh-1,1)][n][HP]  slot l-1 holds P_l^j (l >= 1); later the tangent
//                        cotangents: gp_l^j of layer l sits in slot min(l, Lh-2) (slot 0
//                        when Lh = 1) and gJ_{l-1}^j = W_l^T gp_l^j goes to slot l-1
//   X  [4]               scaled coordinates
//   GO [1 + n]           the cotangent g of out (u row, then the du rows)
template <int HP>
__global__ void vj_bwd_kernel(VjProblem pb, const float* __restrict__ params,
                              const float* __restrict__ g, float* __restrict__ partials,
                              long long n_tiles) {
  extern __shared__ float4 vj_smem4[];
  float* smem = reinterpret_cast<float*>(vj_smem4);
  const int T = blockDim.x, tid = threadIdx.x, ld = T + 1;
  const int n = pb.n_in, Lh = pb.n_hidden, act = pb.act;
  const int npp = vj_n_params(HP, Lh);
  float* sW = smem;
  float* sG = sW + npp;
  float* A = sG + npp;
  float* PR = A + Lh * HP * ld;
  const int n_slots = Lh > 1 ? Lh - 1 : 1;
  float* X = PR + n_slots * n * HP * ld;
  float* GO = X + VJ_MAX_IN * ld;
  const int lstride = HP * ld, sstride = n * HP * ld;  // A layer / PR slot strides
  vj_load(params, sW, npp);
  for (int i = tid; i < npp; i += T) sG[i] = 0.0f;
  __syncthreads();

  const int off_wout = vj_off_wout(HP, Lh);
  const float* wout = sW + off_wout;
  float v[HP];
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p = tile * T + tid;
    const bool valid = p < pb.P;
    float x[VJ_MAX_IN];
    vj_coords(pb, p, valid, x);
#pragma unroll
    for (int j = 0; j < VJ_MAX_IN; ++j) X[j * ld + tid] = x[j];
    for (int k = 0; k <= n; ++k) GO[k * ld + tid] = valid ? g[k * pb.P + p] : 0.0f;

    // forward recompute: a_l, and P_l^j for l >= 1
    {
      const float* b0 = sW + vj_off_b(HP, 0);
      for (int j = 0; j < HP; ++j) {
        const float* w0 = sW + 4 * j;
        float z = b0[j];
#pragma unroll
        for (int i = 0; i < VJ_MAX_IN; ++i) z = fmaf(w0[i], x[i], z);
        A[j * ld + tid] = vj_act(z, act);
      }
    }
    for (int l = 1; l < Lh; ++l) {
      const float* W = sW + vj_off_w(HP, l);
      const float* b = sW + vj_off_b(HP, l);
      const float* aIn = A + (l - 1) * lstride + tid;
      vj_load_col<HP>(aIn, ld, v);
      float* aOut = A + l * lstride + tid;
      float z[4];
      for (int j = 0; j < HP; j += 4) {
        vj_dot4<HP>(W + j * HP, v, z);
#pragma unroll
        for (int r = 0; r < 4; ++r) aOut[(j + r) * ld] = vj_act(b[j + r] + z[r], act);
      }
      for (int k = 0; k < n; ++k) {
        // J_{l-1}^k = act'(a_{l-1}) * P_{l-1}^k, with P_0^k the W_0 column
        const float* pIn = l > 1 ? PR + (l - 2) * sstride + k * lstride + tid : nullptr;
#pragma unroll
        for (int i = 0; i < HP; ++i)
          v[i] = vj_dact(aIn[i * ld], act) * (pIn ? pIn[i * ld] : sW[i * 4 + k]);
        float* pOut = PR + (l - 1) * sstride + k * lstride + tid;
        for (int j = 0; j < HP; j += 4) {
          vj_dot4<HP>(W + j * HP, v, z);
#pragma unroll
          for (int r = 0; r < 4; ++r) pOut[(j + r) * ld] = z[r];
        }
      }
    }
    __syncthreads();
    // output layer: dw_out += g_u a + sum_k g_k J^k (R = 1 row)
    vj_block_outer<1, HP>(sG, 1, HP, HP, n, GO, GO + ld, 1, A + (Lh - 1) * lstride,
                          Lh > 1 ? PR + (Lh - 2) * sstride : nullptr, sW, false, act, ld,
                          T, off_wout, off_wout + HP);

    for (int l = Lh - 1; l >= 0; --l) {
      const bool top = l == Lh - 1;
      float* aL = A + l * lstride;
      const int gslot = l < Lh - 2 ? l : (Lh >= 2 ? Lh - 2 : 0);
      float* gpL = PR + gslot * sstride;                      // gp_l^k (rows k * HP + i)
      const float* gjIn = top ? nullptr : PR + l * sstride;   // gJ_l^k
      const float* preL = l > 0 ? PR + (l - 1) * sstride : nullptr;  // P_l^k
      for (int i = 0; i < HP; ++i) {
        const float a = aL[i * ld + tid];
        const float sp = vj_dact(a, act), spp = vj_ddact(a, sp, act);
        const float ga = top ? wout[i] * GO[tid] : aL[lstride + i * ld + tid];
        float acc = 0.0f;
        for (int k = 0; k < n; ++k) {
          const int r = (k * HP + i) * ld + tid;
          const float gj = top ? wout[i] * GO[(1 + k) * ld + tid] : gjIn[r];
          const float pre = l == 0 ? sW[i * 4 + k] : preL[r];
          acc = fmaf(gj, pre, acc);
          gpL[r] = sp * gj;
        }
        aL[i * ld + tid] = fmaf(sp, ga, spp * acc);
      }
      __syncthreads();
      if (l > 0)
        vj_block_outer<4, HP>(sG, HP, HP, HP, n, aL, gpL, HP, aL - lstride,
                              l > 1 ? PR + (l - 2) * sstride : nullptr, sW, false, act, ld,
                              T, vj_off_w(HP, l), vj_off_b(HP, l));
      else
        vj_block_outer<4, HP>(sG, HP, VJ_MAX_IN, VJ_MAX_IN, n, aL, gpL, HP, X, nullptr, sW,
                              true, act, ld, T, 0, vj_off_b(HP, 0));
      if (l > 0) {
        // cotangents of layer l-1: W_l^T gz into a_l's slot, W_l^T gp^k into slot l-1
        const float* W = sW + vj_off_w(HP, l);
        for (int k = -1; k < n; ++k) {
          const float* src = k < 0 ? aL + tid : gpL + k * lstride + tid;
          float* dst = k < 0 ? aL + tid : PR + (l - 1) * sstride + k * lstride + tid;
          vj_load_col<HP>(src, ld, v);
          float t4[4];
          for (int m = 0; m < HP; m += 4) {
            vj_dot4_t<HP>(W, m, v, t4);
#pragma unroll
            for (int c = 0; c < 4; ++c) dst[(m + c) * ld] = t4[c];
          }
        }
      }
    }
  }
  for (int i = tid; i < npp; i += T) partials[(long long)blockIdx.x * npp + i] = sG[i];
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

const int kThreadChoices[] = {256, 224, 192, 160, 128, 96, 64, 32};
const size_t kMaxSmem = 227 * 1024;  // a block's shared-memory limit on sm_90

enum Kind { kFwd, kJvp, kBwd };

// Shared memory (bytes) of a block of T threads.
size_t smem_bytes(Kind kind, int hp, int n_hidden, int n_in, int T) {
  const size_t npp = vj_n_params(hp, n_hidden);
  const size_t h = hp;
  switch (kind) {
    case kFwd:
      return sizeof(float) * (npp + (1 + n_in) * h * T);
    case kJvp:
      return sizeof(float) * (2 * npp + (2 * (1 + n_in) + 1) * h * T);
    default: {
      const size_t slots = n_hidden > 1 ? n_hidden - 1 : 1;
      const size_t per_point = n_hidden * h + slots * n_in * h + VJ_MAX_IN + 1 + n_in;
      return sizeof(float) * (2 * npp + per_point * (T + 1));
    }
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

// The block size that keeps the most threads resident per SM (shared memory and
// registers, from the occupancy calculator), and that count of blocks per SM.
template <int HP>
int pick_block(Kind kind, int n_hidden, int n_in, int* threads, int* per_sm_out) {
  const void* fn = kernel_of<HP>(kind);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  int best_T = 0, best_per_sm = 0;
  for (int T : kThreadChoices) {
    const size_t smem = smem_bytes(kind, HP, n_hidden, n_in, T);
    if (smem > kMaxSmem) continue;
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, T, smem)) !=
        cudaSuccess)
      return (int)err;
    if (per_sm * T > best_per_sm * best_T) {
      best_T = T;
      best_per_sm = per_sm;
    }
  }
  if (best_T == 0) return (int)cudaErrorInvalidConfiguration;
  *threads = best_T;
  *per_sm_out = best_per_sm;
  return 0;
}

template <int HP>
int launch_pointwise(Kind kind, const VjProblem& pb, const float* params, const float* dparams,
                     float* out, cudaStream_t stream) {
  int T = 0, per_sm = 0;
  int err = pick_block<HP>(kind, pb.n_hidden, pb.n_in, &T, &per_sm);
  if (err) return err;
  const size_t smem = smem_bytes(kind, HP, pb.n_hidden, pb.n_in, T);
  const long long grid = (pb.P + T - 1) / T;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (kind == kFwd)
    vj_fwd_kernel<HP><<<(unsigned)grid, T, smem, stream>>>(pb, params, out);
  else
    vj_jvp_kernel<HP><<<(unsigned)grid, T, smem, stream>>>(pb, params, dparams, out);
  return (int)cudaGetLastError();
}

// Threads per block and grid of the persistent backward: one wave of blocks, or fewer
// when there are fewer tiles.
template <int HP>
int bwd_config(const VjProblem& pb, int* threads, int* blocks) {
  int T = 0, per_sm = 0;
  int err = pick_block<HP>(kBwd, pb.n_hidden, pb.n_in, &T, &per_sm);
  if (err) return err;
  int dev = 0, n_sm = 0;
  cudaError_t cerr;
  if ((cerr = cudaGetDevice(&dev)) != cudaSuccess) return (int)cerr;
  if ((cerr = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)cerr;
  const long long n_tiles = (pb.P + T - 1) / T;
  const long long b = (long long)per_sm * n_sm;
  *threads = T;
  *blocks = (int)(b < n_tiles ? b : (n_tiles > 0 ? n_tiles : 1));
  return 0;
}

template <int HP>
int launch_bwd(const VjProblem& pb, const float* params, const float* g, float* partials,
               int n_blocks, float* grad, cudaStream_t stream) {
  int T = 0, want = 0;
  int err = bwd_config<HP>(pb, &T, &want);
  if (err) return err;
  if (n_blocks != want) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(kBwd, HP, pb.n_hidden, pb.n_in, T);
  const long long n_tiles = (pb.P + T - 1) / T;
  vj_bwd_kernel<HP><<<n_blocks, T, smem, stream>>>(pb, params, g, partials, n_tiles);
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
  VJ_DISPATCH(hp, launch_pointwise<HP>(kFwd, pb, params, nullptr, out, (cudaStream_t)stream))
}

// dout [1 + n_in][P]: tangent of out along the packed parameter tangent dparams.
int vj_jvp(const float* xs, const float* params, const float* dparams, float* dout,
           long long P, int n_in, int n_hidden, int hp, int act, void* stream) {
  if (bad_shape(P, n_in, n_hidden)) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const VjProblem pb = make_problem(xs, P, n_in, n_hidden, act);
  VJ_DISPATCH(hp, launch_pointwise<HP>(kJvp, pb, params, dparams, dout, (cudaStream_t)stream))
}

// Number of backward blocks (rows of the partials buffer) on the current device.
int vj_bwd_blocks(long long P, int n_in, int n_hidden, int hp, int* blocks) {
  if (bad_shape(P, n_in, n_hidden)) return (int)cudaErrorInvalidValue;
  const VjProblem pb = make_problem(nullptr, P, n_in, n_hidden, 0);
  int threads = 0;
  VJ_DISPATCH(hp, bwd_config<HP>(pb, &threads, blocks))
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
