// Fourier-feature MLP kernels for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replace the TPU kernels of the JAX package that run the trial net
// u = MLP([sin | cos](2 pi B^T xs)) with a fixed B:
//   ff_fwd_kernel (residual mode) <- ops/pallas_residual.py::_fused_residual_fn,
//                                    directional, n_ff > 0 (_dir_fwd_kernel)   K2-FF forward
//   ff_bwd_kernel (residual mode) <- the same, _dir_bwd_kernel                  K2-FF backward
//   ff_fwd_kernel (unit mode)     <- ops/pallas_mlp.py::_fwd_pallas_ff          K7 forward
//   ff_bwd_kernel (unit mode)     <- ops/pallas_mlp.py::_bwd_pallas_ff          K7 backward
//   ff_jvp_kernel                 <- ops/pallas_mlp.py::_jvp_pallas_ff          K8
//
// All of them push a few point PANELS through one layer stack: the value panel and one
// forward-mode tangent panel per direction.  K2-FF has one direction per point, the
// weak-form vector c (its output is r_k = sum_q dd + csrc + cu u); K7 has the n_in unit
// vectors of the scaled coordinates (its output is [u, du/dxs]); K8 carries the K7
// panels and their parameter tangents (2 (1 + n_in) panels).  Layer 0's input is the
// embedding E = [sin | cos](ang), ang = bt xs (bt = 2 pi B^T [F][n_in]), and along a
// direction v its tangent [cos | -sin](ang) * (bt v).  B is fixed: nothing flows to it.
// Without bt (a null pointer) layer 0 takes the scaled coordinates themselves and, along
// v, v (a plain MLP, padded to ke = 32 input rows): the same kernels then carry the
// plain nets wider than value_and_jac.cu and dir_residual.cu take (hidden width 65..128).
//
// What bounds them: f32 FMA throughput.  At the contaminant net (F = 128, width 96 x 3)
// the forward does about 87 k FMAs per point per panel, the backward (recompute, two
// panels of cotangents, the dW outer products) about three times that, against tens of
// bytes read per point.  The per-point state does not fit the one-point-per-thread
// design of dir_residual.cu / value_and_jac.cu (a point's backward state is over 4 KB
// and W0 alone 96 KB), so here a block of FF_NT threads owns a tile of points, and
// every layer is a block-wide register-tiled product
//     Out [HP][panels x T] = W [HP][K] x In [K][panels x T],
// the weights streamed through shared memory in K-slices of FF_KS rows, each thread
// holding a 4 x 4 output tile per 32 rows.  The panels of every layer stay in shared
// memory; the embedding is stored as sin / cos per feature and point, and the layer-0
// input slices are formed from it as they are streamed.  The parameter gradient is a
// second block product (dW [K][HP] += sum over the tile's columns) added into the
// block's own partial in device memory (L2 resident); a second kernel sums the
// partials in block order.  No atomics: the gradient is bit-reproducible, which CG needs.
//
// TPU -> Hopper: the TPU grid ran point tiles in order and summed dW in place; here the
// backward is persistent (block b walks tiles b, b + gridDim.x, ...).  The TPU's whole
// [2F, T] embedding panels in VMEM become sin / cos columns in shared memory.
//
// Angles reach ~76 rad at the contaminant's unscaled inputs: sincosf keeps full range
// reduction (no __sinf, no fast math), and the angle is formed from bt as the JAX
// kernels form it (bt[f][0] x_0 + bt[f][1] x_1 + ...).
//
// Packed parameter layout (floats; ops/fused_residual.py::ff_pack_index mirrors it):
// hidden widths zero-padded to HP (a multiple of 32, at most 128), the features to FP (a
// multiple of 16), KE = 2 FP; weights stored [fan_in][fan_out] (as w in the JAX layout):
//   W0 [KE][HP] (rows f: sin f, FP + f: cos f) | b0 [HP] | (W_l [HP][HP] | b_l [HP])
//   for l = 1..L-1 | w_out [HP] | b_out | pad to 4.
// Gradients and parameter tangents use the same layout.

#include <cuda_runtime.h>
#include <math.h>

#define FF_NT 128      // threads per block
#define FF_C 64        // panel columns of a tile: panels x points
#define FF_LD 68       // row stride of a panel buffer (float4 rows, odd in 16-byte units)
#define FF_KS 32       // rows of a streamed K-slice
#define FF_MAX_IN 4
#define FF_MAX_T 32    // points per tile at the fewest (2) panels

__host__ __device__ inline int ff_off_w(int hp, int ke, int l) {  // l >= 1; W0 is at 0
  return ke * hp + hp + (l - 1) * (hp * hp + hp);
}
__host__ __device__ inline int ff_off_b(int hp, int ke, int l) {
  return l == 0 ? ke * hp : ff_off_w(hp, ke, l) + hp * hp;
}
__host__ __device__ inline int ff_off_wout(int hp, int ke, int n_hidden) {
  return ke * hp + hp + (n_hidden - 1) * (hp * hp + hp);
}
__host__ __device__ inline int ff_n_params(int hp, int ke, int n_hidden) {
  return (ff_off_wout(hp, ke, n_hidden) + hp + 1 + 3) / 4 * 4;
}
// Shared memory (floats) of a block with nbuf panel buffers and tabf table floats.
__host__ __device__ inline int ff_smem_floats(int hp, int nbuf, int ke, int tabf) {
  return FF_KS * hp + FF_KS * FF_LD + nbuf * hp * FF_LD + ke * FF_MAX_T + ke / 2 * 4 +
         tabf + 4 + FF_MAX_IN * FF_MAX_T + FF_MAX_IN * FF_MAX_IN * FF_MAX_T + 2 * FF_MAX_T +
         FF_C;
}

// act: 0 = tanh, 1 = sigmoid.  Derivatives are functions of the output a.
__device__ __forceinline__ float ff_act(float z, int act) {
  return act == 0 ? tanhf(z) : 1.0f / (1.0f + expf(-z));
}
__device__ __forceinline__ float ff_dact(float a, int act) {
  return act == 0 ? 1.0f - a * a : a * (1.0f - a);
}
__device__ __forceinline__ float ff_ddact(float a, float sp, int act) {
  return act == 0 ? -2.0f * a * sp : (1.0f - 2.0f * a) * sp;
}

struct FfProblem {
  const float* xs;     // [n_in][P] scaled coordinates
  const float* bt;     // [ke / 2][4] 2 pi B^T, features and n_in zero-padded; null: no
                       // embedding (layer 0 reads xs and the directions)
  const float* flds;   // residual mode: [2 + d (+1)][P] kappa, vel, src[, react]; else null
  const float* tab;    // residual mode: [nq][2 + d] N, w, dN_0..
  const float* scale;  // residual mode: [n_in] input scale
  long long P;
  int n_in, np, T;     // np panels (value + np - 1 directions), T points per tile
  int ke, n_hidden, act;
  int nq, d, td, has_react;
};

struct FfSmem {
  float *Ws, *In, *A, *Sin, *Cos, *bt, *tab, *scale, *X, *Dir, *Cf, *Go;
};

__device__ __forceinline__ FfSmem ff_smem(float* s, int hp, int nbuf, const FfProblem& pb,
                                          int tabf) {
  FfSmem m;
  const int fp = pb.ke / 2;
  m.Ws = s;    s += FF_KS * hp;                    // [FF_KS][hp] weight slice
  m.In = s;    s += FF_KS * FF_LD;                 // [FF_KS][FF_LD] input slice
  m.A = s;     s += nbuf * hp * FF_LD;             // nbuf x [hp][FF_LD] panel buffers
  m.Sin = s;   s += fp * FF_MAX_T;                 // [fp][FF_MAX_T]
  m.Cos = s;   s += fp * FF_MAX_T;
  m.bt = s;    s += fp * 4;
  m.tab = s;   s += tabf;
  m.scale = s; s += 4;
  m.X = s;     s += FF_MAX_IN * FF_MAX_T;          // [j][pt]
  m.Dir = s;   s += FF_MAX_IN * FF_MAX_IN * FF_MAX_T;  // [direction][j][pt]
  m.Cf = s;    s += 2 * FF_MAX_T;                  // cu, csrc per point
  m.Go = s;                                        // [FF_C] outputs or output cotangents
  return m;
}

__device__ __forceinline__ void ff_load_consts(const FfProblem& pb, const FfSmem& sm) {
  if (pb.bt)
    for (int i = threadIdx.x; i < pb.ke / 2 * 4; i += FF_NT) sm.bt[i] = pb.bt[i];
  if (pb.flds) {
    for (int i = threadIdx.x; i < pb.nq * (2 + pb.d); i += FF_NT) sm.tab[i] = pb.tab[i];
    if (threadIdx.x < 4)
      sm.scale[threadIdx.x] = (int)threadIdx.x < pb.n_in ? pb.scale[threadIdx.x] : 0.0f;
  }
}

// The tile's coordinates, tangent directions and (residual mode) coefficients -- the
// math of _dir_coeffs -- then sin / cos of every feature at every point.
__device__ void ff_tile_setup(const FfProblem& pb, const FfSmem& sm, long long tile) {
  const int tid = threadIdx.x, T = pb.T;
  __syncthreads();  // the previous tile is done with these arrays
  if (tid < T) {
    const long long p = tile * T + tid;
    const bool valid = p < pb.P;
    float x[FF_MAX_IN];
#pragma unroll
    for (int j = 0; j < FF_MAX_IN; ++j) {
      x[j] = (valid && j < pb.n_in) ? pb.xs[j * pb.P + p] : 0.0f;
      sm.X[j * FF_MAX_T + tid] = x[j];
    }
    if (pb.flds) {
      float c[FF_MAX_IN] = {0.0f, 0.0f, 0.0f, 0.0f};
      float cu = 0.0f, csrc = 0.0f;
      if (valid) {
        const float* row = sm.tab + (int)(p % pb.nq) * (2 + pb.d);
        const float n_q = row[0], w_q = row[1];
        const float kappa = pb.flds[p];
#pragma unroll
        for (int j = 0; j < FF_MAX_IN; ++j) {
          if (j < pb.d) {
            const float vel = pb.flds[(1 + j) * pb.P + p];
            c[j] = w_q * sm.scale[j] * (vel * n_q + kappa * row[2 + j]);
          } else if (j == pb.d && pb.td) {
            c[j] = w_q * sm.scale[j] * n_q;
          }
        }
        csrc = -w_q * n_q * pb.flds[(1 + pb.d) * pb.P + p];
        if (pb.has_react) cu = w_q * n_q * pb.flds[(2 + pb.d) * pb.P + p];
      }
#pragma unroll
      for (int j = 0; j < FF_MAX_IN; ++j) sm.Dir[j * FF_MAX_T + tid] = c[j];
      sm.Cf[tid] = cu;
      sm.Cf[FF_MAX_T + tid] = csrc;
    } else {
      for (int m = 0; m < pb.np - 1; ++m)
#pragma unroll
        for (int j = 0; j < FF_MAX_IN; ++j)
          sm.Dir[(m * FF_MAX_IN + j) * FF_MAX_T + tid] = j == m ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  const int fp = pb.bt ? pb.ke / 2 : 0;
  for (int i = tid; i < fp * T; i += FF_NT) {
    const int f = i / T, pt = i % T;
    const float* b = sm.bt + 4 * f;
    float ang = b[0] * sm.X[pt];
#pragma unroll
    for (int j = 1; j < FF_MAX_IN; ++j) ang += b[j] * sm.X[j * FF_MAX_T + pt];
    float s, c;
    sincosf(ang, &s, &c);
    sm.Sin[f * FF_MAX_T + pt] = s;
    sm.Cos[f * FF_MAX_T + pt] = c;
  }
  __syncthreads();
}

// Row k of the embedded layer-0 input for panel m at point pt: the value panel
// [sin | cos](ang), or the tangent along direction m - 1, [cos | -sin](ang) (bt . v).
// fp = 0 (no embedding): x_k, or v_k along direction m - 1 (0 for k >= FF_MAX_IN).
__device__ __forceinline__ float ff_emb(const FfSmem& sm, int fp, int k, int m, int pt) {
  if (fp == 0) {
    if (k >= FF_MAX_IN) return 0.0f;
    return m == 0 ? sm.X[k * FF_MAX_T + pt] : sm.Dir[((m - 1) * FF_MAX_IN + k) * FF_MAX_T + pt];
  }
  const bool second = k >= fp;
  const int f = second ? k - fp : k;
  const float s = sm.Sin[f * FF_MAX_T + pt], c = sm.Cos[f * FF_MAX_T + pt];
  if (m == 0) return second ? c : s;
  const float* b = sm.bt + 4 * f;
  const float* v = sm.Dir + (m - 1) * FF_MAX_IN * FF_MAX_T + pt;
  float pc = b[0] * v[0];
#pragma unroll
  for (int j = 1; j < FF_MAX_IN; ++j) pc += b[j] * v[j * FF_MAX_T];
  return second ? -s * pc : c * pc;
}

// Row k of a hidden layer's output panel m at column col = m T + pt of a buffer that
// holds the activation a (panel 0) and the tangent PRE-activations (panels >= 1).
__device__ __forceinline__ float ff_hid(const float* A, int k, int m, int col, int pt,
                                        int act) {
  const float a = A[k * FF_LD + pt];
  return m == 0 ? a : ff_dact(a, act) * A[k * FF_LD + col];
}

// acc[i][r][c] += sum_{k < K} W(32 i + 4 rg + r, k) In(k, c0 + c), rg = tid / 16,
// c0 = 4 (tid % 16).  W streams through sWs in FF_KS-row slices: TRANS = false reads
// W(r, k) = w[k HP + r] (a weight in the packed layout), TRANS = true W(r, k) = w[r HP + k]
// (its transpose).  fill(k0, sIn) stages In(k0 + kk, c) at sIn[kk FF_LD + c].
template <int NI, bool TRANS, class Fill>
__device__ void ff_mm(float (&acc)[NI][4][4], const float* __restrict__ w, int K, float* sWs,
                      float* sIn, Fill fill) {
  constexpr int HP = 32 * NI;
  const int tid = threadIdx.x, rg = tid / 16, c0 = (tid % 16) * 4;
  for (int k0 = 0; k0 < K; k0 += FF_KS) {
    __syncthreads();
    for (int i = tid; i < FF_KS * HP; i += FF_NT) {
      if (TRANS) {
        const int kk = i % FF_KS, r = i / FF_KS;
        sWs[kk * HP + r] = w[r * HP + k0 + kk];
      } else {
        const int r = i % HP, kk = i / HP;
        sWs[kk * HP + r] = w[(k0 + kk) * HP + r];
      }
    }
    fill(k0, sIn);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FF_KS; ++kk) {
      const float4 x4 = *reinterpret_cast<const float4*>(sIn + kk * FF_LD + c0);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float4 w4 = *reinterpret_cast<const float4*>(sWs + kk * HP + 32 * i + 4 * rg);
        const float wr[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][r][c] = fmaf(wr[r], x[c], acc[i][r][c]);
      }
    }
  }
  __syncthreads();
}

template <int NI>
__device__ __forceinline__ void ff_zero(float (&acc)[NI][4][4]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][r][c] = 0.0f;
}

// part[off + k HP + r] += sum_{c < FF_C} G[r][c] In(k, c) for r < HP, k < K: the weight
// gradient against the layer input.  Lane = row (conflict-free G reads), each warp 8 of
// the FF_KS staged input rows (broadcast reads).  Each (r, k) has one owner thread and
// a fixed summation order.
template <int NI, class Fill>
__device__ void ff_outer(float* __restrict__ part, int off, int K, const float* G,
                         float* sIn, Fill fill) {
  constexpr int HP = 32 * NI;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int k0 = 0; k0 < K; k0 += FF_KS) {
    __syncthreads();
    fill(k0, sIn);
    __syncthreads();
    float acc[NI][8];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) acc[i][kk] = 0.0f;
    for (int c = 0; c < FF_C; c += 4) {
      float4 g[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i)
        g[i] = *reinterpret_cast<const float4*>(G + (lane + 32 * i) * FF_LD + c);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float4 x = *reinterpret_cast<const float4*>(sIn + (8 * warp + kk) * FF_LD + c);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float a = acc[i][kk];
          a = fmaf(g[i].x, x.x, a);
          a = fmaf(g[i].y, x.y, a);
          a = fmaf(g[i].z, x.z, a);
          acc[i][kk] = fmaf(g[i].w, x.w, a);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        part[off + (k0 + 8 * warp + kk) * HP + lane + 32 * i] += acc[i][kk];
  }
  __syncthreads();
}

// Stores a layer's product: panel 0 -> act(acc + b), the other panels the raw
// tangent pre-activations; columns of no panel get 0.
template <int NI>
__device__ __forceinline__ void ff_store(const float (&acc)[NI][4][4],
                                         const float* __restrict__ b, float* Aout, int np,
                                         int T, int act) {
  const int tid = threadIdx.x, rg = tid / 16, c0 = (tid % 16) * 4;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 32 * i + 4 * rg + r;
      const float bias = b[row];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + c, m = col / T;
        const float v = acc[i][r][c];
        Aout[row * FF_LD + col] = m >= np ? 0.0f : (m == 0 ? ff_act(v + bias, act) : v);
      }
    }
}

// Hidden layers of the tile: layer l's (a, pre) panels go to buffer
// A + (keep ? l : l & 1) * HP * FF_LD.  Returns the last layer's buffer.
template <int NI>
__device__ float* ff_forward(const FfProblem& pb, const FfSmem& sm,
                             const float* __restrict__ params, bool keep) {
  constexpr int HP = 32 * NI;
  const int np = pb.np, T = pb.T, act = pb.act, fp = pb.bt ? pb.ke / 2 : 0;
  float acc[NI][4][4];
  float* prev = nullptr;
  for (int l = 0; l < pb.n_hidden; ++l) {
    float* out = sm.A + (keep ? l : (l & 1)) * HP * FF_LD;
    ff_zero<NI>(acc);
    if (l == 0) {
      ff_mm<NI, false>(acc, params, pb.ke, sm.Ws, sm.In, [&](int k0, float* sIn) {
        for (int i = threadIdx.x; i < FF_KS * FF_C; i += FF_NT) {
          const int kk = i / FF_C, c = i % FF_C, m = c / T;
          sIn[kk * FF_LD + c] = m < np ? ff_emb(sm, fp, k0 + kk, m, c % T) : 0.0f;
        }
      });
    } else {
      const float* in = prev;
      ff_mm<NI, false>(acc, params + ff_off_w(HP, pb.ke, l), HP, sm.Ws, sm.In,
                       [&](int k0, float* sIn) {
        for (int i = threadIdx.x; i < FF_KS * FF_C; i += FF_NT) {
          const int kk = i / FF_C, c = i % FF_C, m = c / T;
          sIn[kk * FF_LD + c] = m < np ? ff_hid(in, k0 + kk, m, c, c % T, act) : 0.0f;
        }
      });
    }
    ff_store<NI>(acc, params + ff_off_b(HP, pb.ke, l), out, np, T, act);
    prev = out;
  }
  __syncthreads();
  return prev;
}

// ------------------------------------------------------------------------------------
// Forward (K2-FF in residual mode, K7 in unit mode): one tile per block.
//   residual mode: out [P] = dd + csrc + cu u per point (summed over q by ff_qsum_kernel)
//   unit mode:     out [np][P] = (u, du/dxs_j)
template <int NI>
__global__ void ff_fwd_kernel(FfProblem pb, const float* __restrict__ params,
                              float* __restrict__ out, int tabf) {
  extern __shared__ float4 ff_smem4[];
  constexpr int HP = 32 * NI;
  const FfSmem sm = ff_smem(reinterpret_cast<float*>(ff_smem4), HP, 2, pb, tabf);
  ff_load_consts(pb, sm);
  const long long tile = blockIdx.x;
  ff_tile_setup(pb, sm, tile);
  const float* A = ff_forward<NI>(pb, sm, params, false);
  const float* wout = params + ff_off_wout(HP, pb.ke, pb.n_hidden);
  const int tid = threadIdx.x, T = pb.T;
  if (tid < FF_C) {
    const int m = tid / T, pt = tid % T;
    float s = 0.0f;
    if (m < pb.np) {
      for (int k = 0; k < HP; ++k) s = fmaf(wout[k], ff_hid(A, k, m, tid, pt, pb.act), s);
      if (m == 0) s += wout[HP];
    }
    sm.Go[tid] = s;
  }
  __syncthreads();
  if (tid < T) {
    const long long p = tile * T + tid;
    if (p < pb.P) {
      if (pb.flds) {
        float contrib = sm.Go[T + tid] + sm.Cf[FF_MAX_T + tid];
        if (pb.has_react) contrib += sm.Cf[tid] * sm.Go[tid];
        out[p] = contrib;
      } else {
        for (int m = 0; m < pb.np; ++m) out[m * pb.P + p] = sm.Go[m * T + tid];
      }
    }
  }
}

// r[k] = sum_q contrib[k nq + q], in q order.
__global__ void ff_qsum_kernel(const float* __restrict__ contrib, float* __restrict__ r, int k,
                               int nq) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  float s = 0.0f;
  for (int q = 0; q < nq; ++q) s += contrib[(long long)i * nq + q];
  r[i] = s;
}

// ------------------------------------------------------------------------------------
// Backward (K2-FF in residual mode, K7 in unit mode): persistent, one gradient partial
// per block.  The output cotangent per point is (gr cu, gr) in residual mode (gr [K] per
// test function), g [np][P] in unit mode.  Going down the layers, layer l's buffer
// (a, pre) is overwritten in place with its cotangents (gz, gp); the cotangents passed
// to the layer below, W_l^T (gz, gp), go to the extra buffer G.
template <int NI>
__global__ void ff_bwd_kernel(FfProblem pb, const float* __restrict__ params,
                              const float* __restrict__ g, float* __restrict__ partials,
                              long long n_tiles, int tabf) {
  extern __shared__ float4 ff_smem4[];
  constexpr int HP = 32 * NI;
  const int L = pb.n_hidden, np = pb.np, T = pb.T, act = pb.act, fp = pb.bt ? pb.ke / 2 : 0;
  const FfSmem sm = ff_smem(reinterpret_cast<float*>(ff_smem4), HP, L + 1, pb, tabf);
  const int npp = ff_n_params(HP, pb.ke, L);
  const int tid = threadIdx.x;
  float* part = partials + (long long)blockIdx.x * npp;
  for (int i = tid; i < npp; i += FF_NT) part[i] = 0.0f;
  ff_load_consts(pb, sm);
  const int off_wout = ff_off_wout(HP, pb.ke, L);
  const float* wout = params + off_wout;
  float* G = sm.A + L * HP * FF_LD;
  float acc[NI][4][4];

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    ff_tile_setup(pb, sm, tile);
    const float* Alast = ff_forward<NI>(pb, sm, params, true);
    if (tid < FF_C) {
      const int m = tid / T, pt = tid % T;
      const long long p = tile * T + pt;
      float go = 0.0f;
      if (m < np && p < pb.P) {
        if (pb.flds) {
          const float gr = g[p / pb.nq];
          go = m == 0 ? (pb.has_react ? gr * sm.Cf[pt] : 0.0f) : gr;
        } else {
          go = g[m * pb.P + p];
        }
      }
      sm.Go[tid] = go;
    }
    __syncthreads();
    // output layer: dw_out[k] += sum_c go(c) x(k, c), db_out += sum over the value panel
    for (int k = tid; k < HP; k += FF_NT) {
      float s = 0.0f;
      for (int c = 0; c < np * T; ++c)
        s = fmaf(sm.Go[c], ff_hid(Alast, k, c / T, c, c % T, act), s);
      part[off_wout + k] += s;
    }
    if (tid == 0) {
      float s = 0.0f;
      for (int pt = 0; pt < T; ++pt) s += sm.Go[pt];
      part[off_wout + HP] += s;
    }
    for (int i = tid; i < HP * FF_C; i += FF_NT) {
      const int r = i / FF_C, c = i % FF_C;
      G[r * FF_LD + c] = wout[r] * sm.Go[c];
    }
    __syncthreads();

    for (int l = L - 1; l >= 0; --l) {
      float* Al = sm.A + l * HP * FF_LD;
      // gz = sp ga + spp sum_m gJ_m pre_m, gp_m = sp gJ_m, in place of (a, pre_m)
      for (int i = tid; i < HP * T; i += FF_NT) {
        const int r = i / T, pt = i % T;
        float* row = Al + r * FF_LD;
        const float* grow = G + r * FF_LD;
        const float a = row[pt];
        const float sp = ff_dact(a, act), spp = ff_ddact(a, sp, act);
        float s = 0.0f;
        for (int m = 1; m < np; ++m) {
          const float gj = grow[m * T + pt];
          s = fmaf(gj, row[m * T + pt], s);
          row[m * T + pt] = sp * gj;
        }
        row[pt] = fmaf(sp, grow[pt], spp * s);
      }
      __syncthreads();
      for (int r = tid; r < HP; r += FF_NT) {
        float s = 0.0f;
        for (int pt = 0; pt < T; ++pt) s += Al[r * FF_LD + pt];
        part[ff_off_b(HP, pb.ke, l) + r] += s;
      }
      if (l == 0) {
        ff_outer<NI>(part, 0, pb.ke, Al, sm.In, [&](int k0, float* sIn) {
          for (int i = threadIdx.x; i < FF_KS * FF_C; i += FF_NT) {
            const int kk = i / FF_C, c = i % FF_C, m = c / T;
            sIn[kk * FF_LD + c] = m < np ? ff_emb(sm, fp, k0 + kk, m, c % T) : 0.0f;
          }
        });
      } else {
        const float* in = sm.A + (l - 1) * HP * FF_LD;
        ff_outer<NI>(part, ff_off_w(HP, pb.ke, l), HP, Al, sm.In, [&](int k0, float* sIn) {
          for (int i = threadIdx.x; i < FF_KS * FF_C; i += FF_NT) {
            const int kk = i / FF_C, c = i % FF_C, m = c / T;
            sIn[kk * FF_LD + c] = m < np ? ff_hid(in, k0 + kk, m, c, c % T, act) : 0.0f;
          }
        });
        ff_zero<NI>(acc);
        ff_mm<NI, true>(acc, params + ff_off_w(HP, pb.ke, l), HP, sm.Ws, sm.In,
                        [&](int k0, float* sIn) {
          for (int i = threadIdx.x; i < FF_KS * FF_C; i += FF_NT) {
            const int kk = i / FF_C, c = i % FF_C;
            sIn[kk * FF_LD + c] = Al[(k0 + kk) * FF_LD + c];
          }
        });
        const int rg = tid / 16, c0 = (tid % 16) * 4;
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              G[(32 * i + 4 * rg + r) * FF_LD + c0 + c] = acc[i][r][c];
        __syncthreads();
      }
    }
  }
}

// grad[i] = sum_b partials[b][i], in block order.
__global__ void ff_reduce_kernel(const float* __restrict__ partials, float* __restrict__ grad,
                                 int n_blocks, int npp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npp) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(long long)b * npp + i];
  grad[i] = s;
}

// ------------------------------------------------------------------------------------
// K8: tangent of out = (u, du/dxs) along the packed parameter tangent dparams.  2 np
// column panels: s panels (a, pre_j) then ds panels (dz, dpre_j) of the current layer,
// stored raw; the layer inputs are s = (a, sp pre_j), ds = (sp dz, spp dz pre_j +
// sp dpre_j).  Each layer is two products into the same tile: W [s | ds], then
// dW [0 | s] (the zero half keeps one column layout).
__device__ __forceinline__ float ff_jvp_in(const float* A, int k, int m, bool tangent,
                                           int np, int T, int pt, int act) {
  const float* row = A + k * FF_LD;
  const float a = row[pt], sp = ff_dact(a, act);
  if (!tangent) return m == 0 ? a : sp * row[m * T + pt];
  const float dz = row[np * T + pt];
  if (m == 0) return sp * dz;
  return fmaf(ff_ddact(a, sp, act) * dz, row[m * T + pt], sp * row[(np + m) * T + pt]);
}

template <int NI>
__device__ __forceinline__ void ff_store_jvp(const float (&acc)[NI][4][4],
                                             const float* __restrict__ b,
                                             const float* __restrict__ db, float* Aout, int np,
                                             int T, int act) {
  const int tid = threadIdx.x, rg = tid / 16, c0 = (tid % 16) * 4;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 32 * i + 4 * rg + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + c, m2 = col / T;
        const float v = acc[i][r][c];
        float o = v;
        if (m2 >= 2 * np) o = 0.0f;
        else if (m2 == 0) o = ff_act(v + b[row], act);
        else if (m2 == np) o = v + db[row];
        Aout[row * FF_LD + col] = o;
      }
    }
}

template <int NI>
__global__ void ff_jvp_kernel(FfProblem pb, const float* __restrict__ params,
                              const float* __restrict__ dparams, float* __restrict__ dout) {
  extern __shared__ float4 ff_smem4[];
  constexpr int HP = 32 * NI;
  const int np = pb.np, T = pb.T, act = pb.act, fp = pb.bt ? pb.ke / 2 : 0;
  const FfSmem sm = ff_smem(reinterpret_cast<float*>(ff_smem4), HP, 2, pb, 0);
  ff_load_consts(pb, sm);
  const long long tile = blockIdx.x;
  ff_tile_setup(pb, sm, tile);
  float acc[NI][4][4];
  const float* prev = nullptr;
  for (int l = 0; l < pb.n_hidden; ++l) {
    float* out = sm.A + (l & 1) * HP * FF_LD;
    const int ow = l == 0 ? 0 : ff_off_w(HP, pb.ke, l);
    const int K = l == 0 ? pb.ke : HP;
    const float* in = prev;
    ff_zero<NI>(acc);
    // W [s | ds]
    ff_mm<NI, false>(acc, params + ow, K, sm.Ws, sm.In, [&](int k0, float* sIn) {
      for (int i = threadIdx.x; i < FF_KS * FF_C; i += FF_NT) {
        const int kk = i / FF_C, c = i % FF_C, m2 = c / T, pt = c % T;
        float v = 0.0f;
        if (l == 0) {
          if (m2 < np) v = ff_emb(sm, fp, k0 + kk, m2, pt);
        } else if (m2 < 2 * np) {
          v = ff_jvp_in(in, k0 + kk, m2 % np, m2 >= np, np, T, pt, act);
        }
        sIn[kk * FF_LD + c] = v;
      }
    });
    // + dW [0 | s]
    ff_mm<NI, false>(acc, dparams + ow, K, sm.Ws, sm.In, [&](int k0, float* sIn) {
      for (int i = threadIdx.x; i < FF_KS * FF_C; i += FF_NT) {
        const int kk = i / FF_C, c = i % FF_C, m2 = c / T, pt = c % T;
        float v = 0.0f;
        if (m2 >= np && m2 < 2 * np)
          v = l == 0 ? ff_emb(sm, fp, k0 + kk, m2 - np, pt)
                     : ff_jvp_in(in, k0 + kk, m2 - np, false, np, T, pt, act);
        sIn[kk * FF_LD + c] = v;
      }
    });
    ff_store_jvp<NI>(acc, params + ff_off_b(HP, pb.ke, l), dparams + ff_off_b(HP, pb.ke, l),
                     out, np, T, act);
    prev = out;
  }
  __syncthreads();
  const int ow = ff_off_wout(HP, pb.ke, pb.n_hidden);
  const float* wout = params + ow;
  const float* dwout = dparams + ow;
  const int tid = threadIdx.x;
  if (tid < np * T) {
    const int m = tid / T, pt = tid % T;
    const long long p = tile * T + pt;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = 0; k < HP; ++k) {
      s1 = fmaf(dwout[k], ff_jvp_in(prev, k, m, false, np, T, pt, act), s1);
      s2 = fmaf(wout[k], ff_jvp_in(prev, k, m, true, np, T, pt, act), s2);
    }
    if (p < pb.P) dout[m * pb.P + p] = m == 0 ? s1 + s2 + dwout[HP] : s1 + s2;
  }
}

// ---- host launchers ----------------------------------------------------------------

namespace {

const size_t kMaxSmem = 227 * 1024;  // a block's shared-memory limit on sm_90

enum Kind { kFwd, kBwd, kJvp };

int tab_floats(const FfProblem& pb) {
  return pb.flds ? (pb.nq * (2 + pb.d) + 3) / 4 * 4 : 0;
}

size_t smem_bytes(Kind kind, int hp, const FfProblem& pb) {
  const int nbuf = kind == kBwd ? pb.n_hidden + 1 : 2;
  return sizeof(float) * (size_t)ff_smem_floats(hp, nbuf, pb.ke, tab_floats(pb));
}

template <int NI>
const void* kernel_of(Kind kind) {
  switch (kind) {
    case kFwd: return (const void*)ff_fwd_kernel<NI>;
    case kJvp: return (const void*)ff_jvp_kernel<NI>;
    default: return (const void*)ff_bwd_kernel<NI>;
  }
}

template <int NI>
int prepare(Kind kind, const FfProblem& pb, size_t* smem) {
  *smem = smem_bytes(kind, 32 * NI, pb);
  if (*smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(kernel_of<NI>(kind),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

long long n_tiles(const FfProblem& pb) { return (pb.P + pb.T - 1) / pb.T; }

template <int NI>
int launch_pointwise(Kind kind, const FfProblem& pb, const float* params,
                     const float* dparams, float* out, cudaStream_t stream) {
  size_t smem = 0;
  int err = prepare<NI>(kind, pb, &smem);
  if (err) return err;
  const long long grid = n_tiles(pb);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (kind == kFwd)
    ff_fwd_kernel<NI><<<(unsigned)grid, FF_NT, smem, stream>>>(pb, params, out,
                                                              tab_floats(pb));
  else
    ff_jvp_kernel<NI><<<(unsigned)grid, FF_NT, smem, stream>>>(pb, params, dparams, out);
  return (int)cudaGetLastError();
}

// Blocks of the persistent backward: as many as are resident at once, or fewer when
// there are fewer tiles.
template <int NI>
int bwd_blocks(const FfProblem& pb, int* blocks) {
  size_t smem = 0;
  int err = prepare<NI>(kBwd, pb, &smem);
  if (err) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t cerr;
  if ((cerr = cudaGetDevice(&dev)) != cudaSuccess) return (int)cerr;
  if ((cerr = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)cerr;
  if ((cerr = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ff_bwd_kernel<NI>, FF_NT,
                                                            smem)) != cudaSuccess)
    return (int)cerr;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long b = (long long)per_sm * n_sm, t = n_tiles(pb);
  *blocks = (int)(b < t ? b : (t > 0 ? t : 1));
  return 0;
}

template <int NI>
int launch_bwd(const FfProblem& pb, const float* params, const float* g, float* partials,
               int n_blocks, float* grad, cudaStream_t stream) {
  int want = 0;
  int err = bwd_blocks<NI>(pb, &want);
  if (err) return err;
  if (n_blocks != want) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(kBwd, 32 * NI, pb);
  ff_bwd_kernel<NI><<<n_blocks, FF_NT, smem, stream>>>(pb, params, g, partials, n_tiles(pb),
                                                       tab_floats(pb));
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const int npp = ff_n_params(32 * NI, pb.ke, pb.n_hidden);
  ff_reduce_kernel<<<(npp + 127) / 128, 128, 0, stream>>>(partials, grad, n_blocks, npp);
  return (int)cudaGetLastError();
}

// K2-FF forward: the per-point contributions, then their q-sums per test function.
template <int NI>
int launch_res_fwd(const FfProblem& pb, const float* params, float* contrib, float* r,
                   cudaStream_t stream) {
  int err = launch_pointwise<NI>(kFwd, pb, params, nullptr, contrib, stream);
  if (err) return err;
  const int k = (int)(pb.P / pb.nq);
  ff_qsum_kernel<<<(k + 127) / 128, 128, 0, stream>>>(contrib, r, k, pb.nq);
  return (int)cudaGetLastError();
}

// Unit-mode (value + jacobian) problem; jvp doubles the column panels.
FfProblem vj_problem(const float* xs, const float* bt, long long P, int n_in, int ke,
                     int n_hidden, int act, bool jvp) {
  FfProblem pb = {};
  pb.xs = xs; pb.bt = bt; pb.P = P; pb.n_in = n_in; pb.np = 1 + n_in;
  pb.T = FF_C / (jvp ? 2 * pb.np : pb.np);
  pb.ke = ke; pb.n_hidden = n_hidden; pb.act = act;
  return pb;
}

FfProblem res_problem(const float* xs, const float* flds, const float* tab, const float* scale,
                      const float* bt, int k, int nq, int n_in, int d, int td, int has_react,
                      int ke, int n_hidden, int act) {
  FfProblem pb = {};
  pb.xs = xs; pb.bt = bt; pb.flds = flds; pb.tab = tab; pb.scale = scale;
  pb.P = (long long)k * nq; pb.n_in = n_in; pb.np = 2; pb.T = FF_C / 2;
  pb.ke = ke; pb.n_hidden = n_hidden; pb.act = act;
  pb.nq = nq; pb.d = d; pb.td = td; pb.has_react = has_react;
  return pb;
}

bool bad(long long P, int n_in, int ke, int n_hidden, int act) {
  return P < 0 || n_in < 1 || n_in > FF_MAX_IN || ke < 32 || ke > 256 || ke % 32 ||
         n_hidden < 1 || act < 0 || act > 1;
}

}  // namespace

#define FF_DISPATCH(hp, CALL)                          \
  switch (hp) {                                        \
    case 32: { constexpr int NI = 1; return CALL; }    \
    case 64: { constexpr int NI = 2; return CALL; }    \
    case 96: { constexpr int NI = 3; return CALL; }    \
    case 128: { constexpr int NI = 4; return CALL; }   \
    default: return (int)cudaErrorInvalidValue;        \
  }

extern "C" {

// Packed parameter count (floats): hidden width hp, embedding width ke, n_hidden layers.
int ff_n_params_c(int hp, int ke, int n_hidden) { return ff_n_params(hp, ke, n_hidden); }

// K7 forward: out [1 + n_in][P] = (u, du/dxs) at the scaled points xs [n_in][P].
// Returns a cudaError_t value.
int ff_vj_fwd(const float* xs, const float* bt, const float* params, float* out, long long P,
              int n_in, int ke, int n_hidden, int hp, int act, void* stream) {
  if (bad(P, n_in, ke, n_hidden, act)) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const FfProblem pb = vj_problem(xs, bt, P, n_in, ke, n_hidden, act, false);
  FF_DISPATCH(hp, launch_pointwise<NI>(kFwd, pb, params, nullptr, out, (cudaStream_t)stream))
}

// K8: dout [1 + n_in][P], the tangent of out along the packed parameter tangent dparams.
int ff_vj_jvp(const float* xs, const float* bt, const float* params, const float* dparams,
              float* dout, long long P, int n_in, int ke, int n_hidden, int hp, int act,
              void* stream) {
  if (bad(P, n_in, ke, n_hidden, act)) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const FfProblem pb = vj_problem(xs, bt, P, n_in, ke, n_hidden, act, true);
  FF_DISPATCH(hp, launch_pointwise<NI>(kJvp, pb, params, dparams, dout, (cudaStream_t)stream))
}

// Number of K7 backward blocks (rows of the partials buffer) on the current device.
int ff_vj_bwd_blocks(long long P, int n_in, int ke, int n_hidden, int hp, int* blocks) {
  if (bad(P, n_in, ke, n_hidden, 0)) return (int)cudaErrorInvalidValue;
  const FfProblem pb = vj_problem(nullptr, nullptr, P, n_in, ke, n_hidden, 0, false);
  FF_DISPATCH(hp, bwd_blocks<NI>(pb, blocks))
}

// K7 backward: packed gradient grad of <g, out> for the cotangent g [1 + n_in][P];
// partials is workspace of n_blocks * n_params floats.
int ff_vj_bwd(const float* xs, const float* bt, const float* params, const float* g,
              float* partials, int n_blocks, float* grad, long long P, int n_in, int ke,
              int n_hidden, int hp, int act, void* stream) {
  if (bad(P, n_in, ke, n_hidden, act)) return (int)cudaErrorInvalidValue;
  const FfProblem pb = vj_problem(xs, bt, P, n_in, ke, n_hidden, act, false);
  FF_DISPATCH(hp, launch_bwd<NI>(pb, params, g, partials, n_blocks, grad,
                                 (cudaStream_t)stream))
}

// K2-FF forward: r [k] of the directional weak form; contrib is workspace of k * nq floats.
int ff_res_fwd(const float* xs, const float* flds, const float* tab, const float* scale,
               const float* bt, const float* params, float* contrib, float* r, int k, int nq,
               int n_in, int d, int td, int has_react, int ke, int n_hidden, int hp, int act,
               void* stream) {
  if (bad((long long)k * nq, n_in, ke, n_hidden, act) || nq < 1)
    return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  const FfProblem pb = res_problem(xs, flds, tab, scale, bt, k, nq, n_in, d, td, has_react,
                                   ke, n_hidden, act);
  FF_DISPATCH(hp, launch_res_fwd<NI>(pb, params, contrib, r, (cudaStream_t)stream))
}

// Number of K2-FF backward blocks on the current device.
int ff_res_bwd_blocks(int k, int nq, int d, int ke, int n_hidden, int hp, int* blocks) {
  if (bad((long long)k * nq, 1, ke, n_hidden, 0)) return (int)cudaErrorInvalidValue;
  const FfProblem pb = res_problem(nullptr, nullptr, nullptr, nullptr, nullptr, k, nq, 1, d, 0,
                                   0, ke, n_hidden, 0);
  FF_DISPATCH(hp, bwd_blocks<NI>(pb, blocks))
}

// K2-FF backward: packed gradient grad for the cotangent gr [k] of r.
int ff_res_bwd(const float* xs, const float* flds, const float* tab, const float* scale,
               const float* bt, const float* params, const float* gr, float* partials,
               int n_blocks, float* grad, int k, int nq, int n_in, int d, int td, int has_react,
               int ke, int n_hidden, int hp, int act, void* stream) {
  if (bad((long long)k * nq, n_in, ke, n_hidden, act) || nq < 1)
    return (int)cudaErrorInvalidValue;
  const FfProblem pb = res_problem(xs, flds, tab, scale, bt, k, nq, n_in, d, td, has_react, ke,
                                   n_hidden, act);
  FF_DISPATCH(hp, launch_bwd<NI>(pb, params, gr, partials, n_blocks, grad,
                                 (cudaStream_t)stream))
}

}  // extern "C"
