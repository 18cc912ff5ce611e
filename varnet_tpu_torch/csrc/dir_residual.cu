// Directional fused weak-residual kernels for Hopper (sm_90a), f32 on the CUDA cores.
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
// What bounds it: f32 FMA throughput on the CUDA cores.  At width (20, 20) forward plus
// backward is about 10 kFLOP per quadrature point against about 28 bytes read
// (3 coordinates + 4 field values), so the kernel sits far above the memory roofline.
// The design answers that by keeping every intermediate on chip: weights and the
// gradient accumulator live in shared memory; each thread owns one quadrature point
// and keeps its per-layer state (activation and tangent pre-activation, later that
// layer's cotangents in the same slots) in its own shared-memory column; the q-sum of
// the forward and the point-sum of the backward are reduced inside the block, the
// latter as register-tiled outer products (2 FMAs per shared-memory load, not 0.5).
// Nothing but r (forward) and one gradient partial per block (backward) is written to
// device memory.
//
// Precoeff mode (K4) reads c, csrc and cu per point from device memory instead of
// forming them from the field rows and the shared [nq] table: the host folded the test
// tables (shared [nq] or per-node [K, nq]: order-2 test spaces, refined hats), the input
// scale and, for exact BC/IC, the affine ansatz u = A + B n into them
// (ops/fused_residual.py::prepare_residual_coeffs).  Only the point reader (vr_point)
// differs; the forward and backward bodies are K1's.  It reads 2 n_in + 1 floats per
// point (+ 1 for cu) against n_in + 2 + d (+ 1 for reaction) in table mode, still far
// below the FMA work per point, so K4 is bound by operations like K1.
//
// The backward's block size is the one that keeps the most threads resident per SM
// (occupancy calculator), since its per-point state grows with depth and width.
//
// TPU -> Hopper translation.  The TPU grid runs in order and sums dW across grid steps
// in place; here blocks run in no order, so the backward is persistent (each block
// walks a fixed, strided set of point tiles and accumulates its own partial) and a
// second kernel sums the partials in block order.  No atomics: the gradients are
// bit-reproducible for a given card.  The TPU's q-major lane layout, G-blocking with
// block-diagonal weights and VMEM tile pickers only fed the 128-row MXU and are gone:
// points are [rows, P] (P = K * nq, point p = k * nq + q), so loads are coalesced.
//
// Hidden widths are zero-padded to HP (a multiple of 8, at most 64): padded units carry
// zero weights and biases, contribute exactly nothing, and get gradients that the
// wrapper discards.  Packed parameter layout (floats, all offsets multiples of 4):
//   W0 [HP][4] (n_in padded to 4) | b0 [HP] | (W_l [HP][HP] | b_l [HP]) for l = 1..Lh-1
//   | w_out [HP] | b_out | pad to 4.      (W stored [fan_out][fan_in], i.e. w.T)
// The gradient uses the same layout.  varnet_tpu_torch/ops/fused_residual.py mirrors it.

#include <cuda_runtime.h>
#include <math.h>

#define VR_MAX_IN 4
#define VR_MAX_SPLIT 8  // point chunks per tile in vr_block_outer

__host__ __device__ inline int vr_off_w(int hp, int l) {  // l >= 1
  return 5 * hp + (l - 1) * (hp * hp + hp);
}
__host__ __device__ inline int vr_off_b(int hp, int l) {
  return l == 0 ? 4 * hp : vr_off_w(hp, l) + hp * hp;
}
__host__ __device__ inline int vr_off_wout(int hp, int n_hidden) {
  return 5 * hp + (n_hidden - 1) * (hp * hp + hp);
}
__host__ __device__ inline int vr_n_params(int hp, int n_hidden) {
  return (vr_off_wout(hp, n_hidden) + hp + 1 + 3) / 4 * 4;
}

// act: 0 = tanh, 1 = sigmoid.  Derivatives are functions of the output a.
__device__ __forceinline__ float vr_act(float z, int act) {
  return act == 0 ? tanhf(z) : 1.0f / (1.0f + expf(-z));
}
__device__ __forceinline__ float vr_dact(float a, int act) {
  return act == 0 ? 1.0f - a * a : a * (1.0f - a);
}
__device__ __forceinline__ float vr_ddact(float a, float sp, int act) {
  return act == 0 ? -2.0f * a * sp : (1.0f - 2.0f * a) * sp;
}

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

// Cooperative load of the packed parameters, the quadrature table and the input scale.
__device__ __forceinline__ void vr_load_consts(const VrProblem& pb, const float* params,
                                               int npp, float* sW, float* sTab,
                                               float* sScale) {
  for (int i = threadIdx.x; i < npp; i += blockDim.x) sW[i] = params[i];
  if (pb.pre) return;
  const int ntab = pb.nq * (2 + pb.d);
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) sTab[i] = pb.tab[i];
  if (threadIdx.x < VR_MAX_IN)
    sScale[threadIdx.x] = threadIdx.x < pb.n_in ? pb.scale[threadIdx.x] : 0.0f;
}

// Scaled coordinates x, direction c and the u / source coefficients of point p: read
// (precoeff mode) or formed from the fields and the table (the math of _dir_coeffs).
// Invalid points (p >= P) get all zeros.
__device__ __forceinline__ void vr_point(const VrProblem& pb, const float* sTab,
                                         const float* sScale, long long p, bool valid,
                                         float x[VR_MAX_IN], float c[VR_MAX_IN],
                                         float& cu, float& csrc) {
#pragma unroll
  for (int j = 0; j < VR_MAX_IN; ++j) { x[j] = 0.0f; c[j] = 0.0f; }
  cu = 0.0f;
  csrc = 0.0f;
  if (!valid) return;
  if (pb.pre) {
#pragma unroll
    for (int j = 0; j < VR_MAX_IN; ++j) {
      if (j < pb.n_in) {
        x[j] = pb.xs[j * pb.P + p];
        c[j] = pb.cdir[j * pb.P + p];
      }
    }
    csrc = pb.csrc[p];
    if (pb.has_react) cu = pb.cu[p];
    return;
  }
  const int q = (int)(p % pb.nq);
  const float* row = sTab + q * (2 + pb.d);
  const float n_q = row[0], w_q = row[1];
  const float kappa = pb.flds[p];
#pragma unroll
  for (int j = 0; j < VR_MAX_IN; ++j) {
    if (j < pb.n_in) x[j] = pb.xs[j * pb.P + p];
    if (j < pb.d) {
      const float vel = pb.flds[(1 + j) * pb.P + p];
      c[j] = w_q * sScale[j] * (vel * n_q + kappa * row[2 + j]);
    } else if (j == pb.d && pb.td) {
      c[j] = w_q * sScale[j] * n_q;
    }
  }
  csrc = -w_q * n_q * pb.flds[(1 + pb.d) * pb.P + p];
  if (pb.has_react) cu = w_q * n_q * pb.flds[(2 + pb.d) * pb.P + p];
}

// Hidden layers of the 2-panel forward for this thread's point.  Layer l's activation
// a and tangent PRE-activation pre (the tangent is act'(a) * pre) go to the thread's
// column of sA / sP at offset l * layer_stride (row stride ld); layer_stride = 0 reuses
// one buffer.
template <int HP>
__device__ __forceinline__ void vr_hidden_forward(const float* sW, int n_hidden, int act,
                                                  const float x[VR_MAX_IN],
                                                  const float c[VR_MAX_IN], float* sA,
                                                  float* sP, int ld, int layer_stride) {
  const int tid = threadIdx.x;
  const float* b0 = sW + vr_off_b(HP, 0);
  for (int j = 0; j < HP; ++j) {
    const float* w0 = sW + 4 * j;
    float z = b0[j], pre = 0.0f;
#pragma unroll
    for (int i = 0; i < VR_MAX_IN; ++i) {
      z = fmaf(w0[i], x[i], z);
      pre = fmaf(w0[i], c[i], pre);
    }
    sA[j * ld + tid] = vr_act(z, act);
    sP[j * ld + tid] = pre;
  }
  for (int l = 1; l < n_hidden; ++l) {
    const float* aIn = sA + (l - 1) * layer_stride;
    const float* pIn = sP + (l - 1) * layer_stride;
    float av[HP], tv[HP];
#pragma unroll
    for (int i = 0; i < HP; ++i) {
      const float a = aIn[i * ld + tid];
      av[i] = a;
      tv[i] = vr_dact(a, act) * pIn[i * ld + tid];
    }
    const float* W = sW + vr_off_w(HP, l);
    const float* b = sW + vr_off_b(HP, l);
    float* aOut = sA + l * layer_stride;
    float* pOut = sP + l * layer_stride;
    for (int j = 0; j < HP; ++j) {
      const float4* wr = reinterpret_cast<const float4*>(W + j * HP);
      float z0 = b[j], z1 = 0.0f, p0 = 0.0f, p1 = 0.0f;
#pragma unroll
      for (int i4 = 0; i4 < HP / 4; ++i4) {
        const float4 w = wr[i4];
        z0 = fmaf(w.x, av[4 * i4 + 0], z0);
        p0 = fmaf(w.x, tv[4 * i4 + 0], p0);
        z1 = fmaf(w.y, av[4 * i4 + 1], z1);
        p1 = fmaf(w.y, tv[4 * i4 + 1], p1);
        z0 = fmaf(w.z, av[4 * i4 + 2], z0);
        p0 = fmaf(w.z, tv[4 * i4 + 2], p0);
        z1 = fmaf(w.w, av[4 * i4 + 3], z1);
        p1 = fmaf(w.w, tv[4 * i4 + 3], p1);
      }
      aOut[j * ld + tid] = vr_act(z0 + z1, act);
      pOut[j * ld + tid] = p0 + p1;
    }
  }
}

// ------------------------------------------------------------------------------------
// Forward: one thread per quadrature point, kpb = blockDim.x / nq whole test functions
// per block; the q-sum is reduced in shared memory in a fixed order.
template <int HP>
__global__ void vr_fwd_kernel(VrProblem pb, const float* __restrict__ params,
                              float* __restrict__ r) {
  extern __shared__ float4 vr_smem4[];
  float* smem = reinterpret_cast<float*>(vr_smem4);
  const int T = blockDim.x, tid = threadIdx.x;
  const int npp = vr_n_params(HP, pb.n_hidden);
  float* sW = smem;
  float* sTab = sW + npp;
  float* sScale = sTab + vr_tab_floats(pb);
  float* sA = sScale + VR_MAX_IN;
  float* sP = sA + HP * T;
  float* sRed = sP + HP * T;
  vr_load_consts(pb, params, npp, sW, sTab, sScale);
  __syncthreads();

  const int kpb = T / pb.nq;
  const long long k = (long long)blockIdx.x * kpb + tid / pb.nq;
  const long long p = k * pb.nq + tid % pb.nq;
  const bool valid = k < pb.k;
  float x[VR_MAX_IN], c[VR_MAX_IN], cu, csrc;
  vr_point(pb, sTab, sScale, p, valid, x, c, cu, csrc);
  vr_hidden_forward<HP>(sW, pb.n_hidden, pb.act, x, c, sA, sP, T, 0);

  const float* wout = sW + vr_off_wout(HP, pb.n_hidden);
  float u0 = wout[HP], u1 = 0.0f, dd0 = 0.0f, dd1 = 0.0f;
#pragma unroll
  for (int i = 0; i < HP; i += 2) {
    const float a0 = sA[i * T + tid], a1 = sA[(i + 1) * T + tid];
    const float t0 = vr_dact(a0, pb.act) * sP[i * T + tid];
    const float t1 = vr_dact(a1, pb.act) * sP[(i + 1) * T + tid];
    u0 = fmaf(wout[i], a0, u0);
    u1 = fmaf(wout[i + 1], a1, u1);
    dd0 = fmaf(wout[i], t0, dd0);
    dd1 = fmaf(wout[i + 1], t1, dd1);
  }
  float contrib = (dd0 + dd1) + csrc;
  if (pb.has_react) contrib = fmaf(cu, u0 + u1, contrib);
  sRed[tid] = valid ? contrib : 0.0f;
  __syncthreads();
  if (valid && tid % pb.nq == 0) {
    float s = 0.0f;
    for (int q = 0; q < pb.nq; ++q) s += sRed[tid + q];
    r[k] = s;
  }
}

// ------------------------------------------------------------------------------------
// Backward helpers.

// Block-cooperative outer-product reduction over the block's T points:
//   sG[off_w + i * Cpack + m] += sum_j GZ[i][j] inA[m][j] + GP[i][j] t[m][j]
//   sG[off_b + i]             += sum_j GZ[i][j]
// for rows i < R, columns m < C (multiples of 4; R = 1 for the output row), where
// t = act'(inA) * inT when inT holds tangent PRE-activations (from_pre), else inT.
// Each thread owns an RT x 4 register tile of outputs over one of S contiguous point
// chunks, so each value loaded from shared memory feeds up to 4 FMAs; the chunks'
// partial tiles are added to sG one chunk after another.  The order of every
// sum is fixed: the result is deterministic.  Ends with __syncthreads().
template <int RT>
__device__ __forceinline__ void vr_block_outer(float* sG, int R, int C, int Cpack,
                                               const float* GZ, const float* GP,
                                               const float* inA, const float* inT,
                                               bool from_pre, int act, int ld, int T,
                                               int off_w, int off_b) {
  const int n_col = C / 4;
  const int n_tiles = (R / RT) * n_col;
  int S = T / n_tiles;
  S = S < 1 ? 1 : (S > VR_MAX_SPLIT ? VR_MAX_SPLIT : S);
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
        float a[4], t[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          a[c] = inA[(m0 + c) * ld + j];
          const float p = inT[(m0 + c) * ld + j];
          t[c] = from_pre ? vr_dact(a[c], act) * p : p;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float gz = GZ[(i0 + r) * ld + j], gp = GP[(i0 + r) * ld + j];
          bias[r] += gz;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(gz, a[c], fmaf(gp, t[c], acc[r][c]));
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
// points each, accumulating its parameter-gradient partial in shared memory, and
// writes the partial to partials[b] once.  Per point, shared memory holds each hidden
// layer's activation a and tangent pre-activation pre; going down the layers, the
// same slots are overwritten with that layer's cotangents (gz, gp), and then with the
// cotangents (ga, gj) passed to the layer below.
template <int HP>
__global__ void vr_bwd_kernel(VrProblem pb, const float* __restrict__ params,
                              const float* __restrict__ gr, float* __restrict__ partials,
                              long long n_tiles) {
  extern __shared__ float4 vr_smem4[];
  float* smem = reinterpret_cast<float*>(vr_smem4);
  const int T = blockDim.x, tid = threadIdx.x, ld = T + 1;
  const int Lh = pb.n_hidden, act = pb.act;
  const int npp = vr_n_params(HP, Lh);
  float* sW = smem;
  float* sG = sW + npp;
  float* sTab = sG + npp;
  float* sScale = sTab + vr_tab_floats(pb);
  float* sA = sScale + VR_MAX_IN;    // [Lh][HP][ld] a, then gz, then ga of the layer below
  float* sP = sA + Lh * HP * ld;     // [Lh][HP][ld] pre, then gp, then gj of the layer below
  float* sO = sP + Lh * HP * ld;     // [2][ld] output-row cotangents (value, tangent)
  float* sX = sO + 2 * ld;           // [4][ld] scaled coordinates
  float* sC = sX + VR_MAX_IN * ld;   // [4][ld] directions
  const int lstride = HP * ld;
  vr_load_consts(pb, params, npp, sW, sTab, sScale);
  for (int i = tid; i < npp; i += T) sG[i] = 0.0f;
  __syncthreads();

  const int off_wout = vr_off_wout(HP, Lh);
  const float* wout = sW + off_wout;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p = tile * T + tid;
    const bool valid = p < pb.P;
    float x[VR_MAX_IN], c[VR_MAX_IN], cu, csrc;
    vr_point(pb, sTab, sScale, p, valid, x, c, cu, csrc);
#pragma unroll
    for (int j = 0; j < VR_MAX_IN; ++j) {
      sX[j * ld + tid] = x[j];
      sC[j * ld + tid] = c[j];
    }
    const float g_tan = valid ? gr[p / pb.nq] : 0.0f;
    const float g_val = pb.has_react ? g_tan * cu : 0.0f;
    vr_hidden_forward<HP>(sW, Lh, act, x, c, sA, sP, ld, lstride);
    sO[tid] = g_val;
    sO[ld + tid] = g_tan;
    __syncthreads();
    vr_block_outer<1>(sG, 1, HP, HP, sO, sO + ld, sA + (Lh - 1) * lstride,
                      sP + (Lh - 1) * lstride, true, act, ld, T, off_wout, off_wout + HP);

    for (int l = Lh - 1; l >= 0; --l) {
      float* aL = sA + l * lstride;
      float* pL = sP + l * lstride;
      // pre-activation cotangents gz, gp of layer l, over a_l / pre_l (own column)
      for (int i = 0; i < HP; ++i) {
        const float a = aL[i * ld + tid], pre = pL[i * ld + tid];
        const float sp = vr_dact(a, act);
        const float spp = vr_ddact(a, sp, act);
        const float ga = l == Lh - 1 ? wout[i] * g_val : aL[lstride + i * ld + tid];
        const float gj = l == Lh - 1 ? wout[i] * g_tan : pL[lstride + i * ld + tid];
        aL[i * ld + tid] = sp * ga + spp * (gj * pre);
        pL[i * ld + tid] = sp * gj;
      }
      __syncthreads();
      if (l > 0)
        vr_block_outer<4>(sG, HP, HP, HP, aL, pL, sA + (l - 1) * lstride,
                          sP + (l - 1) * lstride, true, act, ld, T, vr_off_w(HP, l),
                          vr_off_b(HP, l));
      else
        vr_block_outer<4>(sG, HP, VR_MAX_IN, VR_MAX_IN, aL, pL, sX, sC, false, act, ld, T,
                          0, vr_off_b(HP, 0));
      if (l > 0) {
        // cotangents of the layer below, W_l^T gz and W_l^T gp, over layer l's column
        float gz[HP], gp[HP];
#pragma unroll
        for (int i = 0; i < HP; ++i) {
          gz[i] = aL[i * ld + tid];
          gp[i] = pL[i * ld + tid];
        }
        const float* W = sW + vr_off_w(HP, l);
        for (int m = 0; m < HP; ++m) {
          float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
          for (int i = 0; i < HP; ++i) {
            const float w = W[i * HP + m];
            s0 = fmaf(w, gz[i], s0);
            s1 = fmaf(w, gp[i], s1);
          }
          aL[m * ld + tid] = s0;
          pL[m * ld + tid] = s1;
        }
      }
    }
  }
  for (int i = tid; i < npp; i += T) partials[(long long)blockIdx.x * npp + i] = sG[i];
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

const int kFwdTargetThreads = 256;
const int kBwdThreadChoices[] = {256, 224, 192, 160, 128, 96, 64, 32};
const size_t kMaxSmem = 227 * 1024;  // a block's shared-memory limit on sm_90

size_t consts_floats(int hp, const VrProblem& pb) {
  return (size_t)vr_n_params(hp, pb.n_hidden) + vr_tab_floats(pb) + VR_MAX_IN;
}

size_t fwd_smem(int hp, const VrProblem& pb, int T) {
  return sizeof(float) * (consts_floats(hp, pb) + 2 * (size_t)hp * T + T);
}

size_t bwd_smem(int hp, const VrProblem& pb, int T) {
  const size_t per_point = 2 * (size_t)pb.n_hidden * hp + 2 + 2 * VR_MAX_IN;
  return sizeof(float) * (consts_floats(hp, pb) + vr_n_params(hp, pb.n_hidden) +
                          per_point * (T + 1));
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

template <int HP>
int launch_fwd(const VrProblem& pb, const float* params, float* r, cudaStream_t stream) {
  const int kpb = pb.nq >= kFwdTargetThreads ? 1 : kFwdTargetThreads / pb.nq;
  const int T = kpb * pb.nq;
  if (T > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = fwd_smem(HP, pb, T);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(vr_fwd_kernel<HP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (pb.k + kpb - 1) / kpb;
  vr_fwd_kernel<HP><<<grid, T, smem, stream>>>(pb, params, r);
  return (int)cudaGetLastError();
}

// Threads per block and grid of the persistent backward: the block size that keeps the
// most threads resident per SM (shared memory and registers, from the occupancy
// calculator), one wave of blocks, or fewer when there are fewer tiles.
template <int HP>
int bwd_config(const VrProblem& pb, int* threads, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(vr_bwd_kernel<HP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  int best_T = 0, best_per_sm = 0;
  for (int T : kBwdThreadChoices) {
    const size_t smem = bwd_smem(HP, pb, T);
    if (smem > kMaxSmem) continue;
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vr_bwd_kernel<HP>, T,
                                                             smem)) != cudaSuccess)
      return (int)err;
    if (per_sm * T > best_per_sm * best_T) {
      best_T = T;
      best_per_sm = per_sm;
    }
  }
  if (best_T == 0) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = (pb.P + best_T - 1) / best_T;
  const long long b = (long long)best_per_sm * n_sm;
  *threads = best_T;
  *blocks = (int)(b < n_tiles ? b : n_tiles);
  return 0;
}

template <int HP>
int launch_bwd(const VrProblem& pb, const float* params, const float* gr, float* partials,
               int n_blocks, float* grad, cudaStream_t stream) {
  int T = 0, want = 0;
  int err = bwd_config<HP>(pb, &T, &want);
  if (err) return err;
  if (n_blocks != want) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(HP, pb, T);
  const long long n_tiles = (pb.P + T - 1) / T;
  vr_bwd_kernel<HP><<<n_blocks, T, smem, stream>>>(pb, params, gr, partials, n_tiles);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const int npp = vr_n_params(HP, pb.n_hidden);
  vr_reduce_kernel<<<(npp + 127) / 128, 128, 0, stream>>>(partials, grad, n_blocks, npp);
  return (int)cudaGetLastError();
}

}  // namespace

#define VR_DISPATCH(hp, CALL)                                      \
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
int vr_dir_residual_n_params(int hp, int n_hidden) { return vr_n_params(hp, n_hidden); }

// Residual r [k] of the directional weak form.  Returns a cudaError_t value.
int vr_dir_residual_fwd(const float* xs, const float* flds, const float* tab,
                        const float* scale, const float* params, float* r, int k, int nq,
                        int n_in, int d, int td, int has_react, int n_hidden, int hp,
                        int act, void* stream) {
  const VrProblem pb = make_problem(xs, flds, tab, scale, k, nq, n_in, d, td, has_react,
                                    n_hidden, act);
  VR_DISPATCH(hp, launch_fwd<HP>(pb, params, r, (cudaStream_t)stream))
}

// Number of backward blocks (rows of the partials buffer) for this problem on the
// current device.
int vr_dir_residual_bwd_blocks(int k, int nq, int d, int n_hidden, int hp, int* blocks) {
  const VrProblem pb = make_problem(nullptr, nullptr, nullptr, nullptr, k, nq, 0, d, 0, 0,
                                    n_hidden, 0);
  int threads = 0;
  VR_DISPATCH(hp, bwd_config<HP>(pb, &threads, blocks))
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
  VR_DISPATCH(hp, launch_bwd<HP>(pb, params, gr, partials, n_blocks, grad,
                                 (cudaStream_t)stream))
}

// K4, precoeff mode: r [k] from the precomputed xs, cdir [n_in][P], csrc [P] and cu [P]
// (read when has_cu; may be null otherwise).  Returns a cudaError_t value.
int vr_dirp_residual_fwd(const float* xs, const float* cdir, const float* csrc,
                         const float* cu, const float* params, float* r, int k, int nq,
                         int n_in, int has_cu, int n_hidden, int hp, int act, void* stream) {
  const VrProblem pb = make_pre_problem(xs, cdir, csrc, cu, k, nq, n_in, has_cu, n_hidden,
                                        act);
  VR_DISPATCH(hp, launch_fwd<HP>(pb, params, r, (cudaStream_t)stream))
}

// Number of K4 backward blocks for this problem on the current device.
int vr_dirp_residual_bwd_blocks(int k, int nq, int n_hidden, int hp, int* blocks) {
  const VrProblem pb = make_pre_problem(nullptr, nullptr, nullptr, nullptr, k, nq, 0, 0,
                                        n_hidden, 0);
  int threads = 0;
  VR_DISPATCH(hp, bwd_config<HP>(pb, &threads, blocks))
}

// K4's packed parameter gradient grad [n_params] for the cotangent gr [k]; partials as
// in vr_dir_residual_bwd (n_blocks from vr_dirp_residual_bwd_blocks).
int vr_dirp_residual_bwd(const float* xs, const float* cdir, const float* csrc,
                         const float* cu, const float* params, const float* gr,
                         float* partials, int n_blocks, float* grad, int k, int nq, int n_in,
                         int has_cu, int n_hidden, int hp, int act, void* stream) {
  const VrProblem pb = make_pre_problem(xs, cdir, csrc, cu, k, nq, n_in, has_cu, n_hidden,
                                        act);
  VR_DISPATCH(hp, launch_bwd<HP>(pb, params, gr, partials, n_blocks, grad,
                                 (cudaStream_t)stream))
}

}  // extern "C"
