// 3xTF32 tensor-core tools for Hopper (sm_90a), and the stacked-panel layers built from
// them, shared by csrc/value_and_jac.cu (K5 forward / backward, K6),
// csrc/dir_residual.cu (K1/K4 forward / backward) and csrc/ff_mlp.cuh (K2-FF, K7, K8, K3
// and K4 for widths 65..256: the "ff" tools below); the launch shape of their warp-per-group
// forwards; and the per-test-function sum of every residual forward (vr_qsum_kernel).
//
// Stacked panels.  As the TPU kernels pack the value panel and the tangent panels into
// one [H, panels x T] operand for the MXU, a block here takes a tile of T points (a
// multiple of 16) and stacks its panels as the rows of one operand, row r = k T + t
// (panel k, point t; k = 0 the value a, k >= 1 a tangent J = act'(a) P), M = panels x T.
// Each hidden layer is then a few [M x H] x [H x H] products of mma.sync.m16n8k8 tf32
// tiles, one warp per 16-row tile for all H columns (its A fragments reused across them):
//   forward            Z = [a; J]_{l-1} W_l^T         (vj_forward_tile, vj_stack_layer)
//   cotangents         G_{l-1} = G_l W_l                              (vj_cotangent_rows)
//   weight gradient    dW_l += G_l^T [a; J]_{l-1}, depth the M rows   (vj_dw_tile,
//                                                                       vj_dw_rows)
//
// Precision: 3xTF32.  Each operand is split at fragment load, x_hi = cvt.rna.tf32(x),
// x_lo = cvt.rna.tf32(x - x_hi), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi is summed
// in f32: single TF32 keeps ~3 digits and misses the 1e-4 gates by 5-18x, 3xTF32 sits at
// f32's own distance from f64 (tests/test_torch_tf32_split.py).  The tensor core's own
// f32 sum truncates, so each k-step's products go to a fresh tile that is added to the
// running sum on the CUDA cores, rounding to nearest (vj_add).
//
// Shared memory.  Weights are kept once, in f32, at row stride kVjLd (an odd multiple of
// 4 floats, so the 8 rows x 4 columns of a fragment load hit 32 different banks; the
// transposed reads of G W and G^T S conflict two-way); slots of stacked rows use the
// same stride.
//
// Packed parameter layout (floats; ops/fused_residual.py::pack_params): hidden widths
// zero-padded to HP (a multiple of 8, at most 64), n_in padded to 4:
//   W0 [HP][4] | b0 [HP] | (W_l [HP][HP] | b_l [HP]) for l = 1..L-1 | w_out [HP] | b_out
//   | pad to 4.         (W stored [fan_out][fan_in], i.e. w.T)
// Gradients and parameter tangents use the same layout.  (csrc/ff_mlp.cuh keeps its own
// packed layout, W [fan_in][fan_out]; its tools below read weights through the same
// fragment loaders, whose lambdas name the layout.)

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define VJ_MAX_IN 4
// A launcher or block query's result where not even one block of the net fits in shared
// memory (csrc/ff_mlp.cu, and the backwards of csrc/dir_residual.cu and
// csrc/value_and_jac.cu): the net is too deep for its width.
#define VJ_DOES_NOT_FIT 1001

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

// act: 0 = tanh, 1 = sigmoid.  Derivatives are functions of the output a.  act 2 = sin
// (SIREN nets): act' = cos z and act'' = -a, where cos z is no function of a; the kernels
// of csrc/dir_residual.cu, csrc/value_and_jac.cu and csrc/ff_mlp.cuh take it as
// instantiations of their own (template flag SIN; vj_act_sp and the sin tools below,
// ff_mlp.cuh's own), so the tanh / sigmoid code is as it was.
#define VJ_ACT_SIN 2

__device__ __forceinline__ float vj_act(float z, int act) {
  return act == 0 ? tanhf(z) : 1.0f / (1.0f + expf(-z));
}
__device__ __forceinline__ float vj_dact(float a, int act) {
  return act == 0 ? 1.0f - a * a : a * (1.0f - a);
}
__device__ __forceinline__ float vj_ddact(float a, float sp, int act) {
  return act == 0 ? -2.0f * a * sp : (1.0f - 2.0f * a) * sp;
}
// act''/act' as a function of a: -2a (tanh) or 1 - 2a (sigmoid).  The slots keep
// J = act'(a) P, not the pre-activation P, and the backward's act'' term is
// spp P = (act''/act') J, so every product reads its operand straight from a slot.
__device__ __forceinline__ float vj_ddact_ratio(float a, int act) {
  return act == 0 ? -2.0f * a : 1.0f - 2.0f * a;
}

// a = act(z) and sp = act'(z).  sin by sincosf, with its full range reduction: SIREN's
// layer 0 puts |z| near omega0, where the __sinf / __cosf intrinsics lose digits.
template <bool SIN>
__device__ __forceinline__ void vj_act_sp(float z, int act, float& a, float& sp) {
  if constexpr (SIN) {
    sincosf(z, &a, &sp);
  } else {
    a = vj_act(z, act);
    sp = vj_dact(a, act);
  }
}

// ------------------------------------------------------------------------------------
// mma.sync.m16n8k8 tf32 on fragments split at load.
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

// t = a b, from a zero accumulator (no registers to clear).
__device__ __forceinline__ void vj_mma0(float t[4], const unsigned a[4], const unsigned b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// t += a b in 3xTF32, the small terms first; vj_mma3z: t = a b.
__device__ __forceinline__ void vj_mma3(float t[4], const unsigned ah[4], const unsigned al[4],
                                        const unsigned bh[2], const unsigned bl[2]) {
  vj_mma(t, al, bh);
  vj_mma(t, ah, bl);
  vj_mma(t, ah, bh);
}

__device__ __forceinline__ void vj_mma3z(float t[4], const unsigned ah[4], const unsigned al[4],
                                         const unsigned bh[2], const unsigned bl[2]) {
  vj_mma0(t, al, bh);
  vj_mma(t, ah, bl);
  vj_mma(t, ah, bh);
}

// The tensor core's f32 sum truncates; a running sum kept in its accumulator would take
// that truncation at every k-step, at the running sum's size (a deep sigmoid net's
// cancelling JVP row missed the 1e-4 gate by that).  So each k-step's products are summed
// in a fresh tile t (vj_mma3z) and added to the running sum c here, rounding to nearest.
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
      float t[4];
      vj_mma3z(t, ah, al, bh, bl);
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

// ------------------------------------------------------------------------------------
// Parameters and stacked layers in shared memory.

// Row stride (floats) of the weights and of the slots.
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

// One 16-row tile of the stacked forward: Z = A W_l^T on the tensor cores (A: 16 rows of
// layer l - 1's slot), stored to O as a = act(z + b) on a value tile; on a tangent tile as
// J = act'(a) z when V, the value tile of the same 16 points, is given (a warp that
// computed it itself), else as the pre-activation z.  O may be A: the tile's rows are all
// read before any is written.
template <int HP>
__device__ __forceinline__ void vj_forward_tile(const float* A, float* O, const float* W,
                                                const float* b, bool value, const float* V,
                                                int act) {
  constexpr int LD = kVjLd<HP>;
  float acc[HP / 8][4];
  vj_zero<HP>(acc);
  vj_rows_mma<HP>(
      acc, [&](int rr, int i) { return A[rr * LD + i]; },
      [&](int i, int j) { return W[j * LD + i]; });
  __syncwarp();
  if (value)
    vj_rows_store<HP>(acc, [&](int rr, int j, float v) { O[rr * LD + j] = vj_act(v + b[j], act); });
  else if (V)
    vj_rows_store<HP>(acc, [&](int rr, int j, float v) {
      O[rr * LD + j] = vj_dact(V[rr * LD + j], act) * v;
    });
  else
    vj_rows_store<HP>(acc, [&](int rr, int j, float v) { O[rr * LD + j] = v; });
}

// One hidden layer of the stacked forward over a tile of T points (rows k T + t), by the
// whole block: the 16-row tiles spread over the warps (vj_forward_tile, tangent tiles
// stored as z), then J = act'(a) z on the CUDA cores.  Ends with __syncthreads.
template <int HP>
__device__ __forceinline__ void vj_stack_layer(const float* Sin, float* Sout, const float* W,
                                               const float* b, int T, int panels, int act) {
  constexpr int LD = kVjLd<HP>;
  const int warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  for (int mt = warp; mt < panels * T / 16; mt += nwarp)
    vj_forward_tile<HP>(Sin + mt * 16 * LD, Sout + mt * 16 * LD, W, b, mt * 16 < T, nullptr,
                        act);
  __syncthreads();
  for (int u = threadIdx.x; u < T * HP; u += blockDim.x) {
    const int t = u / HP, i = u % HP;
    const float sp = vj_dact(Sout[t * LD + i], act);
    for (int k = 1; k < panels; ++k) Sout[(k * T + t) * LD + i] *= sp;
  }
  __syncthreads();
}

// ------------------------------------------------------------------------------------
// sin (act 2).  act' = cos z is no function of the output a, so neither of the forward
// tools above applies, and the backward's act'' term -a P needs the tangents'
// pre-activations P: where cos z vanishes, no function of (a, J = cos(z) P) gives it.

// One hidden layer of a warp's stacked forward over its group of 16 points, in place in
// its slot S [panels x 16][LD] (the value tile, then the tangent tiles): the value tile's
// z + b becomes a = sin, and cos stays in the lane's registers -- a lane holds the same
// (point, unit) entries of every tile of the group -- for each tangent tile's J = cos(z)
// z_k.  The tile's rows are all read before any is written (__syncwarp), and the next
// tile's loads read rows that no store of this tile touches.
template <int HP>
__device__ __forceinline__ void vj_forward_group_sin(float* S, int panels, const float* W,
                                                     const float* b) {
  constexpr int LD = kVjLd<HP>;
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  float cz[HP / 8][4];
  for (int k = 0; k < panels; ++k) {
    float* A = S + k * 16 * LD;
    float acc[HP / 8][4];
    vj_zero<HP>(acc);
    vj_rows_mma<HP>(
        acc, [&](int rr, int i) { return A[rr * LD + i]; },
        [&](int i, int j) { return W[j * LD + i]; });
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < HP / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int rr = gq + (h & 2 ? 8 : 0), j = nt * 8 + 2 * q + (h & 1);
        if (k == 0) {
          float s, c;
          sincosf(acc[nt][h] + b[j], &s, &c);
          cz[nt][h] = c;
          A[rr * LD + j] = s;
        } else {
          A[rr * LD + j] = cz[nt][h] * acc[nt][h];
        }
      }
  }
}

// The backward's stacked forward of one hidden layer (vj_stack_layer) for sin.  A slot
// keeps [a; P] -- the tangent panels' pre-activations -- and cos z in rows C [T][LD] of
// its own; the product's tangent operand J_{l-1} = C_{l-1} P_{l-1} is formed as its
// fragments load.  The value tile stores a = sin(z + b) and C_l = cos(z + b), a tangent
// tile its product P_l as it is.  T is a power of two (16, 32 or 64).  Ends with
// __syncthreads.
template <int HP>
__device__ __forceinline__ void vj_stack_layer_sin(const float* Sin, const float* Cin,
                                                   float* Sout, float* Cout, const float* W,
                                                   const float* b, int T, int panels) {
  constexpr int LD = kVjLd<HP>;
  const int warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const auto lw = [&](int i, int j) { return W[j * LD + i]; };
  for (int mt = warp; mt < panels * T / 16; mt += nwarp) {
    const int r0 = mt * 16;
    const float* A = Sin + r0 * LD;
    float* O = Sout + r0 * LD;
    float acc[HP / 8][4];
    vj_zero<HP>(acc);
    if (r0 < T) {
      vj_rows_mma<HP>(acc, [&](int rr, int i) { return A[rr * LD + i]; }, lw);
      float* CO = Cout + r0 * LD;
      vj_rows_store<HP>(acc, [&](int rr, int j, float v) {
        float s, c;
        sincosf(v + b[j], &s, &c);
        O[rr * LD + j] = s;
        CO[rr * LD + j] = c;
      });
    } else {
      const float* C = Cin + (r0 & (T - 1)) * LD;
      vj_rows_mma<HP>(acc, [&](int rr, int i) { return C[rr * LD + i] * A[rr * LD + i]; },
                      lw);
      vj_rows_store<HP>(acc, [&](int rr, int j, float v) { O[rr * LD + j] = v; });
    }
  }
  __syncthreads();
}

// G_{l-1} = G_l W_l over the `rows` stacked rows of slot Sl, in place: each warp reads all
// of its 16 rows before it writes them.  Ends with __syncthreads.
template <int HP>
__device__ __forceinline__ void vj_cotangent_rows(float* Sl, const float* W, int rows) {
  constexpr int LD = kVjLd<HP>;
  const int warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  for (int mt = warp; mt < rows / 16; mt += nwarp) {
    const int r0 = mt * 16;
    float acc[HP / 8][4];
    vj_zero<HP>(acc);
    vj_rows_mma<HP>(
        acc, [&](int rr, int j) { return Sl[(r0 + rr) * LD + j]; },
        [&](int j, int i) { return W[j * LD + i]; });
    __syncwarp();
    vj_rows_store<HP>(acc, [&](int rr, int i, float v) { Sl[(r0 + rr) * LD + i] = v; });
  }
  __syncthreads();
}

// acc[nt] (16 x 8 tile nt of a 16 x 8 NTU row block) = A^T B summed over `rows` stacked
// rows: A [rows][lda] read at columns i < 16 (columns i >= imax read as zero), B read as
// b(r, j), row r < rows, column j < 8 NTU (both pre-offset to the block's columns); each
// k-step's A fragment split once for all NTU column tiles.  ff_dw_rows: B [rows][ldb].
// ff_dw_rows_ab: A read as a(i, r) too (the sin backward of csrc/ff_mlp.cuh, whose slots
// keep z on their value rows, read as sin z).
template <int NTU, class LoadB>
__device__ __forceinline__ void ff_dw_rows_by(float (&acc)[NTU][4], const float* A, int lda,
                                              LoadB b, int rows, int imax = 16) {
#pragma unroll
  for (int nt = 0; nt < NTU; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll 2
  for (int r0 = 0; r0 < rows; r0 += 8) {
    unsigned ah[4], al[4];
    vj_frag_a([&](int i, int r) { return i < imax ? A[(r0 + r) * lda + i] : 0.0f; }, 0, ah,
              al);
#pragma unroll
    for (int nt = 0; nt < NTU; ++nt) {
      unsigned bh[2], bl[2];
      vj_frag_b([&](int r, int j) { return b(r0 + r, j); }, 0, nt * 8, bh, bl);
      float t[4];
      vj_mma3z(t, ah, al, bh, bl);
      vj_add(acc[nt], t);
    }
  }
}

template <int NTU, class LoadA, class LoadB>
__device__ __forceinline__ void ff_dw_rows_ab(float (&acc)[NTU][4], LoadA a, LoadB b, int rows) {
#pragma unroll
  for (int nt = 0; nt < NTU; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll 2
  for (int r0 = 0; r0 < rows; r0 += 8) {
    unsigned ah[4], al[4];
    vj_frag_a([&](int i, int r) { return a(i, r0 + r); }, 0, ah, al);
#pragma unroll
    for (int nt = 0; nt < NTU; ++nt) {
      unsigned bh[2], bl[2];
      vj_frag_b([&](int r, int j) { return b(r0 + r, j); }, 0, nt * 8, bh, bl);
      float t[4];
      vj_mma3z(t, ah, al, bh, bl);
      vj_add(acc[nt], t);
    }
  }
}

template <int NTU>
__device__ __forceinline__ void ff_dw_rows(float (&acc)[NTU][4], const float* A, int lda,
                                           const float* B, int ldb, int rows, int imax = 16) {
  ff_dw_rows_by<NTU>(acc, A, lda, [&](int r, int j) { return B[r * ldb + j]; }, rows, imax);
}

// acc[nt] = the 16 x 8 tiles (rows j0.., columns 8 nt..) of G^T Sp summed over the `rows`
// stacked rows of the slots G and Sp: a whole row block of dW_l.  Rows j >= HP read as
// zero.  vj_dw_rows_by: Sp read as sp(r, i) (the sin backward's [a; cos(z) P], formed as
// it loads).
template <int HP, class LoadS>
__device__ __forceinline__ void vj_dw_rows_by(float acc[HP / 8][4], const float* G, LoadS sp,
                                              int rows, int j0) {
  ff_dw_rows_by<HP / 8>(*reinterpret_cast<float(*)[HP / 8][4]>(acc), G + j0, kVjLd<HP>, sp,
                        rows, HP - j0);
}

template <int HP>
__device__ __forceinline__ void vj_dw_rows(float acc[HP / 8][4], const float* G, const float* Sp,
                                           int rows, int j0) {
  ff_dw_rows<HP / 8>(*reinterpret_cast<float(*)[HP / 8][4]>(acc), G + j0, kVjLd<HP>, Sp,
                     kVjLd<HP>, rows, HP - j0);
}

// acc = the 16 x 8 tile (rows j0.., columns i0..) of G^T Sp summed over the `rows` stacked
// rows of the slots G (the cotangents [gz; gp]_l) and Sp ([a; J]_{l-1}), read as sp(r, i):
// the dW_l tile of one warp unit.  Rows j >= HP (HP not a multiple of 16) read as zero.
template <int HP, class LoadS>
__device__ __forceinline__ void vj_dw_tile_by(float acc[4], const float* G, LoadS sp, int rows,
                                              int j0, int i0) {
  constexpr int LD = kVjLd<HP>;
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
  // the k-steps' fresh tiles are independent: unrolled, their loads and mma overlap (one
  // warp's unit is otherwise one chain of dependent mma)
#pragma unroll 2
  for (int r0 = 0; r0 < rows; r0 += 8) {
    unsigned ah[4], al[4], bh[2], bl[2];
    vj_frag_a(
        [&](int jj, int r) { return j0 + jj < HP ? G[(r0 + r) * LD + j0 + jj] : 0.0f; }, 0,
        ah, al);
    vj_frag_b([&](int r, int i) { return sp(r0 + r, i); }, 0, i0, bh, bl);
    float t[4];
    vj_mma3z(t, ah, al, bh, bl);
    vj_add(acc, t);
  }
}

template <int HP>
__device__ __forceinline__ void vj_dw_tile(float acc[4], const float* G, const float* Sp,
                                           int rows, int j0, int i0) {
  vj_dw_tile_by<HP>(acc, G, [&](int r, int i) { return Sp[r * kVjLd<HP> + i]; }, rows, j0, i0);
}

// Stacked row r, column i of a sin slot's operand [a; C P] (rows t, then k T + t; T a
// power of two): a value row below T, else the tangent C[r mod T] P[r].
template <int HP>
__device__ __forceinline__ float vj_sin_operand(const float* S, const float* C, int T, int r,
                                                int i) {
  constexpr int LD = kVjLd<HP>;
  const float v = S[r * LD + i];
  return r < T ? v : C[(r & (T - 1)) * LD + i] * v;
}

// ------------------------------------------------------------------------------------
// The "ff" tools (csrc/ff_mlp.cuh): hidden widths HP = 32..256 and layer-0 depths up to 256,
// so the weights do not stay in shared memory: they stream through it in K-slices of
// FF_SLICE rows (cp.async, double-buffered), and a warp takes 2 x 16 stacked rows of the
// tile for its share of the HP / 8 output tiles (its A fragments split once for them,
// each B fragment once for both 16-row tiles).  The dW row blocks are ff_dw_rows, above.

#define FF_SLICE 16            // weight rows (the product's k) per streamed K-slice
#define FF_ELD (FF_SLICE + 4)  // row stride of an embedding slice and of a transposed slice

__device__ __forceinline__ void ff_cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void ff_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void ff_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// acc[mt][nt] (16 x 8 tile nt of 16-row tile mt) += sum over the FF_SLICE / 8 k-steps of a
// slice of A [32 x FF_SLICE] B [FF_SLICE x 8 NTH]: a(r, k), r < 32; b(k, n), n < 8 NTH.
// Each k-step's three products go to a fresh tile (vj_mma3z) added on the CUDA cores.
template <int NTH, class LoadA, class LoadB>
__device__ __forceinline__ void ff_rows2_slice(float (&acc)[2][NTH][4], LoadA a, LoadB b) {
#pragma unroll
  for (int k0 = 0; k0 < FF_SLICE; k0 += 8) {
    unsigned ah[2][4], al[2][4];
    vj_frag_a(a, k0, ah[0], al[0]);
    vj_frag_a([&](int r, int k) { return a(16 + r, k); }, k0, ah[1], al[1]);
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
      unsigned bh[2], bl[2];
      vj_frag_b(b, k0, nt * 8, bh, bl);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float t[4];
        vj_mma3z(t, ah[mt], al[mt], bh, bl);
        vj_add(acc[mt][nt], t);
      }
    }
  }
}

// ------------------------------------------------------------------------------------
// r[k] = sum_q contrib[k nq + q], the second kernel of every residual forward (K1/K4 in
// csrc/dir_residual.cu; K2-FF, K3 and wide K4 in csrc/ff_mlp.cu): one warp per test
// function, lane l summing q = l, l + 32, ... in order, then a fixed shuffle tree (offsets
// 16, 8, 4, 2, 1).  Any nq >= 0; no atomics, so r is the same on every run.  (static: each
// source that includes this header launches its own copy.)
static __global__ void vr_qsum_kernel(const float* __restrict__ contrib, float* __restrict__ r,
                                      int k, int nq) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= k) return;  // the whole warp: w is the same on its 32 lanes
  const float* c = contrib + w * nq;
  float s = 0.0f;
  for (int q = lane; q < nq; q += 32) s += c[q];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) r[w] = s;
}

// Launches vr_qsum_kernel on r [k] from contrib [k nq].
static inline int vr_qsum(const float* contrib, float* r, int k, int nq, cudaStream_t stream) {
  if (k == 0) return 0;
  vr_qsum_kernel<<<(int)(((long long)k * 32 + 255) / 256), 256, 0, stream>>>(contrib, r, k, nq);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------------------
// Host: the instantiation of a call (csrc/dir_residual.cu, csrc/value_and_jac.cu): the
// statement `return CALL;` with HP the padded hidden width (8..64) and SIN whether act is
// sin, or cudaErrorInvalidValue for another width or activation.

#define VJ_CASE(W, S, ...) \
  case (S ? 1000 : 0) + W: { constexpr int HP = W; constexpr bool SIN = S; return __VA_ARGS__; }
#define VJ_CASES(S, ...)                                                                 \
  VJ_CASE(8, S, __VA_ARGS__) VJ_CASE(16, S, __VA_ARGS__) VJ_CASE(24, S, __VA_ARGS__)    \
  VJ_CASE(32, S, __VA_ARGS__) VJ_CASE(40, S, __VA_ARGS__) VJ_CASE(48, S, __VA_ARGS__)   \
  VJ_CASE(56, S, __VA_ARGS__) VJ_CASE(64, S, __VA_ARGS__)
#define VJ_DISPATCH(hp, act, ...)                                                        \
  switch ((act) < 0 || (act) > VJ_ACT_SIN ? 0 : ((act) == VJ_ACT_SIN ? 1000 : 0) + (hp)) { \
    VJ_CASES(false, __VA_ARGS__)                                                         \
    VJ_CASES(true, __VA_ARGS__)                                                          \
    default: return (int)cudaErrorInvalidValue;                                          \
  }

// ------------------------------------------------------------------------------------
// Host: launch shapes.

constexpr size_t kVjMaxSmem = 227 * 1024;  // a block's shared-memory limit on sm_90

inline int vj_sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// A persistent kernel of one warp per group of 16 points (K5's and K1/K4's forwards), fn,
// with smem(threads) bytes of shared memory per block: of 256, 128 and 64 threads the
// block that keeps the most warps resident per SM, and one wave of blocks, or fewer when
// there are fewer groups (per_sm: the blocks resident per SM).
template <class Smem>
int vj_group_grid(const void* fn, Smem smem, long long n_groups, int* threads, int* blocks,
                  int* per_sm_out = nullptr) {
  const int choices[] = {256, 128, 64};
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kVjMaxSmem);
  if (err != cudaSuccess) return (int)err;
  int best = 0, per_sm_best = 0;
  for (int th : choices) {
    if (smem(th) > kVjMaxSmem) continue;
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, th, smem(th))) !=
        cudaSuccess)
      return (int)err;
    if (per_sm * th > best) {
      best = per_sm * th;
      *threads = th;
      per_sm_best = per_sm;
    }
  }
  if (best == 0) return (int)cudaErrorInvalidConfiguration;
  int n_sm = 0;
  if (const int e = vj_sm_count(&n_sm)) return e;
  const long long per_block = *threads / 32, want = (n_groups + per_block - 1) / per_block;
  const long long b = (long long)per_sm_best * n_sm;
  *blocks = (int)(b < want ? b : want);
  if (per_sm_out) *per_sm_out = per_sm_best;
  return 0;
}
