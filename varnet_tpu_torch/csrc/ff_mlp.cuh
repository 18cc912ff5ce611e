// Fourier-feature MLP kernels for Hopper (sm_90a), all on the tensor cores (3xTF32
// mma.sync, csrc/tc3xtf32.cuh; the backward's row products on warpgroup wgmma,
// csrc/wgmma_tf32.cuh): the kernels and their host launchers, templated on the padded
// width (NI) and on the activation's kind (SIN).  csrc/ff_mlp.cu instantiates the
// tanh / sigmoid kernels (SIN false) and holds the C entry points, csrc/ff_mlp_sin.cu the
// sin ones: two translation units, which the build compiles side by side.
//
// Replace the TPU kernels of the JAX package that run the trial net
// u = MLP([sin | cos](2 pi B^T xs)) with a fixed B:
//   ff_fwd_kernel (residual mode) <- ops/pallas_residual.py::_fused_residual_fn,
//                                    directional, n_ff > 0 (_dir_fwd_kernel)   K2-FF forward
//   ff_bwd_kernel (residual mode) <- the same, _dir_bwd_kernel                  K2-FF backward
//   ff_fwd_kernel (unit mode)     <- ops/pallas_mlp.py::_fwd_pallas_ff          K7 forward
//   ff_bwd_kernel (unit mode)     <- ops/pallas_mlp.py::_bwd_pallas_ff          K7 backward
//   ff_jvp_kernel                 <- ops/pallas_mlp.py::_jvp_pallas_ff          K8
//                                    (_jvp_kernel_ff, _jvp_tail)
//   ff_fwd_kernel (jacobian mode) <- ops/pallas_residual.py::_fused_residual_fn,
//                                    directional=False (_fused_fwd_kernel)       K3 forward
//   ff_bwd_kernel (jacobian mode) <- the same, _fused_bwd_kernel                 K3 backward
//   ff_fwd/bwd_kernel (precoeff)  <- ops/pallas_residual.py::_dirp_residual_fn   K4, width > 64
//
// All of them push a few point PANELS through one layer stack: the value panel and one
// forward-mode tangent panel per direction.  K2-FF has one direction per point, the
// weak-form vector c (its output is r_k = sum_q dd + csrc + cu u); K7 has the n_in unit
// vectors of the scaled coordinates (its output is [u, du/dxs]); K8 carries the K7
// panels and their parameter tangents.  Layer 0's input is the
// embedding E = [sin | cos](ang), ang = bt xs (bt = 2 pi B^T [F][n_in]), and along a
// direction v its tangent [cos | -sin](ang) * (bt v).  B is fixed: nothing flows to it.
// Without bt (a null pointer) layer 0 takes the scaled coordinates themselves and, along
// v, v (a plain MLP): the same kernels then carry the plain nets wider than
// value_and_jac.cu and dir_residual.cu take (hidden width 65..256).
//
// Residual modes (FfMode).  FF_DIR (K2-FF) forms the weak-form direction c, cu and csrc
// from the shared tables per point; FF_PRE (K4 for nets wider than 64) reads them per
// point, precomputed (ops/fused_residual.py::prepare_residual_coeffs: exact BC, per-node
// tables); both push the value and the one tangent panel along c.  FF_JAC (K3) pushes the
// value and the n_in unit panels, so the output is u and du/dxs themselves, and forms the
// jacobian-panel integrand from them in an epilogue,
//     contrib = csrc + sum_j c_j du_j + cu u + w N u (sum_{j<d} b_j s_j du_j),
// the last term being viscous Burgers' nonlinear advection u (b . grad u) (b: nl, s: the
// input scale; grad u in the original coordinates).  Its backward forms the point
// cotangents of _fused_bwd_kernel from gr[k] and the recomputed u, du,
//     g_u = gr cu + gr w N (b . grad u),   g_du_j = gr c_j + gr w N u b_j s_j (j < d),
// and hands them to the unit-mode backward.  The bilinear term is why K3 has no
// directional form: u and grad u enter as a product.  Widths up to 256 (HP = 32..256).
// The residual forwards write one integrand per point; vr_qsum_kernel (tc3xtf32.cuh, the
// K1/K4 forward's) sums each test function's nq of them.
//
// What bounds them: operations.  At the contaminant net (F = 128, width 96 x 3) a panel
// row takes 43 k multiply-adds per layer stack (24.6 k of them layer 0's, K = 256), the
// backward (recompute, cotangents, dW) about 2.4 times the forward, K8 (W s, W ds and
// dW s) about 2.5 times, against tens of bytes read per point.
//
// Design (ff_fwd_kernel, ff_bwd_kernel).  A block of ng warp groups walks tiles of
// points, persistent.  Each group owns 32 stacked rows: G = 32 / npad points of the tile
// with their npad panels (np padded to 2, 4 or 8 with zero rows), row m G + t for panel
// m of point t, so one lane's mma accumulator holds the value and the tangent rows of the
// same points and columns (npad 8: lane and lane ^ 16), and the layer epilogues
// a = act(z + b), J = act'(a) z run on them in registers.  Every layer product -- layer 0
// against the embedding (depth KE = 2 FP), the hidden layers, the cotangents
// G_{l-1} = G_l W_l^T and the weight gradients dW_l = S_{l-1}^T G_l, dW_0 = E^T G_0 --
// is mma.sync.m16n8k8 tf32 in 3xTF32 with a fresh tile per k-step added on the CUDA cores
// (csrc/tc3xtf32.cuh: the same split, product order and rounding as the other kernels),
// but the backward's where its wgmma engine fits (below).  A warp takes its
// group's 32 rows (two 16-row tiles) for its share of the HP / 8 output tiles: each B
// fragment is split once for both row tiles, each A fragment once for the share.  A group
// is WG = 2 warps up to HP 128 and 4 above (ff_wg), so a warp's share is at most 8 tiles
// (64 accumulator floats a lane) at every width, and a block at most 256 threads (ng <= 8
// / WG).
//
// The backward's wgmma engine (ff_bwd_kernel<NI, SIN, true>).  Its row products -- the
// recompute (layer 0 against the embedding, the hidden layers) and the cotangents, which
// run down a weight slice -- are warpgroup products, wgmma.mma_async.m64nNk8 .tf32: A, the
// stacked rows, from registers, split once as a warp loads them (a warp holds its own 16
// rows for its warpgroup's columns); B, the weight slice, from shared memory, split once
// per slice into a TF32 hi and a lo plane in wgmma's K-major layout (wg_split, from the
// raw slice that cp.async brought a slice ahead: one split serves every warpgroup and
// k-step, and the forward layout's transpose comes free).  3xTF32 stays, with the mma.sync
// engine's product order and rounding: per k-step a_lo b_hi, a_hi b_lo, a_hi b_hi into a
// fresh register tile, added to the running sum on the CUDA cores (one fresh tile per
// slice instead moved K3's cancelling b_out sum, sum |g_u| / |sum g_u| = 26,387, past its
// gate).  The products are in flight while the threads split the next slice and form the
// next embedding slice; one block barrier per slice, as before.  What sets the pace is not the tensor cores: a
// slice is a chain of CUDA-core steps (the split, the cp.async issue, the embedding, the A
// loads, the barrier) that 8 warps cannot overlap (on an H100, dropping the products alone
// saved 6% of the kernel), so the engine's block is four warpgroups, 16 warps: warpgroup
// wg takes the 64 rows 64 (wg / 2).. for the column half HP / 2 (wg % 2)..; N = HP / 2 keeps a
// thread's fragment and fresh tile in the 128 registers that 512 threads leave it (up to
// HP 128; above, two warpgroups over 64 rows).  A warp's 16 rows are half the points of
// one group with all their panels (wg_rows), so the epilogues keep the group layout of the
// slots: every CUDA-core pass (ff_epilogue, ff_outputs) and the weight-gradient units are
// the mma.sync engine's.  Those units stay on mma.sync: they sum over the stacked rows,
// which no slot holds K-major, so wgmma needs one operand split into K-major planes chunk
// by chunk, and on an H100 that cost more than it saved (dW_l +4.3 ms, dW_0 +9.5 ms of
// K2-FF's 184 ms).

// K8 (ff_jvp_kernel) is the same walk with its own row layout: a group's 32 rows are two
// 16-row tiles, tile 0 the s panels (value and unit tangents) of G = 16 / npad points,
// tile 1 their parameter tangents ds at the same rows, so a lane holds s and ds of the
// same rows and columns.  Per hidden layer tile 0 += S W and tile 1 += DS W + S dW (the
// second term reuses tile 0's split A fragments; a k-step's two products share one fresh
// tile); layer 0 takes tile 0 += E W0, tile 1 += E dW0 (B is fixed: E has no parameter
// tangent).  W and dW slices stream together.  The epilogue, in registers, with the value
// row's z and dz brought to the tangent rows by a shuffle: z = acc0 + b, dz = acc1 + db;
// value rows a and sp dz; tangent rows sp zc and spp dz zc + sp dzc.  The output is
// dW_out . s + w_out . ds (+ db_out on the value row), per point: no atomics.
//
// Weights stream, they do not stay.  Kept in f32 in shared memory the contaminant net's
// weights take 172 KB, which would leave one block of 4 warps per SM beside the
// backward's L stacked slots; instead each product streams its weights through a double
// buffer of FF_SLICE-row K-slices with cp.async (ff_stage), the next slice -- across
// layers, and into the block's next tile -- loading while the current one is summed, one
// block barrier per slice.  Layer 0's slices take W0's sin and cos rows of the same 8
// features, so one sincosf per point and feature forms the embedding slice of every
// panel (ff_form_emb; full range reduction: angles reach ~76 rad at the contaminant's
// unscaled inputs, formed in the JAX kernels' order, bt[f][0] x_0 + bt[f][1] x_1 + ...).
// Each block fetches the weights once per tile of 32 ng rows (64 points of K2-FF at ng 4).
//
// Shared memory (floats; ff_tc_smem_floats), and the occupancy it allows at the
// contaminant shape (HP 96, KE 256, three layers):
//   weight slices 2 x 16 (HP + 8) (backward: 2 x max(16 (HP + 8), 20 HP): the cotangent
//   slices are transposed, [HP][FF_ELD]; K8: 2 x 32 (HP + 8), W and dW); embedding
//   slices 2 x 32 ng x FF_ELD; slots (forward and K8 1, backward L) x 32 ng x (HP + 4);
//   biases, w_out (K8: and their tangents), bt, the tile's point data; the backward's
//   per-epilogue-group sums.
//   forward  HP 96:  ng 4: 93.3 KB -> 2 blocks, 16 warps per SM
//   backward HP 96:  ng 4: 196.3 KB -> 1 block, 8 warps per SM (mma.sync engine)
//                    wgmma engine: beside the raw slices two split planes, 2 x 2 x 16 HP
//                    floats, and five epilogue groups' sums: 224.9 KB -> 1 block, 16 warps
//                    (four warpgroups) per SM
//   K8       HP 96:  ng 4: 105.5 KB -> 2 blocks, 16 warps per SM
// At HP 256 the backward's three slots leave ng 1 (157 KB, 4 warps per SM), on the
// mma.sync engine: the wgmma engine's two warpgroups need 64 rows of three slots beside
// 64 KB of planes and 40 KB of raw slices; one hidden layer fits it (8 warps).  The launcher
// takes, of ng = 8 / WG .. 1, the one that keeps the most warps resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; on a tie the larger block: more points
// per fetch of the weights); the backward, of the wgmma engine's blocks (512 threads up to
// HP 128, or 256) wherever one fits from HP 64, else of the mma.sync engine's (HP 32; at
// depth 3 HP 192 and wider); ff_launch_shape reports it, and the backward launchers report
// the engine they took.  Where not even ng 1 fits (a net too deep for its width) the launchers return
// VJ_DOES_NOT_FIT and launch nothing.
//
// The weight gradient.  At the contaminant shape dW is 43,104 floats (172 KB): it does not
// fit in shared memory beside the slots, nor in the registers of 8 warps (168 a thread)
// beside the products.  So each warp sums its dW units -- a row block of 16 rows of dW_l
// (or 16 embedding columns of dW_0) over a quarter of the HP columns, depth the tile's
// 32 ng rows, the K1/K4 backward's row-block units (ff_dw_rows) -- in registers over the
// tile and adds them to the block's partial in device memory (L2-resident) once per tile,
// each element by one fixed lane: 2 x 172 KB of L2 traffic per tile (scripts/ff_costs.py
// times what these adds and dW_0's second pass over the embedding cost, with the
// measurement builds below).  The small sums (biases, w_out, b_out) ride the epilogues,
// thread (group e, column j) summing its share of the points over the whole walk in
// shared memory, added in group order at the end.  A second kernel (ff_reduce_kernel, in
// csrc/ff_mlp.cu) sums the blocks'
// partials in block order.  No atomics: the gradient is bit-identical from call to call,
// which CG needs.
//
// sin (SIREN nets, act 2; template flag SIN, so the tanh / sigmoid kernels are as they
// were).  act' = cos z is no function of the output a, and act''/act' = -tan z needs the
// sign of cos z, which (a, J) has lost.  The forwards (ff_store_fwd, K8's ff_store_jvp)
// form a = sin z and cos z with sincosf while z is in the accumulator and carry cos z
// to the tangent rows where tanh carries a.  The backward keeps z on its slots' value
// rows instead of a (the tangent rows keep J = cos(z) P, as tanh's): the slot size, so the
// block shapes and depth limits, are tanh's.  Whatever reads a value row forms a = sin z
// again as it loads it (the recompute's products, the dW units, K3's output row), and
// ff_epilogue forms sin z and cos z and takes the act'' term as -a (sum_m gj_m J_m) / cos z
// = -a sum_m gj_m P_m: J was formed as cos(z) P from the same cos z, so the quotient gives
// P back to f32 rounding wherever cos z is not zero, which it is at no f32 z.
//
// TPU -> Hopper: the TPU grid ran point tiles in order and summed dW in place; here the
// kernels are persistent (block b walks tiles b, b + gridDim.x, ...).  The TPU's whole
// [2F, T] embedding panels in VMEM become 16-column embedding slices formed per weight
// slice.
//
// Packed parameter layout (floats; ops/fused_residual.py::ff_pack_index mirrors it):
// hidden widths zero-padded to HP (a multiple of 32, at most 256), the features to FP (a
// multiple of 16), KE = 2 FP; weights stored [fan_in][fan_out] (as w in the JAX layout;
// the fragment loaders read it as B [k][n] in the forward, transposed in the cotangents):
//   W0 [KE][HP] (rows f: sin f, FP + f: cos f) | b0 [HP] | (W_l [HP][HP] | b_l [HP])
//   for l = 1..L-1 | w_out [HP] | b_out | pad to 4.
// Without an embedding KE = 32, rows 0..n_in-1 used.  Gradients and parameter tangents
// use the same layout.

#pragma once

#include "tc3xtf32.cuh"
#include "wgmma_tf32.cuh"

#define FF_MAX_IN 4
#define FF_NCF (3 + FF_MAX_IN)  // per-point coefficient rows: cu, csrc, w N, c_0..c_3
#define FF_MAX_THREADS 256      // a block's threads: ng groups of WG warps

// Measurement builds, never the default (scripts/ff_costs.py builds them with -D):
//   FF_PHASE_CLOCK         thread 0 of every block of ff_fwd_kernel / ff_bwd_kernel adds
//                          the clock64() cycles of each phase of its walk (FF_MARK) to
//                          ff_phase_ticks [fwd, bwd][FF_NPHASE], read by ff_phase_ticks_read;
//                          the results are unchanged.  Each translation unit has its own
//                          copy; ff_phase_ticks_read reads ff_mlp.cu's, the tanh / sigmoid
//                          kernels'.
//   FF_DW_NO_PARTIAL_ADDS  the backward adds its dW units into one register instead of the
//                          block's partial: what the per-tile adds cost.
//   FF_DW0_STALE_EMB       dW_0 reads the embedding slices left in E instead of forming them
//                          again: what re-forming costs.  Both give a wrong gradient.
#ifdef FF_PHASE_CLOCK
#define FF_NPHASE 12
static __device__ unsigned long long ff_phase_ticks[2][FF_NPHASE];
#define FF_CLOCK_START                                \
  __shared__ unsigned long long ff_ph[FF_NPHASE];     \
  if (threadIdx.x < FF_NPHASE) ff_ph[threadIdx.x] = 0; \
  long long ff_t0 = clock64();
#define FF_MARK(i)                                                    \
  do {                                                                \
    const long long ff_t1 = clock64();                                \
    if (threadIdx.x == 0) ff_ph[i] += (unsigned long long)(ff_t1 - ff_t0); \
    ff_t0 = ff_t1;                                                    \
  } while (0)
#define FF_CLOCK_END(k)                                               \
  __syncthreads();                                                    \
  if (threadIdx.x < FF_NPHASE) atomicAdd(&ff_phase_ticks[k][threadIdx.x], ff_ph[threadIdx.x]);
#define FF_STATIC_SMEM (FF_NPHASE * 8)  // ff_ph, beside the dynamic shared memory
#else
#define FF_STATIC_SMEM 0
#define FF_CLOCK_START
#define FF_MARK(i) ((void)0)
#define FF_CLOCK_END(k)
#endif

// What a block computes per point: (u, du/dxs) (K7), or one of the weak residuals.
enum FfMode { FF_UNIT = 0, FF_DIR = 1, FF_PRE = 2, FF_JAC = 3 };
// Which stacked kernel (ff_launch_shape's kind).
enum FfKind { FF_FWD = 0, FF_BWD = 1, FF_JVP = 2 };

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

struct FfProblem {
  const float* xs;     // [n_in][P] scaled coordinates
  const float* bt;     // [ke / 2][4] 2 pi B^T, features and n_in zero-padded; null: no
                       // embedding (layer 0 reads xs and the directions)
  const float* flds;   // FF_DIR / FF_JAC: [2 + d (+1)][P] kappa, vel, src[, react]
  const float* tab;    // FF_DIR / FF_JAC: [nq][2 + d] N, w, dN_0..
  const float* scale;  // FF_DIR / FF_JAC: [n_in] input scale
  const float* nl;     // FF_JAC: [d] Burgers direction b, or null (no nonlinear term)
  const float* cdir;   // FF_PRE: [n_in][P] direction c
  const float* csrc;   // FF_PRE: [P] additive term
  const float* cu;     // FF_PRE: [P] coefficient of u, or null
  long long P;
  int mode;            // FfMode
  int n_in, np;        // np panels (value + np - 1 directions)
  int ke, n_hidden, act;
  int nq, d, td, has_react;  // has_react: a cu term (reaction, or FF_PRE's cu)
};

// ------------------------------------------------------------------------------------
// The stacked tensor-core kernels (K2-FF, K7, K8, K3, wide K4).

// Warps per group of 32 stacked rows: a warp takes HP / (8 WG) <= 8 output tiles.
__host__ __device__ constexpr int ff_wg(int hp) { return hp > 128 ? 4 : 2; }
__host__ __device__ inline int ff_npad(int np) { return np <= 2 ? 2 : (np <= 4 ? 4 : 8); }
// Points of a group: 32 rows of npad panels, or (K8) 16 rows, s above ds.
__host__ __device__ inline int ff_group_points(int np, int kind) {
  return (kind == FF_JVP ? 16 : 32) / ff_npad(np);
}
// Floats of one weight-slice buffer: [FF_SLICE][HP + 8] (forward products), in the
// backward also the transposed cotangent slices [HP][FF_ELD], in K8 W and dW slices
// [2 FF_SLICE][HP + 8].
__host__ __device__ inline int ff_wbuf(int hp, int kind) {
  const int a = FF_SLICE * (hp + 8), b = hp * FF_ELD;
  if (kind == FF_JVP) return 2 * a;
  return kind == FF_BWD && b > a ? b : a;
}
// Floats of one epilogue group's sums: the biases of every layer, w_out, b_out (pad 4).
__host__ __device__ inline int ff_acc_floats(int hp, int n_hidden) {
  return (n_hidden + 1) * hp + 4;
}
__host__ __device__ inline int ff_egroups(int nthr, int hp) { return nthr >= hp ? nthr / hp : 1; }
// Floats of one weight-slice buffer of the backward's wgmma engine: the slice's TF32 hi
// and lo planes, [FF_SLICE][HP] each, K-major (wg_core).  The engine keeps two of them
// beside two of ff_wbuf's raw slices, which cp.async fills a slice ahead.
__host__ __device__ inline int ff_wg_wbuf(int hp) { return 2 * FF_SLICE * hp; }
// Shared memory (floats) of a block of ng groups (the order of ff_tc_carve); wg: the
// backward's wgmma engine, whose weight buffers are ff_wg_wbuf's.
__host__ __device__ inline int ff_tc_smem_floats(int hp, int ng, int ke, int n_hidden, int np,
                                                 int kind, bool wg = false) {
  const int R = 32 * ng, TP = ng * ff_group_points(np, kind);
  int f = 2 * (wg ? ff_wg_wbuf(hp) + ff_wbuf(hp, kind) : ff_wbuf(hp, kind)) + 2 * R * FF_ELD +
          (kind == FF_BWD ? n_hidden : 1) * R * (hp + 4) +
          (kind == FF_JVP ? 2 : 1) * (n_hidden * hp + hp + 4) + ke / 2 * 4 + 8 +
          (2 * FF_MAX_IN + FF_NCF) * TP + 2 * R;
  if (kind == FF_BWD)  // the wgmma engine's warpgroups take 32 of the rows each
    f += ff_egroups((wg ? 128 : 32 * ff_wg(hp)) * ng, hp) * ff_acc_floats(hp, n_hidden);
  return f;
}

struct FfTc {
  float *W, *E, *S, *bias, *wout, *dbias, *dwout, *bt, *scale, *nls, *X, *Dir, *Cf, *Go, *Out,
      *Acc, *Wr;
  int npad, G, TP, R, fp, n0, nh, Q, wb, cnt;  // cnt: slices consumed (buffer parity)
  int wrb;                                     // the wgmma engine's raw slice buffers
  bool has_next, has_next2;                    // the block has another tile; two more
};

// The block's shared memory: W, the weight-slice double buffer; E, the embedding-slice
// double buffer [2][R][FF_ELD]; S, the layer slots [nslot][R][HP + 4] (rows 32 g.. of a
// slot are group g's); bias [L][HP]; wout [HP] | b_out; K8's dbias, dwout (the same, of
// the parameter tangent; null otherwise); bt [FP][4]; scale, nls (b_j s_j) [4]; the
// tile's point data X, Dir [4][TP], Cf [FF_NCF][TP]; per stacked row the output
// cotangent Go [R] and output Out [R]; the backward's epilogue sums Acc.
__device__ inline FfTc ff_tc_carve(float* s, int hp, int ng, const FfProblem& pb, int kind,
                                   bool wg = false) {
  FfTc t;
  const bool bwd = kind == FF_BWD, jvp = kind == FF_JVP;
  t.npad = ff_npad(pb.np);
  t.G = ff_group_points(pb.np, kind);
  t.R = 32 * ng;
  t.TP = ng * t.G;
  t.fp = pb.bt ? pb.ke / 2 : 0;
  t.n0 = t.fp ? t.fp / 8 : 1;
  t.nh = hp / FF_SLICE;
  t.Q = t.n0 + (bwd ? 2 : 1) * (pb.n_hidden - 1) * t.nh;
  t.wb = wg ? ff_wg_wbuf(hp) : ff_wbuf(hp, kind);
  t.W = s;      s += 2 * t.wb;
  t.wrb = ff_wbuf(hp, kind);
  t.Wr = wg ? s : nullptr;
  if (wg) s += 2 * t.wrb;
  t.E = s;      s += 2 * t.R * FF_ELD;
  t.S = s;      s += (bwd ? pb.n_hidden : 1) * t.R * (hp + 4);
  t.bias = s;   s += pb.n_hidden * hp;
  t.wout = s;   s += hp + 4;
  t.dbias = t.dwout = nullptr;
  if (jvp) {
    t.dbias = s;  s += pb.n_hidden * hp;
    t.dwout = s;  s += hp + 4;
  }
  t.bt = s;     s += pb.ke / 2 * 4;
  t.scale = s;  s += 4;
  t.nls = s;    s += 4;
  t.X = s;      s += FF_MAX_IN * t.TP;
  t.Dir = s;    s += FF_MAX_IN * t.TP;
  t.Cf = s;     s += FF_NCF * t.TP;
  t.Go = s;     s += t.R;
  t.Out = s;    s += t.R;
  t.Acc = s;
  t.cnt = 0;
  t.has_next = t.has_next2 = false;
  return t;
}

// The biases, w_out | b_out (and, with dparams, K8's tangents of them), bt, the input
// scale and the Burgers direction into shared memory.
static __device__ void ff_tc_load_consts(const FfProblem& pb, const float* __restrict__ params,
                                  const float* __restrict__ dparams, const FfTc& t, int hp) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ow = ff_off_wout(hp, pb.ke, pb.n_hidden);
  for (int i = tid; i < pb.n_hidden * hp; i += nthr) {
    const int o = ff_off_b(hp, pb.ke, i / hp) + i % hp;
    t.bias[i] = params[o];
    if (dparams) t.dbias[i] = dparams[o];
  }
  for (int i = tid; i <= hp; i += nthr) {
    t.wout[i] = params[ow + i];
    if (dparams) t.dwout[i] = dparams[ow + i];
  }
  if (pb.bt)
    for (int i = tid; i < pb.ke / 2 * 4; i += nthr) t.bt[i] = pb.bt[i];
  if (tid < 4) {
    const int j = tid;
    const bool tables = pb.mode == FF_DIR || pb.mode == FF_JAC;
    t.scale[j] = tables && j < pb.n_in ? pb.scale[j] : 0.0f;
    // in the JAX kernel's order: (b_j s_j), then times du_j
    t.nls[j] = (pb.nl && j < pb.d) ? pb.nl[j] * t.scale[j] : 0.0f;
  }
}

// The tile's point data (thread tp < TP: point tile TP + tp, zeros past P): coordinates
// X, the direction Dir (FF_DIR, FF_PRE), the coefficient rows Cf (cu, csrc, w N; FF_JAC's
// c_j) -- the math of _dir_coeffs / _integrand_coeffs, the table read through the cache
// (nothing here is sized by nq) -- and, with g (a backward of FF_UNIT, FF_DIR, FF_PRE),
// the output cotangent of every stacked row, Go.
static __device__ void ff_tc_setup(const FfProblem& pb, const FfTc& t, long long tile,
                            const float* __restrict__ g) {
  const int tp = threadIdx.x, TP = t.TP;
  if (tp >= TP) return;
  const long long p = tile * TP + tp;
  const bool valid = p < pb.P;
#pragma unroll
  for (int j = 0; j < FF_MAX_IN; ++j)
    t.X[j * TP + tp] = (valid && j < pb.n_in) ? pb.xs[j * pb.P + p] : 0.0f;
  float cu = 0.0f;
  if (pb.mode != FF_UNIT) {
    float c[FF_MAX_IN] = {0.0f, 0.0f, 0.0f, 0.0f};
    float csrc = 0.0f, wn = 0.0f;
    if (valid && pb.mode == FF_PRE) {
#pragma unroll
      for (int j = 0; j < FF_MAX_IN; ++j)
        if (j < pb.n_in) c[j] = pb.cdir[j * pb.P + p];
      csrc = pb.csrc[p];
      if (pb.cu) cu = pb.cu[p];
    } else if (valid) {
      const float* row = pb.tab + (int)(p % pb.nq) * (2 + pb.d);
      const float n_q = __ldg(row), w_q = __ldg(row + 1);
      const float kappa = pb.flds[p];
#pragma unroll
      for (int j = 0; j < FF_MAX_IN; ++j) {
        if (j < pb.d) {
          const float vel = pb.flds[(1 + j) * pb.P + p];
          c[j] = w_q * t.scale[j] * (vel * n_q + kappa * __ldg(row + 2 + j));
        } else if (j == pb.d && pb.td) {
          c[j] = w_q * t.scale[j] * n_q;
        }
      }
      csrc = -w_q * n_q * pb.flds[(1 + pb.d) * pb.P + p];
      if (pb.has_react) cu = w_q * n_q * pb.flds[(2 + pb.d) * pb.P + p];
      wn = w_q * n_q;
    }
#pragma unroll
    for (int j = 0; j < FF_MAX_IN; ++j) {
      if (pb.mode == FF_JAC) t.Cf[(3 + j) * TP + tp] = c[j];
      else t.Dir[j * TP + tp] = c[j];
    }
    t.Cf[tp] = cu;
    t.Cf[TP + tp] = csrc;
    t.Cf[2 * TP + tp] = wn;
  }
  if (g) {
    const int r0 = 32 * (tp / t.G) + tp % t.G;
    const float gr = valid && pb.mode != FF_UNIT ? g[p / pb.nq] : 0.0f;
    for (int m = 0; m < t.npad; ++m) {
      float go = 0.0f;
      if (valid && m < pb.np) {
        if (pb.mode == FF_UNIT) go = g[m * pb.P + p];
        else go = m == 0 ? (pb.has_react ? gr * cu : 0.0f) : gr;
      }
      t.Go[r0 + m * t.G] = go;
    }
  }
}

// cp.async of slice q of a tile's weight schedule into buf, one commit group: q < n0,
// layer 0's rows (with an embedding the 8 sin rows 8 q.. then the 8 cos rows FP + 8 q..;
// without, rows 0..15); then the n_hidden - 1 hidden layers, nh slices of FF_SLICE rows
// each, as [k][HP + 8]; then (the backward's cotangents) the hidden layers from the top
// down, transposed: W_l[i][16 s..16 s + 15] as [i][FF_ELD].  JVP (K8): each forward
// slice is followed by the same rows of the parameter tangent dparams, [2 FF_SLICE][HP + 8].
template <int HP, bool JVP>
__device__ void ff_stage(const FfProblem& pb, const float* __restrict__ params,
                         const float* __restrict__ dparams, const FfTc& t, int q, float* buf) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nf = t.n0 + (pb.n_hidden - 1) * t.nh;
  if (q < nf) {
    const bool l0 = q < t.n0;
    const int s = l0 ? q : (q - t.n0) % t.nh;
    const int off = l0 ? 0 : ff_off_w(HP, pb.ke, 1 + (q - t.n0) / t.nh);
    for (int c = tid; c < (JVP ? 2 : 1) * FF_SLICE * HP / 4; c += nthr) {
      const int kk = c / (HP / 4), c4 = c % (HP / 4), k = JVP ? kk % FF_SLICE : kk;
      int row = FF_SLICE * s + k;
      if (l0) row = !t.fp ? k : (k < 8 ? 8 * s + k : t.fp + 8 * s + k - 8);
      const float* w = (JVP && kk >= FF_SLICE ? dparams : params) + off;
      ff_cp_async16(buf + kk * (HP + 8) + 4 * c4, w + row * HP + 4 * c4);
    }
  } else {
    const int idx = q - nf, l = pb.n_hidden - 1 - idx / t.nh, s = idx % t.nh;
    const float* w = params + ff_off_w(HP, pb.ke, l) + FF_SLICE * s;
    for (int c = tid; c < HP * 4; c += nthr) {
      const int i = c >> 2, c4 = c & 3;
      ff_cp_async16(buf + i * FF_ELD + 4 * c4, w + i * HP + 4 * c4);
    }
  }
  ff_cp_async_commit();
}

// Slice j of the tile's stacked layer-0 input into E [R][FF_ELD], every row.  With an
// embedding, columns 0..7 the sin rows and 8..15 the cos rows of features 8 j.. 8 j + 7
// (the order ff_stage loads W0's rows in): the value row [sin | cos](ang), a tangent row
// along v [cos | -sin](ang) (bt_f . v), padded panels zero.  Without, the coordinates or
// the direction (zero past n_in).
static __device__ void ff_form_emb(const FfProblem& pb, const FfTc& t, int j, float* E) {
  const int tid = threadIdx.x, nthr = blockDim.x, TP = t.TP, G = t.G, np = pb.np;
  const bool unit = pb.mode == FF_UNIT || pb.mode == FF_JAC;
  if (t.fp) {
    for (int it = tid; it < TP * 8; it += nthr) {
      const int tp = it >> 3, ff = it & 7;
      const float* b = t.bt + 4 * (8 * j + ff);
      const float* x = t.X + tp;
      float ang = b[0] * x[0];
#pragma unroll
      for (int k = 1; k < FF_MAX_IN; ++k) ang += b[k] * x[k * TP];
      float s, c;
      sincosf(ang, &s, &c);
      float* row = E + (32 * (tp / G) + tp % G) * FF_ELD + ff;
      row[0] = s;
      row[8] = c;
      for (int m = 1; m < t.npad; ++m) {
        float pc = 0.0f;
        if (m < np) {
          if (unit) {
            pc = b[m - 1];
          } else {
            const float* v = t.Dir + tp;
            pc = b[0] * v[0];
#pragma unroll
            for (int k = 1; k < FF_MAX_IN; ++k) pc += b[k] * v[k * TP];
          }
        }
        row[m * G * FF_ELD] = c * pc;
        row[m * G * FF_ELD + 8] = -s * pc;
      }
    }
  } else {
    for (int it = tid; it < TP * FF_SLICE; it += nthr) {
      const int tp = it / FF_SLICE, k = it % FF_SLICE;
      const bool in = k < FF_MAX_IN;
      float* row = E + (32 * (tp / G) + tp % G) * FF_ELD + k;
      row[0] = in ? t.X[k * TP + tp] : 0.0f;
      for (int m = 1; m < t.npad; ++m) {
        float v = 0.0f;
        if (in && m < np) v = unit ? (k == m - 1 ? 1.0f : 0.0f) : t.Dir[k * TP + tp];
        row[m * G * FF_ELD] = v;
      }
    }
  }
}

// The next slice of the schedule after q: the tile's next, the first of the block's next
// tile, or none (-1).
__device__ __forceinline__ int ff_next(const FfTc& t, int q) {
  return q + 1 < t.Q ? q + 1 : (t.has_next ? 0 : -1);
}

// The slice d = 1 or 2 places on from q in the schedule, across the block's tiles, or -1.
__device__ __forceinline__ int ff_ahead(const FfTc& t, int q, int d) {
  int i = q + d;
  if (i < t.Q) return i;
  if ((i -= t.Q) < t.Q) return t.has_next ? i : -1;
  return t.has_next2 ? i - t.Q : -1;  // Q = 1, d = 2: the tile after next
}

// The WG warps of group g (threads 32 WG g ..) meet.
template <int WG>
__device__ __forceinline__ void ff_group_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + (int)threadIdx.x / (32 * WG)), "r"(32 * WG)
               : "memory");
}

// Walks n slices of the weight schedule from slice q0: for slice s it waits for the
// slice's weights, stages the next slice of the schedule into the other buffer (and, with
// emb, forms the embedding slice s + 1), then runs body(s, W) on the slice; one block
// barrier per slice.
template <int HP, bool JVP, class Body>
__device__ __forceinline__ void ff_slices(const FfProblem& pb, const float* __restrict__ params,
                                          const float* __restrict__ dparams, FfTc& t, int q0,
                                          int n, bool emb, Body body) {
  for (int s = 0; s < n; ++s) {
    ff_cp_async_wait_all();
    __syncthreads();
    const float* W = t.W + (t.cnt & 1) * t.wb;
    const int next = ff_next(t, q0 + s);
    if (next >= 0) ff_stage<HP, JVP>(pb, params, dparams, t, next, t.W + ((t.cnt + 1) & 1) * t.wb);
    if (emb && s + 1 < n) ff_form_emb(pb, t, s + 1, t.E + ((s + 1) & 1) * t.R * FF_ELD);
    body(s, W);
    ++t.cnt;
  }
}

// One stacked product over n slices of the weight schedule from slice q0: warp (g, wi) =
// (warp / WG, warp % WG) sums rows 32 g.. of the tile for the output tiles wi NTW ..,
// acc = A B with A(r, k) = a(r, s, k) (row r < 32 of the group, k < FF_SLICE of slice s)
// and B the slice, read b(k, n) = W[k][n] (forward layout) or W[n][k] (transposed).
template <int NI, class LoadA>
__device__ void ff_product(const FfProblem& pb, const float* __restrict__ params, FfTc& t,
                           int q0, int n, bool transposed, bool emb, LoadA a,
                           float (&acc)[2][4 * NI / ff_wg(32 * NI)][4]) {
  constexpr int HP = 32 * NI, WG = ff_wg(HP), NTW = HP / (8 * WG);
  const int n0 = 8 * NTW * ((threadIdx.x >> 5) & (WG - 1));
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
  ff_slices<HP, false>(pb, params, nullptr, t, q0, n, emb, [&](int s, const float* W) {
    if (transposed)
      ff_rows2_slice<NTW>(acc, [&](int r, int k) { return a(r, s, k); },
                          [&](int k, int nn) { return W[(n0 + nn) * FF_ELD + k]; });
    else
      ff_rows2_slice<NTW>(acc, [&](int r, int k) { return a(r, s, k); },
                          [&](int k, int nn) { return W[k * (HP + 8) + n0 + nn]; });
  });
}

// A forward layer's epilogue, stored to the group's rows of slot O: a = act(z + b) on the
// value rows, J = act'(a) z on a tangent row, with a of the same point and column, which
// this lane holds (npad 2: tile 0, same register; npad 4: tile 0, register h & 1) or lane
// & 15 does (npad 8: the group's 4 value rows are rows 0..3 of tile 0, lanes 0..15).
// SIN: a = sin z and cos z by sincosf; cos z goes where tanh's a goes, J = cos z times the
// tangent row's accumulator.  KEEPZ (the sin backward's slots) stores z on the value rows
// instead of a.
template <int NI, bool SIN = false, bool KEEPZ = false>
__device__ void ff_store_fwd(float (&acc)[2][4 * NI / ff_wg(32 * NI)][4], const float* b,
                             float* O, const FfTc& t, int act) {
  constexpr int HP = 32 * NI, WG = ff_wg(HP), NTW = HP / (8 * WG), LD = HP + 4;
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  const int g = threadIdx.x / (32 * WG), n0 = 8 * NTW * ((threadIdx.x >> 5) & (WG - 1));
  const int G = t.G;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    [[maybe_unused]] float cz[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // SIN: cos z of the value rows
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if ((gq + 8 * (h >> 1)) / G == 0) {
        if constexpr (SIN) {
          const float z = acc[0][nt][h] + b[n0 + 8 * nt + 2 * q + (h & 1)];
          float s;
          sincosf(z, &s, &cz[h]);
          acc[0][nt][h] = KEEPZ ? z : s;
        } else {
          acc[0][nt][h] = vj_act(acc[0][nt][h] + b[n0 + 8 * nt + 2 * q + (h & 1)], act);
        }
      }
    float va[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if constexpr (SIN) va[h] = t.npad == 2 ? cz[h] : cz[h & 1];
      else va[h] = t.npad == 2 ? acc[0][nt][h] : acc[0][nt][h & 1];
    }
    if (t.npad == 8) {
#pragma unroll
      for (int h = 0; h < 4; ++h) va[h] = __shfl_sync(0xffffffffu, va[h], lane & 15);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int row = 16 * mt + gq + 8 * (h >> 1);
        if constexpr (SIN) {
          if (row / G != 0) acc[mt][nt][h] *= va[h];
        } else {
          if (row / G != 0) acc[mt][nt][h] *= vj_dact(va[h], act);
        }
        O[(32 * g + row) * LD + n0 + 8 * nt + 2 * q + (h & 1)] = acc[mt][nt][h];
      }
  }
}

// The accumulator as it is, to the group's rows of slot O (the cotangents G_{l-1}).
template <int NI>
__device__ void ff_store_raw(const float (&acc)[2][4 * NI / ff_wg(32 * NI)][4], float* O) {
  constexpr int HP = 32 * NI, WG = ff_wg(HP), NTW = HP / (8 * WG), LD = HP + 4;
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  const int g = threadIdx.x / (32 * WG), n0 = 8 * NTW * ((threadIdx.x >> 5) & (WG - 1));
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        O[(32 * g + 16 * mt + gq + 8 * (h >> 1)) * LD + n0 + 8 * nt + 2 * q + (h & 1)] =
            acc[mt][nt][h];
}

// K8's slice: over the FF_SLICE / 8 k-steps of slice W ([2 FF_SLICE][HP + 8]: the W rows,
// then the dW rows), acc[0] (tile 0, the s rows a(0..15, k)) += S W and acc[1] (tile 1)
// += DS W + S dW with DS = a(16.., k); at layer 0 (L0) acc[1] += S dW alone (the
// embedding has no parameter tangent).  The S fragments are split once for both of their
// products; a k-step's two products into tile 1 share one fresh tile.
template <int HP, int NTW, bool L0, class LoadA>
__device__ __forceinline__ void ff_jvp_slice(float (&acc)[2][NTW][4], LoadA a, const float* W,
                                             int n0) {
#pragma unroll
  for (int k0 = 0; k0 < FF_SLICE; k0 += 8) {
    unsigned sh[4], sl[4], dh[4], dl[4];
    vj_frag_a(a, k0, sh, sl);
    if (!L0) vj_frag_a([&](int r, int k) { return a(16 + r, k); }, k0, dh, dl);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      unsigned wh[2], wl[2], vh[2], vl[2];
      vj_frag_b([&](int k, int n) { return W[k * (HP + 8) + n0 + n]; }, k0, 8 * nt, wh, wl);
      vj_frag_b([&](int k, int n) { return W[(FF_SLICE + k) * (HP + 8) + n0 + n]; }, k0,
                8 * nt, vh, vl);
      float t0[4], t1[4];
      vj_mma3z(t0, sh, sl, wh, wl);
      vj_add(acc[0][nt], t0);
      if (L0) {
        vj_mma3z(t1, sh, sl, vh, vl);
      } else {
        vj_mma3z(t1, dh, dl, wh, wl);
        vj_mma3(t1, sh, sl, vh, vl);
      }
      vj_add(acc[1][nt], t1);
    }
  }
}

// K8's layer epilogue, stored to the group's rows of slot O (s rows 0..15, ds rows
// 16..31): a lane holds rows gq and gq + 8 of both tiles, point gq % G; that point's value
// row is row gq % G, registers 0 and 1 of lane lane & (4 G - 1), which computes
// a = act(z + b), dz = acc1 + db there and shuffles them here.  Value rows: s = a,
// ds = sp dz; tangent rows: s = sp zc, ds = spp dz zc + sp dzc (zc, dzc: the row's acc).
// SIN: sp = cos z, formed beside a by sincosf on the value row and shuffled with it, and
// spp = -a.
template <int NI, bool SIN = false>
__device__ void ff_store_jvp(float (&acc)[2][4 * NI / ff_wg(32 * NI)][4], const float* b,
                             const float* db, float* O, const FfTc& t, int act) {
  constexpr int HP = 32 * NI, WG = ff_wg(HP), NTW = HP / (8 * WG), LD = HP + 4;
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  const int g = threadIdx.x / (32 * WG), n0 = 8 * NTW * ((threadIdx.x >> 5) & (WG - 1));
  const int G = t.G, src = lane & (4 * G - 1);
  float* Os = O + 32 * g * LD;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    float a[2], dz[2];
    [[maybe_unused]] float cz[2];  // SIN: cos z
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = n0 + 8 * nt + 2 * q + e;
      if constexpr (SIN) {
        a[e] = cz[e] = 0.0f;
        if (gq < G) sincosf(acc[0][nt][e] + b[j], &a[e], &cz[e]);
        cz[e] = __shfl_sync(0xffffffffu, cz[e], src);
      } else {
        a[e] = gq < G ? vj_act(acc[0][nt][e] + b[j], act) : 0.0f;
      }
      dz[e] = acc[1][nt][e] + db[j];
      a[e] = __shfl_sync(0xffffffffu, a[e], src);
      dz[e] = __shfl_sync(0xffffffffu, dz[e], src);
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int row = gq + 8 * (h >> 1), e = h & 1, j = n0 + 8 * nt + 2 * q + e;
      float sp;
      if constexpr (SIN) sp = cz[e];
      else sp = vj_dact(a[e], act);
      float sv, dv;
      if (row < G) {
        sv = a[e];
        dv = sp * dz[e];
      } else {
        const float zc = acc[0][nt][h];
        sv = sp * zc;
        if constexpr (SIN) dv = fmaf(-a[e] * dz[e], zc, sp * acc[1][nt][h]);
        else dv = fmaf(vj_ddact(a[e], sp, act) * dz[e], zc, sp * acc[1][nt][h]);
      }
      Os[row * LD + j] = sv;
      Os[(16 + row) * LD + j] = dv;
    }
  }
}

// Out[r] = w . S[r] for the R stacked rows of slot S (b_out not added), w = w_out, or in
// K8 dw_out on a group's s rows (r % 32 < 16): WG threads a row (the block's first WG R
// threads; the backward's wgmma engine has more), each HP / WG columns in four chains,
// then added.  ZROWS: the slot's value rows keep z (a sin backward's), read as a = sin z.
template <int NI, bool ZROWS = false>
__device__ void ff_outputs(const FfTc& t, const float* S) {
  constexpr int HP = 32 * NI, WG = ff_wg(HP), LD = HP + 4, NC = HP / WG;
  const int r = threadIdx.x / WG, part = threadIdx.x & (WG - 1);
  if (r >= t.R) return;  // whole warps: WG R is a multiple of 32
  const float* w = t.dwout && (r & 31) < 16 ? t.dwout : t.wout;
  const float4* s4 = reinterpret_cast<const float4*>(S + r * LD + part * NC);
  const float4* w4 = reinterpret_cast<const float4*>(w + part * NC);
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NC / 4; ++i) {
    float4 a = s4[i];
    const float4 ww = w4[i];
    if constexpr (ZROWS) {
      if ((r & 31) < t.G) a = make_float4(sinf(a.x), sinf(a.y), sinf(a.z), sinf(a.w));
    }
    c[0] = fmaf(ww.x, a.x, c[0]);
    c[1] = fmaf(ww.y, a.y, c[1]);
    c[2] = fmaf(ww.z, a.z, c[2]);
    c[3] = fmaf(ww.w, a.w, c[3]);
  }
  float v = (c[0] + c[1]) + (c[2] + c[3]);
#pragma unroll
  for (int o = 1; o < WG; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (part == 0) t.Out[r] = v;
}

// The per-point results from Out (thread tp < TP): (u, du/dxs) to out [np][P] (FF_UNIT),
// K8's tangent of them (s row's dW_out part + ds row's w_out part, + db_out on the value
// row), or the integrand to out [P] in the order of the JAX kernels: dd + csrc (+ cu u)
// (FF_DIR, FF_PRE), _fused_fwd_kernel's (FF_JAC).
static __device__ void ff_point_out(const FfProblem& pb, const FfTc& t, long long tile, int hp,
                             float* __restrict__ out) {
  const int tp = threadIdx.x, TP = t.TP, G = t.G;
  if (tp >= TP) return;
  const long long p = tile * TP + tp;
  if (p >= pb.P) return;
  const int r0 = 32 * (tp / G) + tp % G;
  if (t.dwout) {
    out[p] = t.Out[r0] + t.Out[r0 + 16] + t.dwout[hp];
    for (int m = 1; m < pb.np; ++m) out[m * pb.P + p] = t.Out[r0 + m * G] + t.Out[r0 + 16 + m * G];
    return;
  }
  const float u = t.Out[r0] + t.wout[hp];
  if (pb.mode == FF_UNIT) {
    out[p] = u;
    for (int m = 1; m < pb.np; ++m) out[m * pb.P + p] = t.Out[r0 + m * G];
  } else if (pb.mode == FF_JAC) {
    float contrib = t.Cf[TP + tp];
    for (int j = 0; j < pb.n_in; ++j) contrib += t.Cf[(3 + j) * TP + tp] * t.Out[r0 + (1 + j) * G];
    if (pb.has_react) contrib += t.Cf[tp] * u;
    if (pb.nl) {
      float dub = 0.0f;
      for (int j = 0; j < pb.d; ++j) dub += t.nls[j] * t.Out[r0 + (1 + j) * G];
      contrib += t.Cf[2 * TP + tp] * (u * dub);
    }
    out[p] = contrib;
  } else {
    float contrib = t.Out[r0 + G] + t.Cf[TP + tp];
    if (pb.has_react) contrib += t.Cf[tp] * u;
    out[p] = contrib;
  }
}

// K3's point cotangents (thread tp < TP) from gr and the recomputed outputs, in the order
// of _fused_bwd_kernel, to every stacked row of the point in Go.
static __device__ void ff_jac_seeds(const FfProblem& pb, const FfTc& t, long long tile, int hp,
                             const float* __restrict__ g) {
  const int tp = threadIdx.x, TP = t.TP, G = t.G;
  if (tp >= TP) return;
  const long long p = tile * TP + tp;
  const int r0 = 32 * (tp / G) + tp % G;
  float go[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (p < pb.P) {
    const float gr = g[p / pb.nq];
    go[0] = pb.has_react ? gr * t.Cf[tp] : 0.0f;
    for (int j = 0; j < pb.n_in; ++j) go[1 + j] = gr * t.Cf[(3 + j) * TP + tp];
    if (pb.nl) {
      const float gw = gr * t.Cf[2 * TP + tp];
      float dub = 0.0f;
      for (int j = 0; j < pb.d; ++j) dub += t.nls[j] * t.Out[r0 + (1 + j) * G];
      go[0] += gw * dub;
      const float gcu = gw * (t.Out[r0] + t.wout[hp]);
      for (int j = 0; j < pb.d; ++j) go[1 + j] += t.nls[j] * gcu;
    }
  }
  for (int m = 0; m < t.npad; ++m) t.Go[r0 + m * G] = go[m];
}

// [a; J]_l -> [gz; gp]_l in place in slot l, over the tile's points: gz = act' ga +
// (act''/act') sum_m gj_m J_m, gp_m = act' gj_m, (ga, gj) the rows of G_l in slot Gs, or at
// the top (Gs null) w_out go.  Thread (group e, column j) takes column j of points e,
// e + EG, ...; it adds its gz to db_l and, at the top, go . S to dw_out and go to b_out,
// in group e's sums (Acc), which no other thread writes.  SIN: slot l keeps [z; J]: a = sin
// z, act' = cos z, and the act'' term -a sum_m gj_m P_m = -a (sum_m gj_m J_m) / cos z; and
// b_out's share of group e is summed apart, in f64, by thread e: K3's point cotangents
// g_u can nearly cancel there (sum |g_u| / |sum g_u| is 26,387 in the card sweep's case
// jac-F0-96-3-sin-64, scripts/k3_sum_order.py), where the chain of f32 adds loses what
// the f32 plain version keeps.  (Apart, so the column loop keeps its registers.)
template <int NI, bool SIN = false>
__device__ void ff_epilogue(const FfProblem& pb, const FfTc& t, int l, const float* Gs) {
  constexpr int HP = 32 * NI, LD = HP + 4;
  const int nthr = blockDim.x, np = pb.np, act = pb.act, G = t.G, L = pb.n_hidden;
  const int EG = ff_egroups(nthr, HP), na = ff_acc_floats(HP, L);
  float* Sl = t.S + l * t.R * LD;
  const bool top = Gs == nullptr;
  if constexpr (SIN) {
    for (int e = threadIdx.x; top && e < EG; e += nthr) {
      double dbo = 0.0;
      for (int tp = e; tp < t.TP; tp += EG) dbo += t.Go[32 * (tp / G) + tp % G];
      t.Acc[e * na + (L + 1) * HP] += dbo;
    }
  }
  for (int c = threadIdx.x; c < EG * HP; c += nthr) {
    const int e = c / HP, j = c % HP;
    const float w = t.wout[j];
    float db = 0.0f, dwo = 0.0f, dbo = 0.0f;
    for (int tp = e; tp < t.TP; tp += EG) {
      const int r0 = 32 * (tp / G) + tp % G;
      float* s = Sl + r0 * LD + j;
      float a = s[0], sp;
      if constexpr (SIN) sincosf(a, &a, &sp);
      else sp = vj_dact(a, act);
      float ga, sum = 0.0f;
      if (top) {
        const float go = t.Go[r0];
        ga = w * go;
        dwo = fmaf(go, a, dwo);
        if constexpr (!SIN) dbo += go;
      } else {
        ga = Gs[r0 * LD + j];
      }
      for (int m = 1; m < np; ++m) {
        float* sj = s + m * G * LD;
        const float J = *sj;
        float gj;
        if (top) {
          const float go = t.Go[r0 + m * G];
          gj = w * go;
          dwo = fmaf(go, J, dwo);
        } else {
          gj = Gs[(r0 + m * G) * LD + j];
        }
        sum = fmaf(gj, J, sum);
        *sj = sp * gj;
      }
      float gz;
      if constexpr (SIN) gz = fmaf(sp, ga, -a * (sum / sp));
      else gz = fmaf(sp, ga, vj_ddact_ratio(a, act) * sum);
      s[0] = gz;
      db += gz;
    }
    float* acc = t.Acc + e * na;
    acc[l * HP + j] += db;
    if (top) {
      acc[L * HP + j] += dwo;
      if (!SIN && j == 0) acc[(L + 1) * HP] += dbo;
    }
  }
}

// ------------------------------------------------------------------------------------
// Forward (K2-FF / K4-wide / K3 in the residual modes, K7 in unit mode), persistent:
//   residual modes: out [P] = the integrand per point (summed over q by vr_qsum_kernel)
//   unit mode:      out [np][P] = (u, du/dxs_j)
// Per tile: the point data, layer 0 against the embedding slices, the hidden layers in
// place in the one slot (the group meets before it overwrites the rows it read), the
// output row, the per-point results.
template <int NI, bool SIN>
__global__ void __launch_bounds__(FF_MAX_THREADS, 2)
    ff_fwd_kernel(FfProblem pb, const float* __restrict__ params, float* __restrict__ out,
                  long long n_tiles, int ng) {
  extern __shared__ float4 ff_smem4[];
  constexpr int HP = 32 * NI, LD = HP + 4, WG = ff_wg(HP), NTW = HP / (8 * WG);
  FfTc t = ff_tc_carve(reinterpret_cast<float*>(ff_smem4), HP, ng, pb, FF_FWD);
  const int L = pb.n_hidden, act = pb.act, g = threadIdx.x / (32 * WG);
  FF_CLOCK_START
  ff_tc_load_consts(pb, params, nullptr, t, HP);
  long long tile = blockIdx.x;
  if (tile < n_tiles) ff_stage<HP, false>(pb, params, nullptr, t, 0, t.W);
  const float* Eg = t.E + 32 * g * FF_ELD;
  const float* Sg = t.S + 32 * g * LD;
  for (; tile < n_tiles; tile += gridDim.x) {
    t.has_next = tile + gridDim.x < n_tiles;
    __syncthreads();  // the previous tile is done with the point data
    ff_tc_setup(pb, t, tile, nullptr);
    __syncthreads();
    FF_MARK(0);
    ff_form_emb(pb, t, 0, t.E);
    float acc[2][NTW][4];
    ff_product<NI>(pb, params, t, 0, t.n0, false, true,
                   [&](int r, int s, int k) { return Eg[((s & 1) * t.R + r) * FF_ELD + k]; },
                   acc);
    ff_store_fwd<NI, SIN>(acc, t.bias, t.S, t, act);
    FF_MARK(1);
    for (int l = 1; l < L; ++l) {
      ff_product<NI>(pb, params, t, t.n0 + (l - 1) * t.nh, t.nh, false, false,
                     [&](int r, int s, int k) { return Sg[r * LD + FF_SLICE * s + k]; }, acc);
      ff_group_sync<WG>();
      ff_store_fwd<NI, SIN>(acc, t.bias + l * HP, t.S, t, act);
    }
    __syncthreads();
    FF_MARK(2);
    ff_outputs<NI>(t, t.S);
    __syncthreads();
    ff_point_out(pb, t, tile, HP, out);
    FF_MARK(3);
  }
  FF_CLOCK_END(0)
}

// ------------------------------------------------------------------------------------
// The backward's wgmma engine (csrc/wgmma_tf32.cuh): its row products -- the recompute
// (layer 0 against the embedding slices, the hidden layers) and the cotangents -- as
// warpgroup products.  Warpgroup wg takes the 64 stacked rows 64 (wg / 2).. for the
// columns HP / 2 (wg % 2).. (ff_wg_cols): four warpgroups, 128 rows, up to HP 128, two
// (64 rows) where four do not fit.  Warp w of a warpgroup holds half the points of group
// 2 (wg / 2) + w / 2 with all their npad panels, so a lane's two accumulator rows are a
// point's value row and a tangent row, or two tangent rows (the epilogue's shuffle brings
// the value, as ff_store_fwd's npad 8).

// Columns per warpgroup: wgmma's N.
__host__ __device__ constexpr int ff_wg_cols(int hp) { return hp / 2; }
// The engine's largest block: four warpgroups (128 stacked rows) while N <= 64 (a thread's
// fragment and fresh tile in 128 registers), else two (64 rows).
__host__ __device__ constexpr int ff_wg_threads(int hp) { return hp <= 128 ? 512 : 256; }

// A thread's place in the engine: its group g, the group rows r0 / r1 of its warp rows gq
// and gq + 8 (warp row i: point (w & 1) P2 + i % P2 of the group, panel i / P2, P2 = G /
// 2 points a warp), its first column n0, and whether r0 is a value row.
struct WgRows {
  int g, r0, r1, n0;
  bool value;
};

__device__ __forceinline__ WgRows wg_rows(const FfTc& t, int hp) {
  const int tid = threadIdx.x, w = (tid >> 5) & 3, wg = tid >> 7, gq = (tid & 31) >> 2;
  const int p2 = t.G >> 1, half = (w & 1) * p2;
  WgRows r;
  r.g = 2 * (wg >> 1) + (w >> 1);
  r.r0 = (gq / p2) * t.G + half + gq % p2;
  r.r1 = ((gq + 8) / p2) * t.G + half + (gq + 8) % p2;
  r.n0 = (wg & 1) * (hp / 2);
  r.value = gq < p2;
  return r;
}

// Slice q of the tile's weight schedule, as ff_stage left it in raw ([FF_SLICE][HP + 8] a
// forward slice, B(k, n) = raw[k][n]; [HP][FF_ELD] a cotangent slice, B(k, n) =
// raw[n][k]), split into its TF32 hi and lo planes at hi and hi + FF_SLICE HP (wg_core's
// K-major layout), four k of one column n a thread.  Ends with the async-proxy fence (the
// reads are wgmma's).
template <int HP>
__device__ void wg_split(const FfProblem& pb, const FfTc& t, int q, const float* raw,
                         float* hi) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const bool fwd = q < t.n0 + (pb.n_hidden - 1) * t.nh;
  float* lo = hi + FF_SLICE * HP;
  for (int c = tid; c < 4 * HP; c += nthr) {
    // 8 consecutive threads: 8 columns n of one k quad (128 contiguous plane bytes)
    const int n = (c & 7) + 8 * (c >> 5), k0 = 4 * ((c >> 3) & 3);
    float v[4];
    if (fwd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = raw[(k0 + e) * (HP + 8) + n];
    } else {
      const float4 x = *reinterpret_cast<const float4*>(raw + n * FF_ELD + k0);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    }
    float h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      unsigned uh, ul;
      vj_split(v[e], uh, ul);
      h[e] = __uint_as_float(uh);
      l[e] = __uint_as_float(ul);
    }
    *reinterpret_cast<float4*>(hi + wg_core(n, k0)) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + wg_core(n, k0)) = make_float4(l[0], l[1], l[2], l[3]);
  }
  wg_fence_proxy();
}

// One stacked product over n slices of the weight schedule from slice q0, by the
// warpgroups: acc (the thread's D fragment, columns rw.n0..) = A B with A(r, k) = a(r, s,
// k) (group row r < 32 of group rw.g, k < FF_SLICE of slice s) and B the slice's planes.
// Per slice, after the block barrier: cp.async of the raw slice two on (ff_stage); the
// thread's A fragments of both k-steps, split; the six products (per k-step a_lo b_hi,
// a_hi b_lo, a_hi b_hi into a fresh tile of its own: tc3xtf32.cuh's order and rounding),
// in flight while the threads split the next slice's raw copy into the other planes
// (wg_split; and, with emb, form the embedding slice s + 1); then the two tiles are added
// on the CUDA cores in k order.
template <int NI, class LoadA>
__device__ void wg_product(const FfProblem& pb, const float* __restrict__ params, FfTc& t,
                           int q0, int n, bool emb, const WgRows& rw, LoadA a,
                           float (&acc)[ff_wg_cols(32 * NI) / 8][4]) {
  constexpr int HP = 32 * NI, N = ff_wg_cols(HP), NT = N / 8;
  const int q = threadIdx.x & 3;
  float tile[2][NT][4];  // a fresh tile per k-step
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 4; ++h) acc[nt][h] = tile[0][nt][h] = tile[1][nt][h] = 0.0f;
  for (int s = 0; s < n; ++s) {
    ff_cp_async_wait_all();  // the next slice's raw copy
    __syncthreads();  // the slice's planes and embedding slice; every read of the others done
    const int qs = q0 + s, q2 = ff_ahead(t, qs, 2);
    if (q2 >= 0) ff_stage<HP, false>(pb, params, nullptr, t, q2, t.Wr + (t.cnt & 1) * t.wrb);
    const float* P = t.W + (t.cnt & 1) * t.wb + 16 * rw.n0;
    unsigned ah[2][4], al[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k = 8 * ks + q;
      vj_split(a(rw.r0, s, k), ah[ks][0], al[ks][0]);
      vj_split(a(rw.r1, s, k), ah[ks][1], al[ks][1]);
      vj_split(a(rw.r0, s, k + 4), ah[ks][2], al[ks][2]);
      vj_split(a(rw.r1, s, k + 4), ah[ks][3], al[ks][3]);
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 4; ++h) wg_pin(tile[ks][nt][h]);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      float(&d)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&tile[ks][0][0]);
      const uint64_t bh = wg_desc(P + 64 * ks, 128, 512);
      const uint64_t bl = wg_desc(P + FF_SLICE * HP + 64 * ks, 128, 512);
      wg_mma<N>(d, al[ks], bh, 0);
      wg_mma<N>(d, ah[ks], bl, 1);
      wg_mma<N>(d, ah[ks], bh, 1);
    }
    wg_commit();
    const int q1 = ff_ahead(t, qs, 1);
    if (q1 >= 0)
      wg_split<HP>(pb, t, q1, t.Wr + ((t.cnt + 1) & 1) * t.wrb, t.W + ((t.cnt + 1) & 1) * t.wb);
    if (emb && s + 1 < n) ff_form_emb(pb, t, s + 1, t.E + ((s + 1) & 1) * t.R * FF_ELD);
    wg_wait_all();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 4; ++h) wg_pin(tile[ks][nt][h]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wg_pin(ah[ks][i]);
        wg_pin(al[ks][i]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) vj_add(acc[nt], tile[ks][nt]);
    ++t.cnt;
  }
}

// A forward layer's epilogue from the engine's fragment, stored to slot O: a = act(z + b)
// on the value rows, J = act'(a) z on the tangent rows, a of the same point and column
// from lane lane & (4 P2 - 1) (its r0, registers 0 and 1).  SIN / KEEPZ as ff_store_fwd.
template <int NI, bool SIN = false, bool KEEPZ = false>
__device__ void wg_store_fwd(float (&acc)[ff_wg_cols(32 * NI) / 8][4], const float* b, float* O,
                             const FfTc& t, const WgRows& rw, int act) {
  constexpr int HP = 32 * NI, NT = ff_wg_cols(HP) / 8, LD = HP + 4;
  const int lane = threadIdx.x & 31, q = lane & 3, src = lane & (2 * t.G - 1);
  float* o0 = O + (32 * rw.g + rw.r0) * LD + rw.n0 + 2 * q;
  float* o1 = O + (32 * rw.g + rw.r1) * LD + rw.n0 + 2 * q;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = 0.0f;  // the value row's a (SIN: cos z)
      if (rw.value) {
        const float z = acc[nt][e] + b[rw.n0 + 8 * nt + 2 * q + e];
        if constexpr (SIN) {
          float sz;
          sincosf(z, &sz, &v);
          acc[nt][e] = KEEPZ ? z : sz;
        } else {
          acc[nt][e] = v = vj_act(z, act);
        }
      }
      v = __shfl_sync(0xffffffffu, v, src);
      float sp;
      if constexpr (SIN) sp = v;
      else sp = vj_dact(v, act);
      if (!rw.value) acc[nt][e] *= sp;
      acc[nt][2 + e] *= sp;
      o0[8 * nt + e] = acc[nt][e];
      o1[8 * nt + e] = acc[nt][2 + e];
    }
}

// The engine's fragment as it is, to slot O (the cotangents G_{l-1}).
template <int NI>
__device__ void wg_store_raw(const float (&acc)[ff_wg_cols(32 * NI) / 8][4], float* O,
                             const WgRows& rw) {
  constexpr int HP = 32 * NI, NT = ff_wg_cols(HP) / 8, LD = HP + 4;
  const int q = threadIdx.x & 3;
  float* o0 = O + (32 * rw.g + rw.r0) * LD + rw.n0 + 2 * q;
  float* o1 = O + (32 * rw.g + rw.r1) * LD + rw.n0 + 2 * q;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      o0[8 * nt + e] = acc[nt][e];
      o1[8 * nt + e] = acc[nt][2 + e];
    }
}

// ------------------------------------------------------------------------------------
// Backward (K2-FF / K4-wide / K3 in the residual modes, K7 in unit mode): persistent, one
// gradient partial per block.  The output cotangent per stacked row is (gr cu, gr) in
// FF_DIR / FF_PRE (gr [K] per test function), K3's (g_u, g_du_j) in FF_JAC (formed from
// gr and the recomputed outputs), g [np][P] in unit mode.  Per tile: the forward with
// every layer's slot kept; the top epilogue; going down, dW_l += S_{l-1}^T [gz; gp]_l
// (units in registers, added to the partial), G_{l-1} = [gz; gp]_l W_l^T in place in slot
// l, the epilogue into slot l - 1; last dW_0 += E^T [gz; gp]_0 over the embedding slices,
// formed again (one sincosf per point and feature).  SIN: the slots keep [z; J] (the
// file's header), and every read of a value row forms a = sin z.
template <int NI, bool SIN, bool WGMMA>
__global__ void __launch_bounds__(WGMMA ? ff_wg_threads(32 * NI) : FF_MAX_THREADS, 1)
    ff_bwd_kernel(FfProblem pb, const float* __restrict__ params, const float* __restrict__ g,
                  float* __restrict__ partials, long long n_tiles, int ng) {
  extern __shared__ float4 ff_smem4[];
  constexpr int HP = 32 * NI, LD = HP + 4, WG = ff_wg(HP), NTW = HP / (8 * WG);
  FfTc t = ff_tc_carve(reinterpret_cast<float*>(ff_smem4), HP, ng, pb, FF_BWD, WGMMA);
  const int L = pb.n_hidden, act = pb.act, tid = threadIdx.x, nthr = blockDim.x;
  const int grp = tid / (32 * WG), warp = tid >> 5, nwarp = nthr >> 5;
  const int lane = tid & 31, gq = lane >> 2, q = lane & 3;
  const int slot = t.R * LD, npp = ff_n_params(HP, pb.ke, L);
  const int EG = ff_egroups(nthr, HP), na = ff_acc_floats(HP, L);
  const int nf = t.n0 + (L - 1) * t.nh;
  FF_CLOCK_START
  float* part = partials + (long long)blockIdx.x * npp;
  for (int i = tid; i < npp; i += nthr) part[i] = 0.0f;
  for (int i = tid; i < EG * na; i += nthr) t.Acc[i] = 0.0f;
  ff_tc_load_consts(pb, params, nullptr, t, HP);
  if (blockIdx.x < n_tiles) {
    if constexpr (WGMMA) {  // raw slices 0 and 1 of the first tile; slice 0 split
      t.has_next = blockIdx.x + gridDim.x < n_tiles;
      ff_stage<HP, false>(pb, params, nullptr, t, 0, t.Wr);
      if (const int q1 = ff_ahead(t, 0, 1); q1 >= 0)
        ff_stage<HP, false>(pb, params, nullptr, t, q1, t.Wr + t.wrb);
      ff_cp_async_wait_all();
      __syncthreads();
      wg_split<HP>(pb, t, 0, t.Wr, t.W);
    } else {
      ff_stage<HP, false>(pb, params, nullptr, t, 0, t.W);
    }
  }
  const float* Eg = t.E + 32 * grp * FF_ELD;
  float acc[2][NTW][4];
  // the wgmma engine's: its place and its fragment
  [[maybe_unused]] const WgRows rw = wg_rows(t, HP);
  [[maybe_unused]] float wacc[ff_wg_cols(HP) / 8][4];
#ifdef FF_DW_NO_PARTIAL_ADDS
  float dw_sink = 0.0f;
#define FF_DW_ADD(dst, v) ((void)&(dst), dw_sink += (v))
#else
#define FF_DW_ADD(dst, v) ((dst) += (v))
#endif

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    t.has_next = tile + gridDim.x < n_tiles;
    t.has_next2 = tile + 2 * gridDim.x < n_tiles;
    __syncthreads();  // the previous tile is done with the point data and E
    ff_tc_setup(pb, t, tile, pb.mode == FF_JAC ? nullptr : g);
    __syncthreads();
    FF_MARK(0);
    ff_form_emb(pb, t, 0, t.E);
    if constexpr (WGMMA) {
      const float* Ew = t.E + 32 * rw.g * FF_ELD;
      wg_product<NI>(pb, params, t, 0, t.n0, true, rw,
                     [&](int r, int s, int k) { return Ew[((s & 1) * t.R + r) * FF_ELD + k]; },
                     wacc);
      wg_store_fwd<NI, SIN, SIN>(wacc, t.bias, t.S, t, rw, act);
    } else {
      ff_product<NI>(pb, params, t, 0, t.n0, false, true,
                     [&](int r, int s, int k) { return Eg[((s & 1) * t.R + r) * FF_ELD + k]; },
                     acc);
      ff_store_fwd<NI, SIN, SIN>(acc, t.bias, t.S, t, act);
    }
    FF_MARK(1);
    for (int l = 1; l < L; ++l) {
      const float* Sp = t.S + (l - 1) * slot + 32 * (WGMMA ? rw.g : grp) * LD;
      const auto a = [&](int r, int s, int k) {
        const float v = Sp[r * LD + FF_SLICE * s + k];
        if constexpr (SIN) return r < t.G ? sinf(v) : v;
        else return v;
      };
      if constexpr (WGMMA) {
        wg_product<NI>(pb, params, t, t.n0 + (l - 1) * t.nh, t.nh, false, rw, a, wacc);
        wg_store_fwd<NI, SIN, SIN>(wacc, t.bias + l * HP, t.S + l * slot, t, rw, act);
      } else {
        ff_product<NI>(pb, params, t, t.n0 + (l - 1) * t.nh, t.nh, false, false, a, acc);
        ff_store_fwd<NI, SIN, SIN>(acc, t.bias + l * HP, t.S + l * slot, t, act);
      }
    }
    __syncthreads();
    FF_MARK(2);
    if (pb.mode == FF_JAC) {
      ff_outputs<NI, SIN>(t, t.S + (L - 1) * slot);
      __syncthreads();
      ff_jac_seeds(pb, t, tile, HP, g);
      __syncthreads();
    }
    ff_epilogue<NI, SIN>(pb, t, L - 1, nullptr);
    __syncthreads();
    FF_MARK(3);

    for (int l = L - 1; l >= 1; --l) {
      float* Sl = t.S + l * slot;
      const float* Sp = Sl - slot;
      // dW_l += S_{l-1}^T [gz; gp]_l: unit u = (row block u / 4 of 16 rows, column quarter
      // u % 4), each element added to the partial by one fixed lane
      for (int u = warp; u < HP / 16 * 4; u += nwarp) {
        const int rb = u >> 2, cq = u & 3;
        float dw[NI][4];
        if constexpr (SIN)
          ff_dw_rows_ab<NI>(
              dw,
              [&](int i, int r) {
                const float v = Sp[r * LD + 16 * rb + i];
                return (r & 31) < t.G ? sinf(v) : v;
              },
              [&](int r, int j) { return Sl[r * LD + 8 * NI * cq + j]; }, t.R);
        else
          ff_dw_rows<NI>(dw, Sp + 16 * rb, LD, Sl + 8 * NI * cq, LD, t.R);
        FF_MARK(4);
        float* dst = part + ff_off_w(HP, pb.ke, l) + (16 * rb + gq) * HP + 8 * NI * cq + 2 * q;
#pragma unroll
        for (int nt = 0; nt < NI; ++nt)
#pragma unroll
          for (int h = 0; h < 4; ++h)
            FF_DW_ADD(dst[8 * (h >> 1) * HP + 8 * nt + (h & 1)], dw[nt][h]);
        FF_MARK(5);
      }
      // G_{l-1} = [gz; gp]_l W_l^T, in place in slot l once the group has read its rows
      // (the engine: once the block has: two warpgroups share each row)
      const float* Sg = Sl + 32 * (WGMMA ? rw.g : grp) * LD;
      const auto a = [&](int r, int s, int k) { return Sg[r * LD + FF_SLICE * s + k]; };
      if constexpr (WGMMA) {
        wg_product<NI>(pb, params, t, nf + (L - 1 - l) * t.nh, t.nh, false, rw, a, wacc);
        __syncthreads();
        wg_store_raw<NI>(wacc, Sl, rw);
      } else {
        ff_product<NI>(pb, params, t, nf + (L - 1 - l) * t.nh, t.nh, true, false, a, acc);
        ff_group_sync<WG>();
        ff_store_raw<NI>(acc, Sl);
      }
      __syncthreads();
      FF_MARK(6);
      ff_epilogue<NI, SIN>(pb, t, l - 1, Sl);
      __syncthreads();
      FF_MARK(7);
    }

    // dW_0 += E^T [gz; gp]_0: two embedding slices at a time, unit u = (slice u / 4,
    // column quarter u % 4); a slice's 16 columns are W0's rows 8 j.. (sin) and FP + 8 j..
    // (cos), or rows 0..15 without an embedding
    for (int j0 = 0; j0 < t.n0; j0 += 2) {
      const int nb = t.n0 - j0 < 2 ? 1 : 2;
#ifndef FF_DW0_STALE_EMB
      for (int b = 0; b < nb; ++b) ff_form_emb(pb, t, j0 + b, t.E + b * t.R * FF_ELD);
#endif
      __syncthreads();
      FF_MARK(8);
      for (int u = warp; u < 4 * nb; u += nwarp) {
        const int b = u >> 2, cq = u & 3, f0 = 8 * (j0 + b);
        float dw[NI][4];
        ff_dw_rows<NI>(dw, t.E + b * t.R * FF_ELD, FF_ELD, t.S + 8 * NI * cq, LD, t.R);
        FF_MARK(9);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int ii = gq + 8 * (h >> 1);
          const int row = !t.fp ? ii : (ii < 8 ? f0 + ii : t.fp + f0 + ii - 8);
          float* dst = part + row * HP + 8 * NI * cq + 2 * q + (h & 1);
#pragma unroll
          for (int nt = 0; nt < NI; ++nt) FF_DW_ADD(dst[8 * nt], dw[nt][h]);
        }
        FF_MARK(10);
      }
      __syncthreads();
      FF_MARK(9);
    }
  }
#ifdef FF_DW_NO_PARTIAL_ADDS
  part[tid] += dw_sink;  // keeps the dW units' sums alive
#endif
#undef FF_DW_ADD

  // the small sums, in epilogue-group order, to their places in the partial
  __syncthreads();
  const int ow = ff_off_wout(HP, pb.ke, L);
  for (int e = tid; e <= (L + 1) * HP; e += nthr) {
    float v = 0.0f;
    for (int k = 0; k < EG; ++k) v += t.Acc[k * na + e];
    part[e < L * HP ? ff_off_b(HP, pb.ke, e / HP) + e % HP : ow + e - L * HP] = v;
  }
  FF_MARK(11);
  FF_CLOCK_END(1)
}

// ------------------------------------------------------------------------------------
// K8: dout [np][P], the tangent of (u, du/dxs) along the packed parameter tangent
// dparams, persistent.  Per tile: the point data, layer 0 (tile 0 += E W0, tile 1 +=
// E dW0) against the embedding slices, the hidden layers (tile 0 += S W, tile 1 += DS W
// + S dW) in place in the one slot, each layer's epilogue in registers, the output rows
// (dW_out on the s rows, w_out on the ds rows) and the per-point sums.
template <int NI, bool SIN>
__global__ void __launch_bounds__(FF_MAX_THREADS, 2)
    ff_jvp_kernel(FfProblem pb, const float* __restrict__ params,
                  const float* __restrict__ dparams, float* __restrict__ dout,
                  long long n_tiles, int ng) {
  extern __shared__ float4 ff_smem4[];
  constexpr int HP = 32 * NI, LD = HP + 4, WG = ff_wg(HP), NTW = HP / (8 * WG);
  FfTc t = ff_tc_carve(reinterpret_cast<float*>(ff_smem4), HP, ng, pb, FF_JVP);
  const int L = pb.n_hidden, act = pb.act, g = threadIdx.x / (32 * WG);
  const int n0 = 8 * NTW * ((threadIdx.x >> 5) & (WG - 1));
  ff_tc_load_consts(pb, params, dparams, t, HP);
  long long tile = blockIdx.x;
  if (tile < n_tiles) ff_stage<HP, true>(pb, params, dparams, t, 0, t.W);
  const float* Eg = t.E + 32 * g * FF_ELD;
  const float* Sg = t.S + 32 * g * LD;
  float acc[2][NTW][4];
  for (; tile < n_tiles; tile += gridDim.x) {
    t.has_next = tile + gridDim.x < n_tiles;
    __syncthreads();  // the previous tile is done with the point data
    ff_tc_setup(pb, t, tile, nullptr);
    __syncthreads();
    ff_form_emb(pb, t, 0, t.E);
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
      if (l == 0) {
        ff_slices<HP, true>(pb, params, dparams, t, 0, t.n0, true, [&](int s, const float* W) {
          ff_jvp_slice<HP, NTW, true>(
              acc, [&](int r, int k) { return Eg[((s & 1) * t.R + r) * FF_ELD + k]; }, W, n0);
        });
      } else {
        ff_slices<HP, true>(pb, params, dparams, t, t.n0 + (l - 1) * t.nh, t.nh, false,
                            [&](int s, const float* W) {
                              ff_jvp_slice<HP, NTW, false>(
                                  acc, [&](int r, int k) { return Sg[r * LD + FF_SLICE * s + k]; },
                                  W, n0);
                            });
        ff_group_sync<WG>();
      }
      ff_store_jvp<NI, SIN>(acc, t.bias + l * HP, t.dbias + l * HP, t.S, t, act);
    }
    __syncthreads();
    ff_outputs<NI>(t, t.S);
    __syncthreads();
    ff_point_out(pb, t, tile, HP, dout);
  }
}

// ---- host launchers ----------------------------------------------------------------

namespace {

const size_t kMaxSmem = 227 * 1024 - FF_STATIC_SMEM;  // a block's dynamic shared memory, sm_90

// The launch shape of a stacked kernel: ng warp groups per block, blocks resident per SM,
// the persistent grid and the tiles it walks; wg: the backward's wgmma engine.
struct TcShape {
  int ng, threads, per_sm, blocks;
  long long n_tiles;
  size_t smem;
  bool wg;
};

template <int NI, bool SIN>
const void* tc_kernel(int kind, bool wg) {
  return kind == FF_BWD   ? (wg ? (const void*)ff_bwd_kernel<NI, SIN, true>
                                : (const void*)ff_bwd_kernel<NI, SIN, false>)
         : kind == FF_JVP ? (const void*)ff_jvp_kernel<NI, SIN>
                          : (const void*)ff_fwd_kernel<NI, SIN>;
}

// Of ng = 8 / WG .. 1 warp groups per block, the one that keeps the most warps resident
// per SM, on a tie the larger block (more points per fetch of the weights); one wave of
// persistent blocks, or fewer when there are fewer tiles (at least one: a backward with
// P = 0 writes a zero partial).  From the mode and shapes alone, so a blocks query (null
// pointers) sizes the grid as the launch does.  VJ_DOES_NOT_FIT where not even one group
// fits in shared memory.  The backward takes its wgmma engine wherever one of its blocks
// fits -- pairs of warpgroups over 64 rows, a column half each: 512 or 256 threads up to
// HP 128, 256 above -- and its mma.sync engine where none does, and at HP 32, where the
// engine's 16-column products do not pay (on an H100, K3's backward at the Burgers
// front_2d mesh, w32x3: 5.4 ms on mma.sync, 6.7 on wgmma).
template <int NI, bool SIN>
int tc_shape(int kind, const FfProblem& pb, TcShape* out, bool wg) {
  constexpr int HP = 32 * NI, WG = ff_wg(HP);
  if (wg && HP < 64) return tc_shape<NI, SIN>(kind, pb, out, false);
  const void* fn = tc_kernel<NI, SIN>(kind, wg);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  int best = 0;
  bool fits = false;
  for (int ng = (wg ? ff_wg_threads(HP) : FF_MAX_THREADS) / (32 * WG); ng >= 1; --ng) {
    const int threads = wg ? 128 * ng : 32 * WG * ng;
    if (wg && (ng & 1 || threads > ff_wg_threads(HP))) continue;
    const size_t smem =
        sizeof(float) * (size_t)ff_tc_smem_floats(HP, ng, pb.ke, pb.n_hidden, pb.np, kind, wg);
    if (smem > kMaxSmem) continue;
    fits = true;
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem)) !=
        cudaSuccess)
      return (int)err;
    if (per_sm * threads / 32 > best) {
      best = per_sm * threads / 32;
      *out = TcShape{ng, threads, per_sm, 0, 0, smem, wg};
    }
  }
  if (!fits) return kind == FF_BWD && wg ? tc_shape<NI, SIN>(kind, pb, out, false)
                                         : VJ_DOES_NOT_FIT;
  if (best == 0) return (int)cudaErrorInvalidConfiguration;
  int n_sm = 0;
  if (const int e = vj_sm_count(&n_sm)) return e;
  const long long tp = out->ng * ff_group_points(pb.np, kind);
  out->n_tiles = (pb.P + tp - 1) / tp;
  const long long b = (long long)out->per_sm * n_sm;
  out->blocks = (int)(b < out->n_tiles ? b : (out->n_tiles > 0 ? out->n_tiles : 1));
  return 0;
}

template <int NI, bool SIN>
int launch_fwd(const FfProblem& pb, const float* params, float* out, cudaStream_t stream) {
  if (pb.P == 0) return 0;
  TcShape sh;
  const int err = tc_shape<NI, SIN>(FF_FWD, pb, &sh, false);
  if (err) return err;
  ff_fwd_kernel<NI, SIN><<<sh.blocks, sh.threads, sh.smem, stream>>>(pb, params, out,
                                                                     sh.n_tiles, sh.ng);
  return (int)cudaGetLastError();
}

// Rows of the backward's partials buffer: one per block.
template <int NI, bool SIN>
int count_bwd_blocks(const FfProblem& pb, int* blocks) {
  TcShape sh;
  const int err = tc_shape<NI, SIN>(FF_BWD, pb, &sh, true);
  if (err) return err;
  *blocks = sh.blocks;
  return 0;
}

// wgmma: set to whether the launch took the wgmma engine.
template <int NI, bool SIN>
int launch_bwd(const FfProblem& pb, const float* params, const float* g, float* partials,
               int n_blocks, cudaStream_t stream, int* wgmma) {
  TcShape sh;
  const int err = tc_shape<NI, SIN>(FF_BWD, pb, &sh, true);
  if (err) return err;
  if (n_blocks != sh.blocks) return (int)cudaErrorInvalidValue;
  if (sh.wg)
    ff_bwd_kernel<NI, SIN, true><<<sh.blocks, sh.threads, sh.smem, stream>>>(
        pb, params, g, partials, sh.n_tiles, sh.ng);
  else
    ff_bwd_kernel<NI, SIN, false><<<sh.blocks, sh.threads, sh.smem, stream>>>(
        pb, params, g, partials, sh.n_tiles, sh.ng);
  *wgmma = sh.wg;
  return (int)cudaGetLastError();
}

template <int NI, bool SIN>
int launch_jvp(const FfProblem& pb, const float* params, const float* dparams, float* out,
               cudaStream_t stream) {
  if (pb.P == 0) return 0;
  TcShape sh;
  const int err = tc_shape<NI, SIN>(FF_JVP, pb, &sh, false);
  if (err) return err;
  ff_jvp_kernel<NI, SIN><<<sh.blocks, sh.threads, sh.smem, stream>>>(pb, params, dparams, out,
                                                                     sh.n_tiles, sh.ng);
  return (int)cudaGetLastError();
}

template <int NI, bool SIN>
int shape_of(int kind, const FfProblem& pb, int* threads, int* per_sm, int* blocks,
             int* wgmma) {
  TcShape sh;
  const int err = tc_shape<NI, SIN>(kind, pb, &sh, kind == FF_BWD);
  if (err) return err;
  *threads = sh.threads;
  *per_sm = sh.per_sm;
  *blocks = sh.blocks;
  *wgmma = sh.wg;
  return 0;
}

}  // namespace

#define FF_DISPATCH(hp, CALL)                          \
  switch (hp) {                                        \
    case 32: { constexpr int NI = 1; return CALL; }    \
    case 64: { constexpr int NI = 2; return CALL; }    \
    case 96: { constexpr int NI = 3; return CALL; }    \
    case 128: { constexpr int NI = 4; return CALL; }   \
    case 160: { constexpr int NI = 5; return CALL; }   \
    case 192: { constexpr int NI = 6; return CALL; }   \
    case 224: { constexpr int NI = 7; return CALL; }   \
    case 256: { constexpr int NI = 8; return CALL; }   \
    default: return (int)cudaErrorInvalidValue;        \
  }

// The stacked kernels of one activation kind at the padded width hp (cudaErrorInvalidValue
// for another): the forward's per-point results (launch_fwd), the backward's block count
// and its partials (launch_bwd; the caller sums them; wgmma: its engine), K8, a launch
// shape (wgmma: the backward's engine, 0 for the other kinds).  The members
// are instantiated once per kind, each in its own translation unit: FfHost<false> in
// csrc/ff_mlp.cu, FfHost<true> in csrc/ff_mlp_sin.cu.
template <bool SIN>
struct FfHost {
  static int fwd(int hp, const FfProblem& pb, const float* params, float* out,
                 cudaStream_t stream);
  static int bwd_blocks(int hp, const FfProblem& pb, int* blocks);
  static int bwd(int hp, const FfProblem& pb, const float* params, const float* g,
                 float* partials, int n_blocks, cudaStream_t stream, int* wgmma);
  static int jvp(int hp, const FfProblem& pb, const float* params, const float* dparams,
                 float* out, cudaStream_t stream);
  static int shape(int hp, int kind, const FfProblem& pb, int* threads, int* per_sm,
                   int* blocks, int* wgmma);
};

template <bool SIN>
int FfHost<SIN>::fwd(int hp, const FfProblem& pb, const float* params, float* out,
                     cudaStream_t stream) {
  FF_DISPATCH(hp, (launch_fwd<NI, SIN>(pb, params, out, stream)))
}

template <bool SIN>
int FfHost<SIN>::bwd_blocks(int hp, const FfProblem& pb, int* blocks) {
  FF_DISPATCH(hp, (count_bwd_blocks<NI, SIN>(pb, blocks)))
}

template <bool SIN>
int FfHost<SIN>::bwd(int hp, const FfProblem& pb, const float* params, const float* g,
                     float* partials, int n_blocks, cudaStream_t stream, int* wgmma) {
  FF_DISPATCH(hp, (launch_bwd<NI, SIN>(pb, params, g, partials, n_blocks, stream, wgmma)))
}

template <bool SIN>
int FfHost<SIN>::jvp(int hp, const FfProblem& pb, const float* params, const float* dparams,
                     float* out, cudaStream_t stream) {
  FF_DISPATCH(hp, (launch_jvp<NI, SIN>(pb, params, dparams, out, stream)))
}

template <bool SIN>
int FfHost<SIN>::shape(int hp, int kind, const FfProblem& pb, int* threads, int* per_sm,
                       int* blocks, int* wgmma) {
  FF_DISPATCH(hp, (shape_of<NI, SIN>(kind, pb, threads, per_sm, blocks, wgmma)))
}
