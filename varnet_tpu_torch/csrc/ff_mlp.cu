// The C entry points of the Fourier-feature MLP kernels (csrc/ff_mlp.cuh: what they
// replace, their design, the packed parameter layout), the tanh / sigmoid instantiations
// of the stacked kernels, and the second passes of the residual forwards (vr_qsum_kernel)
// and of the backward (ff_reduce_kernel).  The sin instantiations are csrc/ff_mlp_sin.cu's;
// each entry point takes the one act asks for.

#include "ff_mlp.cuh"

template struct FfHost<false>;
extern template struct FfHost<true>;  // csrc/ff_mlp_sin.cu

// The call on the stacked kernels of act's kind: sin's or tanh / sigmoid's.
#define FF_HOST(act, CALL) ((act) == VJ_ACT_SIN ? FfHost<true>::CALL : FfHost<false>::CALL)

// grad[i] = sum_b partials[b][i], in block order.
__global__ void ff_reduce_kernel(const float* __restrict__ partials, float* __restrict__ grad,
                                 int n_blocks, int npp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npp) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(long long)b * npp + i];
  grad[i] = s;
}

namespace {

// The residual forwards: the per-point contributions, then their q-sums per test function.
int launch_res_fwd(int hp, const FfProblem& pb, const float* params, float* contrib, float* r,
                   cudaStream_t stream) {
  const int err = FF_HOST(pb.act, fwd(hp, pb, params, contrib, stream));
  if (err) return err;
  return vr_qsum(contrib, r, (int)(pb.P / pb.nq), pb.nq, stream);
}

// The backward: the blocks' partials, then their sum in block order (wgmma: whether the
// first took the wgmma engine).
int launch_bwd(int hp, const FfProblem& pb, const float* params, const float* g,
               float* partials, int n_blocks, float* grad, cudaStream_t stream, int* wgmma) {
  *wgmma = 0;
  const int err = FF_HOST(pb.act, bwd(hp, pb, params, g, partials, n_blocks, stream, wgmma));
  if (err) return err;
  const int npp = ff_n_params(hp, pb.ke, pb.n_hidden);
  ff_reduce_kernel<<<(npp + 127) / 128, 128, 0, stream>>>(partials, grad, n_blocks, npp);
  return (int)cudaGetLastError();
}

// Unit-mode (value + jacobian) problem (K7, K8).
FfProblem vj_problem(const float* xs, const float* bt, long long P, int n_in, int ke,
                     int n_hidden, int act) {
  FfProblem pb = {};
  pb.xs = xs; pb.bt = bt; pb.P = P; pb.n_in = n_in; pb.np = 1 + n_in;
  pb.ke = ke; pb.n_hidden = n_hidden; pb.act = act;
  return pb;
}

// A residual problem on the tables (FF_DIR: K2-FF; FF_JAC: K3, value + n_in unit panels).
FfProblem res_problem(const float* xs, const float* flds, const float* tab, const float* scale,
                      const float* bt, int k, int nq, int n_in, int d, int td, int has_react,
                      int ke, int n_hidden, int act, int mode = FF_DIR) {
  FfProblem pb = {};
  pb.mode = mode;
  pb.xs = xs; pb.bt = bt; pb.flds = flds; pb.tab = tab; pb.scale = scale;
  pb.P = (long long)k * nq; pb.n_in = n_in;
  pb.np = mode == FF_JAC ? 1 + n_in : 2;
  pb.ke = ke; pb.n_hidden = n_hidden; pb.act = act;
  pb.nq = nq; pb.d = d; pb.td = td; pb.has_react = has_react;
  return pb;
}

// K4 on a plain net (no embedding: ke = 32) from the precomputed coefficients.
FfProblem pre_problem(const float* xs, const float* cdir, const float* csrc, const float* cu,
                      int k, int nq, int n_in, int n_hidden, int act) {
  FfProblem pb = {};
  pb.mode = FF_PRE;
  pb.xs = xs; pb.cdir = cdir; pb.csrc = csrc; pb.cu = cu;
  pb.P = (long long)k * nq; pb.n_in = n_in; pb.np = 2;
  pb.ke = 32; pb.n_hidden = n_hidden; pb.act = act;
  pb.nq = nq; pb.has_react = cu != nullptr;
  return pb;
}

// act: 0 tanh, 1 sigmoid, 2 sin (VJ_ACT_SIN).
bool bad(long long P, int n_in, int ke, int n_hidden, int act) {
  return P < 0 || n_in < 1 || n_in > FF_MAX_IN || ke < 32 || ke > 256 || ke % 32 ||
         n_hidden < 1 || act < 0 || act > VJ_ACT_SIN;
}

bool bad_jac(int k, int nq, int n_in, int d, int n_hidden, int act) {
  return bad((long long)k * nq, n_in, 32, n_hidden, act) || nq < 1 || d < 1 || d > n_in;
}

}  // namespace

extern "C" {

// Packed parameter count (floats): hidden width hp, embedding width ke, n_hidden layers.
int ff_n_params_c(int hp, int ke, int n_hidden) { return ff_n_params(hp, ke, n_hidden); }

#ifdef FF_PHASE_CLOCK
// The phase cycles of the tanh / sigmoid kernels summed since the last call (out
// [2][FF_NPHASE]: forward, backward), then zeroed; n_phase receives FF_NPHASE.
int ff_phase_ticks_read(unsigned long long* out, int* n_phase) {
  *n_phase = FF_NPHASE;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, ff_phase_ticks, sizeof(ff_phase_ticks));
  static const unsigned long long zero[2][FF_NPHASE] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ff_phase_ticks, zero, sizeof(zero));
  return (int)e;
}
#endif

// The launch shape of the stacked forward (kind 0) or backward (kind 1) for np panels
// (K2-FF, wide K4: 2; K7, K3: 1 + n_in), or of K8 (kind 2, np = 1 + n_in), of activation
// act, on the current device: threads per block, blocks resident per SM, blocks of the
// launch, and whether the backward takes its wgmma engine (0 for the other kinds).
int ff_launch_shape(int kind, int np, long long P, int ke, int n_hidden, int hp, int act,
                    int* threads, int* per_sm, int* blocks, int* wgmma) {
  if (kind < 0 || kind > 2 || np < 2 || np > 1 + FF_MAX_IN || bad(P, 1, ke, n_hidden, act))
    return (int)cudaErrorInvalidValue;
  FfProblem pb = {};
  pb.np = np; pb.P = P; pb.ke = ke; pb.n_hidden = n_hidden; pb.act = act;
  return FF_HOST(act, shape(hp, kind, pb, threads, per_sm, blocks, wgmma));
}

// K7 forward: out [1 + n_in][P] = (u, du/dxs) at the scaled points xs [n_in][P].
// Returns a cudaError_t value, or VJ_DOES_NOT_FIT (as every launcher below).
int ff_vj_fwd(const float* xs, const float* bt, const float* params, float* out, long long P,
              int n_in, int ke, int n_hidden, int hp, int act, void* stream) {
  if (bad(P, n_in, ke, n_hidden, act)) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const FfProblem pb = vj_problem(xs, bt, P, n_in, ke, n_hidden, act);
  return FF_HOST(act, fwd(hp, pb, params, out, (cudaStream_t)stream));
}

// K8: dout [1 + n_in][P], the tangent of out along the packed parameter tangent dparams.
int ff_vj_jvp(const float* xs, const float* bt, const float* params, const float* dparams,
              float* dout, long long P, int n_in, int ke, int n_hidden, int hp, int act,
              void* stream) {
  if (bad(P, n_in, ke, n_hidden, act)) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const FfProblem pb = vj_problem(xs, bt, P, n_in, ke, n_hidden, act);
  return FF_HOST(act, jvp(hp, pb, params, dparams, dout, (cudaStream_t)stream));
}

// Number of K7 backward blocks (rows of the partials buffer) on the current device.
int ff_vj_bwd_blocks(long long P, int n_in, int ke, int n_hidden, int hp, int act,
                     int* blocks) {
  if (bad(P, n_in, ke, n_hidden, act)) return (int)cudaErrorInvalidValue;
  const FfProblem pb = vj_problem(nullptr, nullptr, P, n_in, ke, n_hidden, act);
  return FF_HOST(act, bwd_blocks(hp, pb, blocks));
}

// K7 backward: packed gradient grad of <g, out> for the cotangent g [1 + n_in][P];
// partials is workspace of n_blocks * n_params floats; wgmma receives whether the launch
// took the wgmma engine (as every backward below).
int ff_vj_bwd(const float* xs, const float* bt, const float* params, const float* g,
              float* partials, int n_blocks, float* grad, long long P, int n_in, int ke,
              int n_hidden, int hp, int act, void* stream, int* wgmma) {
  if (bad(P, n_in, ke, n_hidden, act)) return (int)cudaErrorInvalidValue;
  const FfProblem pb = vj_problem(xs, bt, P, n_in, ke, n_hidden, act);
  return launch_bwd(hp, pb, params, g, partials, n_blocks, grad, (cudaStream_t)stream, wgmma);
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
  return launch_res_fwd(hp, pb, params, contrib, r, (cudaStream_t)stream);
}

// Number of K2-FF backward blocks on the current device.
int ff_res_bwd_blocks(int k, int nq, int d, int ke, int n_hidden, int hp, int act,
                      int* blocks) {
  if (bad((long long)k * nq, 1, ke, n_hidden, act)) return (int)cudaErrorInvalidValue;
  const FfProblem pb = res_problem(nullptr, nullptr, nullptr, nullptr, nullptr, k, nq, 1, d, 0,
                                   0, ke, n_hidden, act);
  return FF_HOST(act, bwd_blocks(hp, pb, blocks));
}

// K2-FF backward: packed gradient grad for the cotangent gr [k] of r.
int ff_res_bwd(const float* xs, const float* flds, const float* tab, const float* scale,
               const float* bt, const float* params, const float* gr, float* partials,
               int n_blocks, float* grad, int k, int nq, int n_in, int d, int td, int has_react,
               int ke, int n_hidden, int hp, int act, void* stream, int* wgmma) {
  if (bad((long long)k * nq, n_in, ke, n_hidden, act) || nq < 1)
    return (int)cudaErrorInvalidValue;
  const FfProblem pb = res_problem(xs, flds, tab, scale, bt, k, nq, n_in, d, td, has_react, ke,
                                   n_hidden, act);
  return launch_bwd(hp, pb, params, gr, partials, n_blocks, grad, (cudaStream_t)stream, wgmma);
}

// K4 forward for a plain net of hidden width 65..256: r [k] from the precomputed
// coefficients cdir [n_in][P], csrc [P] and cu [P] (or null); contrib is workspace of
// k * nq floats.
int ff_pre_fwd(const float* xs, const float* cdir, const float* csrc, const float* cu,
               const float* params, float* contrib, float* r, int k, int nq, int n_in,
               int n_hidden, int hp, int act, void* stream) {
  if (bad((long long)k * nq, n_in, 32, n_hidden, act) || nq < 1)
    return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  const FfProblem pb = pre_problem(xs, cdir, csrc, cu, k, nq, n_in, n_hidden, act);
  return launch_res_fwd(hp, pb, params, contrib, r, (cudaStream_t)stream);
}

// Number of its backward blocks on the current device.
int ff_pre_bwd_blocks(int k, int nq, int n_hidden, int hp, int act, int* blocks) {
  if (bad((long long)k * nq, 1, 32, n_hidden, act)) return (int)cudaErrorInvalidValue;
  const FfProblem pb = pre_problem(nullptr, nullptr, nullptr, nullptr, k, nq, 1, n_hidden, act);
  return FF_HOST(act, bwd_blocks(hp, pb, blocks));
}

// Its backward: packed gradient grad for the cotangent gr [k] of r.
int ff_pre_bwd(const float* xs, const float* cdir, const float* csrc, const float* cu,
               const float* params, const float* gr, float* partials, int n_blocks, float* grad,
               int k, int nq, int n_in, int n_hidden, int hp, int act, void* stream,
               int* wgmma) {
  if (bad((long long)k * nq, n_in, 32, n_hidden, act) || nq < 1)
    return (int)cudaErrorInvalidValue;
  const FfProblem pb = pre_problem(xs, cdir, csrc, cu, k, nq, n_in, n_hidden, act);
  return launch_bwd(hp, pb, params, gr, partials, n_blocks, grad, (cudaStream_t)stream, wgmma);
}

// K3 forward: r [k] of the jacobian-panel weak form of a plain net (nl [d]: the Burgers
// direction, or null); contrib is workspace of k * nq floats.
int ff_jac_fwd(const float* xs, const float* flds, const float* tab, const float* scale,
               const float* nl, const float* params, float* contrib, float* r, int k, int nq,
               int n_in, int d, int td, int has_react, int n_hidden, int hp, int act,
               void* stream) {
  if (bad_jac(k, nq, n_in, d, n_hidden, act)) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  FfProblem pb = res_problem(xs, flds, tab, scale, nullptr, k, nq, n_in, d, td, has_react, 32,
                             n_hidden, act, FF_JAC);
  pb.nl = nl;
  return launch_res_fwd(hp, pb, params, contrib, r, (cudaStream_t)stream);
}

// Number of K3 backward blocks on the current device.
int ff_jac_bwd_blocks(int k, int nq, int n_in, int d, int n_hidden, int hp, int act,
                      int* blocks) {
  if (bad_jac(k, nq, n_in, d, n_hidden, act)) return (int)cudaErrorInvalidValue;
  const FfProblem pb = res_problem(nullptr, nullptr, nullptr, nullptr, nullptr, k, nq, n_in, d,
                                   0, 0, 32, n_hidden, act, FF_JAC);
  return FF_HOST(act, bwd_blocks(hp, pb, blocks));
}

// K3 backward: packed gradient grad for the cotangent gr [k] of r.
int ff_jac_bwd(const float* xs, const float* flds, const float* tab, const float* scale,
               const float* nl, const float* params, const float* gr, float* partials,
               int n_blocks, float* grad, int k, int nq, int n_in, int d, int td, int has_react,
               int n_hidden, int hp, int act, void* stream, int* wgmma) {
  if (bad_jac(k, nq, n_in, d, n_hidden, act)) return (int)cudaErrorInvalidValue;
  FfProblem pb = res_problem(xs, flds, tab, scale, nullptr, k, nq, n_in, d, td, has_react, 32,
                             n_hidden, act, FF_JAC);
  pb.nl = nl;
  return launch_bwd(hp, pb, params, gr, partials, n_blocks, grad, (cudaStream_t)stream, wgmma);
}

}  // extern "C"
