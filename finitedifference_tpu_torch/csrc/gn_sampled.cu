// Sampled-mesh (ECSW) Gauss-Newton system and fused step, written by hand
// for Hopper (sm_90a).
//
// fd_gn_sampled_system_* replaces
// finitedifference_tpu/ops/pallas_gn.py::_make_kernel (gn_system_pallas):
// from the six stencil-position basis blocks p6 (6, n_p, kp) of the
// factored HPROM (rom_factored.py), reduced coordinates y, the step
// constants cp (n_p, 2) and the ECSW weights w (n_p), it computes the
// scalars s_p = p6[p] y, the CN residual, the weighted rows
//   A_u[i] = [w_i (J_u V)_i | w_i ru_i],  A_v[i] = [w_i (J_v V)_i | w_i rv_i]
// and gext = sum_i A_u[i]^T A_u[i] + A_v[i]^T A_v[i] (kp, kp): the Gram,
// J^T W^2 r and ||W r||^2. Padded cells carry weight 0 and vanish.
//
// fd_gn_sampled_step_* replaces pallas_gn.py::_make_step_kernel
// (gn_step_pallas, the engine pallas_hprom(ls_method="fused")): the same
// system, then `iters` masked conjugate-gradient steps on
// gext[:k, :k] dy = -gext[:k, k] (row and column k masked out, iterate
// frozen once the residual or the curvature falls below the smallest
// normal number), writing out[0, :] = dy and out[1, 0] = ||W r||.
//
// What bounds it: nothing the card finds large. On the 250^2 synthetic mesh
// (n_s 1508, n_p 1536, 95 modes) a call moves ~4.7 MB of blocks and does
// ~57 MFLOP, a few microseconds of bandwidth or FMA; the launches and
// their dependencies set the pace.
//
// How the design answers it:
//  * the TPU kernel summed its tiles in one VMEM scratch across a grid that
//    runs in order. Here the four passes of gn_common.cuh run with small
//    row chunks (32 rows), so ~100 CTAs share the Gram and a float64
//    reduction pass sums their partials;
//  * the CG needs the whole Gram, so it cannot ride in the partial-Gram
//    CTAs: the step runs a fifth pass, ONE CTA of 256 threads (one per
//    lane, k <= 255) that reads the reduced float64 Gram through L1 and
//    iterates with block-wide sums. A second kernel was chosen over a
//    last-block-done epilogue (threadfence + atomic counter): it keeps the
//    partial-Gram pass free of grid-wide ordering, and costs one launch on
//    the same stream, no host round trip.

#include <cuda_runtime.h>

#include "gn_common.cuh"

namespace {

using fdgn::kBlock;

template <typename T>
__global__ void __launch_bounds__(kBlock)
sampled_rows_kernel(const T* __restrict__ p6, int kp,
                    const T* __restrict__ s, const T* __restrict__ cp,
                    const T* __restrict__ wgt, T* __restrict__ a,
                    long long n_p, int k1p, int k, T hdx, T hdy) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= n_p * k1p) return;
  const long long i = e / k1p;
  const int l = static_cast<int>(e % k1p);
  const T zero = T(0), one = T(1);
  const T qdx = T(0.5) * hdx, qdy = T(0.5) * hdy;
  const T u_s = s[i], u_w = s[n_p + i], u_so = s[2 * n_p + i];
  const T v_s = s[3 * n_p + i], v_w = s[4 * n_p + i], v_so = s[5 * n_p + i];
  const T w = wgt[i];

  T au = zero, av = zero;
  if (l < k) {
    const long long o = i * kp + l;
    const long long blk = n_p * kp;
    const T b0 = p6[o], b1 = p6[blk + o], b2 = p6[2 * blk + o];
    const T b3 = p6[3 * blk + o], b4 = p6[4 * blk + o], b5 = p6[5 * blk + o];
    au = ((one + hdx * u_s + qdy * v_s) * w) * b0 + ((-hdx * u_w) * w) * b1 +
         ((-qdy * v_so) * w) * b2 + ((qdy * u_s) * w) * b3 +
         ((-qdy * u_so) * w) * b5;
    av = ((qdx * v_s) * w) * b0 + ((-qdx * v_w) * w) * b1 +
         ((one + hdy * v_s + qdx * u_s) * w) * b3 + ((-qdx * u_w) * w) * b4 +
         ((-hdy * v_so) * w) * b5;
  } else if (l == k) {
    const T fuv = u_s * v_s;
    const T ru = u_s + qdx * (u_s * u_s - u_w * u_w) +
                 qdy * (fuv - u_so * v_so) + cp[2 * i];
    const T rv = v_s + qdy * (v_s * v_s - v_so * v_so) +
                 qdx * (fuv - u_w * v_w) + cp[2 * i + 1];
    au = ru * w;
    av = rv * w;
  }
  a[i * k1p + l] = au;
  a[(n_p + i) * k1p + l] = av;
}

// One CTA: masked CG on the reduced Gram g (ldg x ldg, float64, symmetric),
// in T. Thread i owns lane i; k < kBlock, ldo <= kBlock.
template <typename T>
__global__ void __launch_bounds__(kBlock)
cg_kernel(const double* __restrict__ g, int ldg, int k, int iters,
          T* __restrict__ out, int ldo) {
  __shared__ T p[kBlock];
  __shared__ T red[kBlock / 32];
  const int i = threadIdx.x;
  const T x = fdgn::masked_cg<T, double>(g, ldg, k, iters, p, red);
  if (i < ldo) {
    out[i] = x;
    out[ldo + i] =
        i == 0 ? sqrt(static_cast<T>(g[static_cast<long long>(k) * ldg + k]))
               : T(0);
  }
}

template <typename T>
cudaError_t sampled_system(const T* p6, const T* y, const T* cp,
                           const T* wgt, T* s, T* a, T* partials, int n_p,
                           int kp, int k, int k1p, T hdx, T hdy, int rpc,
                           int n_chunks, cudaStream_t st) {
  cudaError_t err = fdgn::rows_dot<T>(p6, y, s, 6LL * n_p, kp, k, st);
  if (err != cudaSuccess) return err;
  const long long elems = static_cast<long long>(n_p) * k1p;
  const unsigned blocks =
      static_cast<unsigned>((elems + kBlock - 1) / kBlock);
  sampled_rows_kernel<T><<<blocks, kBlock, 0, st>>>(p6, kp, s, cp, wgt, a,
                                                     n_p, k1p, k, hdx, hdy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fdgn::gram_partials<T>(a, 2LL * n_p, k1p, rpc, n_chunks, partials,
                                st);
}

template <typename T>
int gn_sampled_system(const void* p6, const void* y, const void* cp,
                      const void* wgt, void* s, void* a, void* partials,
                      void* gext, int n_p, int kp, int k, int k1p, T hdx,
                      T hdy, int rpc, int n_chunks, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<T*>(partials);
  cudaError_t err = sampled_system<T>(
      static_cast<const T*>(p6), static_cast<const T*>(y),
      static_cast<const T*>(cp), static_cast<const T*>(wgt),
      static_cast<T*>(s), static_cast<T*>(a), part, n_p, kp, k, k1p, hdx,
      hdy, rpc, n_chunks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fdgn::reduce_partials<T, T>(
      part, n_chunks, k1p, static_cast<T*>(gext), kp, st));
}

template <typename T>
int gn_sampled_step(const void* p6, const void* y, const void* cp,
                    const void* wgt, void* s, void* a, void* partials,
                    void* gram, void* out, int n_p, int kp, int k, int k1p,
                    T hdx, T hdy, int rpc, int n_chunks, int iters,
                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<T*>(partials);
  auto* g = static_cast<double*>(gram);
  cudaError_t err = sampled_system<T>(
      static_cast<const T*>(p6), static_cast<const T*>(y),
      static_cast<const T*>(cp), static_cast<const T*>(wgt),
      static_cast<T*>(s), static_cast<T*>(a), part, n_p, kp, k, k1p, hdx,
      hdy, rpc, n_chunks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fdgn::reduce_partials<T, double>(part, n_chunks, k1p, g, kp, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  cg_kernel<T><<<1, kBlock, 0, st>>>(g, kp, k, iters, static_cast<T*>(out),
                                     kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The weighted sampled system into gext (kp, kp) in the working type; s
// (6 n_p), a (2 n_p, k1p) and partials (n_chunks, k1p, k1p) are scratch
// sized by ops/cuda_gn.py. Launches on `stream` without synchronising;
// returns the first cudaError_t of its launches (0 on success).
int fd_gn_sampled_system_f32(const void* p6, const void* y, const void* cp,
                             const void* wgt, void* s, void* a,
                             void* partials, void* gext, int n_p, int kp,
                             int k, int k1p, float hdx, float hdy, int rpc,
                             int n_chunks, void* stream) {
  return gn_sampled_system<float>(p6, y, cp, wgt, s, a, partials, gext, n_p,
                                  kp, k, k1p, hdx, hdy, rpc, n_chunks,
                                  stream);
}

int fd_gn_sampled_system_f64(const void* p6, const void* y, const void* cp,
                             const void* wgt, void* s, void* a,
                             void* partials, void* gext, int n_p, int kp,
                             int k, int k1p, double hdx, double hdy, int rpc,
                             int n_chunks, void* stream) {
  return gn_sampled_system<double>(p6, y, cp, wgt, s, a, partials, gext, n_p,
                                   kp, k, k1p, hdx, hdy, rpc, n_chunks,
                                   stream);
}

// The same system, reduced into gram (kp, kp) float64 scratch, then the CG:
// out (2, kp) gets dy in row 0 and ||W r|| in row 1, lane 0.
int fd_gn_sampled_step_f32(const void* p6, const void* y, const void* cp,
                           const void* wgt, void* s, void* a, void* partials,
                           void* gram, void* out, int n_p, int kp, int k,
                           int k1p, float hdx, float hdy, int rpc,
                           int n_chunks, int iters, void* stream) {
  return gn_sampled_step<float>(p6, y, cp, wgt, s, a, partials, gram, out,
                                n_p, kp, k, k1p, hdx, hdy, rpc, n_chunks,
                                iters, stream);
}

int fd_gn_sampled_step_f64(const void* p6, const void* y, const void* cp,
                           const void* wgt, void* s, void* a, void* partials,
                           void* gram, void* out, int n_p, int kp, int k,
                           int k1p, double hdx, double hdy, int rpc,
                           int n_chunks, int iters, void* stream) {
  return gn_sampled_step<double>(p6, y, cp, wgt, s, a, partials, gram, out,
                                 n_p, kp, k, k1p, hdx, hdy, rpc, n_chunks,
                                 iters, stream);
}

}  // extern "C"
