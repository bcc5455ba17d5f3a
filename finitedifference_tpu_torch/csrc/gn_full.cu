// Full-grid LSPG Gauss-Newton system, written by hand for Hopper (sm_90a).
//
// Replaces finitedifference_tpu/ops/pallas_gn_full.py::_make_full_kernel
// (reached through gn_full_first_pallas / gn_full_system_pallas, the
// engine rom_factored.pallas_prom). One call computes, for reduced
// coordinates y and the padded basis halves Vu, Vv (n_pad, kp) in the
// dead-cell row layout (ops/gn_full.py):
//   u_s = Vu y, v_s = Vv y at every padded cell i; their west (flat i - 1)
//   and south (flat i - nxp) neighbours, zero before the first row;
//   the CN residual ru, rv with the step constant cp, where first != 0
//   derives cp = ((-u_s + flux_u - slbc) * mask, (-v_s + flux_v) * mask)
//   from y's scalars and writes it out, and first == 0 reads it;
//   the rows A_u[i] = mask_i [J_u V | ru]_i, A_v[i] = mask_i [J_v V | rv]_i
//   over lanes 0..k (k1p wide, zero above k);
//   gext = sum_i A_u[i]^T A_u[i] + A_v[i]^T A_v[i] as (kp, kp) float64.
// It runs as the four passes of gn_common.cuh.
//
// What bounds it: the Gram is a tall-skinny SYRK, ~2 * 2 n_pad * k1p^2
// flops (750^2, 95 modes: 1.13 M rows, ~28 GFLOP with the upper 64x64
// blocks that 96 live lanes need), so FP32 FMA throughput bounds it; the
// bytes are ~0.4 GB for the GEMV, ~0.6 GB to write and ~1 GB to read back
// the rows, ~0.5 ms at HBM speed.
//
// How the design answers it:
//  * the TPU kernel carried the previous tile's last grid row (the south
//    halo) in VMEM scratch across a grid that runs in order. Here the
//    scalars come from a first GEMV pass over all rows, so the rows pass
//    reads any neighbour's scalars and basis row straight from global
//    memory (L2 serves the re-reads) and every block is independent;
//  * the dead-cell layout stays: a dead row tail is the west zero ghost of
//    the next row's inflow column, and the full-length mask zeroes the dead
//    column tail AND the dead bottom rows, whose real south neighbour
//    would put +14% into ||r||^2 at 250^2;
//  * the Gram skips the lanes above k (zero by construction): only the
//    upper 64x64 blocks of the k1p = round_up(k+1, 64) live lanes run,
//    with FFMA/DFMA in registers, never tensor cores (so never TF32);
//  * per-chunk partials are summed in float64 by a last pass.

#include <cuda_runtime.h>

#include "gn_common.cuh"

namespace {

using fdgn::kBlock;

template <typename T, bool FIRST>
__global__ void __launch_bounds__(kBlock)
full_rows_kernel(const T* __restrict__ vu, const T* __restrict__ vv, int kp,
                 const T* __restrict__ su, const T* __restrict__ sv,
                 const T* __restrict__ aux, const T* __restrict__ dmask,
                 T* __restrict__ cp_out, T* __restrict__ a, long long n_pad,
                 int k1p, int k, int nxp, T hdx, T hdy) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= n_pad * k1p) return;
  const long long i = e / k1p;
  const int l = static_cast<int>(e % k1p);
  const T zero = T(0), one = T(1);
  const T qdx = T(0.5) * hdx, qdy = T(0.5) * hdy;
  const bool has_w = i >= 1, has_s = i >= nxp;
  const T u_s = su[i], v_s = sv[i];
  const T u_w = has_w ? su[i - 1] : zero, v_w = has_w ? sv[i - 1] : zero;
  const T u_so = has_s ? su[i - nxp] : zero;
  const T v_so = has_s ? sv[i - nxp] : zero;
  const T m = dmask[i];

  const T fuv = u_s * v_s;
  const T ru_f = qdx * (u_s * u_s - u_w * u_w) + qdy * (fuv - u_so * v_so);
  const T rv_f = qdy * (v_s * v_s - v_so * v_so) + qdx * (fuv - u_w * v_w);
  T cp_u, cp_v;
  if (FIRST) {
    cp_u = (-u_s + ru_f - aux[i]) * m;
    cp_v = (-v_s + rv_f) * m;
    if (l == 0) {
      cp_out[2 * i] = cp_u;
      cp_out[2 * i + 1] = cp_v;
    }
  } else {
    cp_u = aux[2 * i];
    cp_v = aux[2 * i + 1];
  }

  T au = zero, av = zero;
  if (l < k) {
    const long long o = i * kp + l;
    const T bu = vu[o], bv = vv[o];
    const T bu_w = has_w ? vu[o - kp] : zero;
    const T bv_w = has_w ? vv[o - kp] : zero;
    const T bu_so = has_s ? vu[o - static_cast<long long>(nxp) * kp] : zero;
    const T bv_so = has_s ? vv[o - static_cast<long long>(nxp) * kp] : zero;
    au = (one + hdx * u_s + qdy * v_s) * bu + (-hdx * u_w) * bu_w +
         (-qdy * v_so) * bu_so + (qdy * u_s) * bv + (-qdy * u_so) * bv_so;
    av = (qdx * v_s) * bu + (-qdx * v_w) * bu_w +
         (one + hdy * v_s + qdx * u_s) * bv + (-qdx * u_w) * bv_w +
         (-hdy * v_so) * bv_so;
  } else if (l == k) {
    au = u_s + ru_f + cp_u;
    av = v_s + rv_f + cp_v;
  }
  a[i * k1p + l] = au * m;
  a[(n_pad + i) * k1p + l] = av * m;
}

template <typename T>
int gn_full(const void* vu_, const void* vv_, const void* y_,
            const void* aux_, const void* dmask_, void* cp_out_, void* s_,
            void* a_, void* partials_, void* gext_, int n_pad, int kp, int k,
            int k1p, int nxp, int first, T hdx, T hdy, int rpc, int n_chunks,
            void* stream) {
  const auto* vu = static_cast<const T*>(vu_);
  const auto* vv = static_cast<const T*>(vv_);
  const auto* y = static_cast<const T*>(y_);
  const auto* aux = static_cast<const T*>(aux_);
  const auto* dmask = static_cast<const T*>(dmask_);
  auto* cp_out = static_cast<T*>(cp_out_);
  auto* s = static_cast<T*>(s_);
  auto* a = static_cast<T*>(a_);
  auto* partials = static_cast<T*>(partials_);
  auto* gext = static_cast<double*>(gext_);
  auto st = static_cast<cudaStream_t>(stream);

  cudaError_t err = fdgn::rows_dot<T>(vu, y, s, n_pad, kp, k, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fdgn::rows_dot<T>(vv, y, s + n_pad, n_pad, kp, k, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long elems = static_cast<long long>(n_pad) * k1p;
  const unsigned blocks =
      static_cast<unsigned>((elems + kBlock - 1) / kBlock);
  if (first) {
    full_rows_kernel<T, true><<<blocks, kBlock, 0, st>>>(
        vu, vv, kp, s, s + n_pad, aux, dmask, cp_out, a, n_pad, k1p, k, nxp,
        hdx, hdy);
  } else {
    full_rows_kernel<T, false><<<blocks, kBlock, 0, st>>>(
        vu, vv, kp, s, s + n_pad, aux, dmask, cp_out, a, n_pad, k1p, k, nxp,
        hdx, hdy);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = fdgn::gram_partials<T>(a, 2LL * n_pad, k1p, rpc, n_chunks, partials,
                               st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      fdgn::reduce_partials<T, double>(partials, n_chunks, k1p, gext, kp, st));
}

}  // namespace

extern "C" {

// One full-grid system on padded CUDA buffers (ops/cuda_gn_full.py sizes
// them): s (2 n_pad), a (2 n_pad, k1p), partials (n_chunks, k1p, k1p) are
// scratch; gext (kp, kp) float64 and, when first != 0, cp_out (n_pad, 2)
// are written. Launches on `stream` without synchronising; returns the
// first cudaError_t of its launches (0 on success).
int fd_gn_full_f32(const void* vu, const void* vv, const void* y,
                   const void* aux, const void* dmask, void* cp_out, void* s,
                   void* a, void* partials, void* gext, int n_pad, int kp,
                   int k, int k1p, int nxp, int first, float hdx, float hdy,
                   int rpc, int n_chunks, void* stream) {
  return gn_full<float>(vu, vv, y, aux, dmask, cp_out, s, a, partials, gext,
                        n_pad, kp, k, k1p, nxp, first, hdx, hdy, rpc,
                        n_chunks, stream);
}

int fd_gn_full_f64(const void* vu, const void* vv, const void* y,
                   const void* aux, const void* dmask, void* cp_out, void* s,
                   void* a, void* partials, void* gext, int n_pad, int kp,
                   int k, int k1p, int nxp, int first, double hdx,
                   double hdy, int rpc, int n_chunks, void* stream) {
  return gn_full<double>(vu, vv, y, aux, dmask, cp_out, s, a, partials, gext,
                         n_pad, kp, k, k1p, nxp, first, hdx, hdy, rpc,
                         n_chunks, stream);
}

}  // extern "C"
