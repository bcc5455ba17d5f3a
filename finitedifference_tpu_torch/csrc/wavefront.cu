// Exact wavefront triangular solve of the CN/upwind Burgers Jacobian,
// written by hand for Hopper (sm_90a).
//
// Replaces finitedifference_tpu/ops/pallas_wavefront.py::_make_kernel_reg
// (the skewed-layout solve of the Newton loop). The unskewed entry point
// (pallas_wavefront.py::_make_kernel behind solve_jacobian_wavefront_pallas)
// is the same function with skew/unskew around it, so it runs this kernel
// too (ops/wavefront.py).
//
// Inputs are padded skewed fields S[d, r] = X[r, d - r] of shape
// (nd_pad, ny_pad), row-major. Cell (d, r) is on the band when r < ny,
// r <= d and d - r < nx. For each band cell, with the 2x2 block
//   B = [[1 + kx u + ky/2 v,  ky/2 u         ],
//        [kx/2 v,             1 + ky v + kx/2 u]]
// (u, v at (d, r)),
//   rhs_u = fu + kx uW duW + ky/2 (vS duS + uS dvS)
//   rhs_v = fv + kx/2 (vW duW + uW dvW) + ky vS dvS
//   [du, dv] = B^{-1} [rhs_u, rhs_v]
// where W is (d-1, r) and S is (d-1, r-1); the carry before diagonal 0 and
// the south neighbour of row 0 are zero. Every cell off the band, on padded
// diagonals d >= nx+ny-1 and on padded rows r >= ny, is written as exactly 0:
// the skewed Newton update u - du relies on it to keep the padding at zero.
//
// What bounds it: latency. The solve is a chain of nd_pad (~2N-1) dependent
// steps, because diagonal d needs diagonal d-1. Each step is ~25 flops on
// each of ny_pad rows; at 750^2 that is ~30 MFLOP and ~56 MB of f64 traffic
// in all, which the card would stream in tens of microseconds. What costs
// is 1536 steps in sequence, each a shared-memory exchange and a block
// barrier, on 1 of the card's 132 SMs.
//
// How the design answers it:
//  * one CTA per system walks all diagonals in a loop. The TPU kernel
//    carried the previous diagonal across sequential grid steps; CUDA
//    blocks run in no order, so the chain never leaves the CTA;
//  * one thread per skewed row r up to ny_pad = 1024; above that each of at
//    most 512 threads owns RPT = 4 or 8 rows (strided by blockDim), so any
//    ny_pad up to 4096 works. The west carry (d-1, r) stays in the thread's
//    registers;
//  * the south carry (d-1, r-1) comes from a double-buffered shared array
//    of the four carries (du, dv, u, v), so one __syncthreads() per
//    diagonal orders every exchange;
//  * the block inverse depends only on u_d, v_d, not on the carry, so it is
//    formed off the chain, and the next diagonal's four inputs are loaded
//    into registers before the barrier, so their global-memory latency
//    overlaps the current step;
//  * a thread with several rows makes every read of a diagonal before any
//    write, so its rows' chains overlap instead of queueing behind the
//    compiler's aliasing of the shared-memory stores.
// Measured on an H100 SXM (700 W) at 750^2 (PERF.md): one thread per row
// runs in half the time of two rows per thread; a two-diagonal prefetch and
// a reciprocal intrinsic gained nothing.
//
// fd_wavefront_solve_seg_* (B7) replaces
// finitedifference_tpu/ops/pallas_wavefront.py::_make_kernel_seg, the
// overlapping-segment approximate solve behind `seg > 0`. The chain is cut
// into n_seg segments of seg_len = ceil(nd_pad / n_seg) diagonals; segment g
// owns diagonals [g*seg_len, (g+1)*seg_len) and starts from a zero carry at
// diagonal g*seg_len - overlap, so the coupling between diagonals, which is
// contractive (rho ~ CFL / (1 + CFL)), leaves a truncation error ~rho^overlap
// at its first owned diagonal; segment 0 is exact. Warm-up diagonals are
// computed and not written.
//
// What bounds it: the same latency as B1, now a chain of seg_len + overlap
// steps (256 instead of 1536 at 750^2 with n_seg = 8, overlap = 64) that
// runs on n_seg SMs at once; the bytes (each input diagonal read by at most
// two segments) stay far below the card's rate.
//
// How the design answers it: the TPU kernel packed the segments into
// (j_pad, n_seg, ny_pad) slabs to fill its sublanes; here each segment is
// one CTA running B1's per-diagonal step on the (nd_pad, ny_pad) arrays as
// they are, so no pack or unpack copy is needed. Both are one kernel
// template; B1 is its SEG = false instance, compiled without the segment
// bounds, so the exact solve keeps its own code.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreadsOneRow = 1024;   // RPT == 1
constexpr int kMaxThreadsRows = 512;      // RPT > 1: room for 128 registers
constexpr size_t kDefaultSmem = 48 * 1024;

// SEG = false is B1: one CTA, the whole chain, every diagonal written.
template <typename T, int RPT, bool SEG>
__global__ void __launch_bounds__(RPT == 1 ? kMaxThreadsOneRow
                                           : kMaxThreadsRows)
wavefront_kernel(const T* __restrict__ su, const T* __restrict__ sv,
                 const T* __restrict__ sfu, const T* __restrict__ sfv,
                 T* __restrict__ sdu, T* __restrict__ sdv,
                 int nx, int ny, int nd_pad, int ny_pad, T kx, T ky,
                 int seg_len, int overlap) {
  // [2 buffers][4 carries: du, dv, u, v][ny_pad]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* carry = reinterpret_cast<T*>(smem_raw);

  const T one = T(1);
  const T half = T(0.5);
  const T zero = T(0);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  // this CTA's segment: owned diagonals [d_own, d_end), warm-up from d_begin
  const int d_own = SEG ? blockIdx.x * seg_len : 0;
  const int d_begin = SEG && d_own - overlap > 0 ? d_own - overlap : 0;
  const int d_end =
      SEG && d_own + seg_len < nd_pad ? d_own + seg_len : nd_pad;
  if (SEG && d_own >= d_end) return;   // a trailing segment owns nothing

  T du_p[RPT], dv_p[RPT], u_p[RPT], v_p[RPT];   // diagonal d-1, own rows
  T u_n[RPT], v_n[RPT], fu_n[RPT], fv_n[RPT];   // prefetched diagonal d

  // the buffer of diagonal d_begin - 1 holds the zero carry
  for (int i = tid; i < 4 * ny_pad; i += nthreads) {
    carry[((d_begin + 1) & 1) * 4 * ny_pad + i] = zero;
  }
  const size_t first = static_cast<size_t>(d_begin) * ny_pad;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = tid + j * nthreads;
    du_p[j] = dv_p[j] = u_p[j] = v_p[j] = zero;
    u_n[j] = v_n[j] = fu_n[j] = fv_n[j] = zero;
    if (r < ny_pad) {
      u_n[j] = su[first + r];
      v_n[j] = sv[first + r];
      fu_n[j] = sfu[first + r];
      fv_n[j] = sfv[first + r];
    }
  }
  __syncthreads();

  for (int d = d_begin; d < d_end; ++d) {
    const T* prev = carry + ((d + 1) & 1) * 4 * ny_pad;
    T* cur = carry + (d & 1) * 4 * ny_pad;
    const size_t row = static_cast<size_t>(d) * ny_pad;
    const size_t next = row + ny_pad;

    T u[RPT], v[RPT], fu[RPT], fv[RPT];
    T du_s[RPT], dv_s[RPT], u_s[RPT], v_s[RPT];   // south: (d-1, r-1)
    // every read of this diagonal before any write
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = tid + j * nthreads;
      u[j] = u_n[j];
      v[j] = v_n[j];
      fu[j] = fu_n[j];
      fv[j] = fv_n[j];
      du_s[j] = dv_s[j] = u_s[j] = v_s[j] = zero;
      if (r < ny_pad) {
        if (d + 1 < d_end) {
          u_n[j] = su[next + r];
          v_n[j] = sv[next + r];
          fu_n[j] = sfu[next + r];
          fv_n[j] = sfv[next + r];
        }
        if (r > 0) {
          du_s[j] = prev[r - 1];
          dv_s[j] = prev[ny_pad + r - 1];
          u_s[j] = prev[2 * ny_pad + r - 1];
          v_s[j] = prev[3 * ny_pad + r - 1];
        }
      }
    }

#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = tid + j * nthreads;
      if (r >= ny_pad) continue;
      T du = zero;
      T dv = zero;
      if (r < ny && r <= d && d - r < nx) {
        const T b11 = one + kx * u[j] + half * ky * v[j];
        const T b12 = half * ky * u[j];
        const T b21 = half * kx * v[j];
        const T b22 = one + ky * v[j] + half * kx * u[j];
        const T inv_det = one / (b11 * b22 - b12 * b21);
        const T rhs_u = fu[j] + kx * u_p[j] * du_p[j]
            + half * ky * (v_s[j] * du_s[j] + u_s[j] * dv_s[j]);
        const T rhs_v = fv[j]
            + half * kx * (v_p[j] * du_p[j] + u_p[j] * dv_p[j])
            + ky * v_s[j] * dv_s[j];
        du = (b22 * rhs_u - b12 * rhs_v) * inv_det;
        dv = (b11 * rhs_v - b21 * rhs_u) * inv_det;
      }
      if (!SEG || d >= d_own) {
        sdu[row + r] = du;
        sdv[row + r] = dv;
      }
      cur[r] = du;
      cur[ny_pad + r] = dv;
      cur[2 * ny_pad + r] = u[j];
      cur[3 * ny_pad + r] = v[j];
      du_p[j] = du;
      dv_p[j] = dv;
      u_p[j] = u[j];
      v_p[j] = v[j];
    }
    __syncthreads();
  }
}

template <typename T, int RPT, bool SEG>
cudaError_t launch_rpt(const T* su, const T* sv, const T* sfu, const T* sfv,
                       T* sdu, T* sdv, int nx, int ny, int nd_pad, int ny_pad,
                       T kx, T ky, int n_seg, int seg_len, int overlap,
                       int threads, size_t smem, cudaStream_t stream) {
  auto kernel = wavefront_kernel<T, RPT, SEG>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_seg, threads, smem, stream>>>(su, sv, sfu, sfv, sdu, sdv, nx,
                                           ny, nd_pad, ny_pad, kx, ky,
                                           seg_len, overlap);
  return cudaGetLastError();
}

template <typename T, bool SEG>
int launch(const void* su, const void* sv, const void* sfu, const void* sfv,
           void* sdu, void* sdv, int nx, int ny, int nd_pad, int ny_pad,
           T kx, T ky, int n_seg, int overlap, void* stream) {
  if (nx < 1 || ny < 1 || ny > ny_pad || nd_pad < 1 || n_seg < 1 ||
      n_seg > nd_pad || overlap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int seg_len = (nd_pad + n_seg - 1) / n_seg;
  const int rpt = ny_pad <= kMaxThreadsOneRow       ? 1
                  : ny_pad <= 4 * kMaxThreadsRows   ? 4
                  : ny_pad <= 8 * kMaxThreadsRows   ? 8
                                                    : 0;
  if (rpt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((ny_pad + rpt - 1) / rpt + 31) / 32 * 32;
  const size_t smem = 8 * static_cast<size_t>(ny_pad) * sizeof(T);
  const auto* a = static_cast<const T*>(su);
  const auto* b = static_cast<const T*>(sv);
  const auto* c = static_cast<const T*>(sfu);
  const auto* e = static_cast<const T*>(sfv);
  auto* o1 = static_cast<T*>(sdu);
  auto* o2 = static_cast<T*>(sdv);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rpt) {
    case 1:
      err = launch_rpt<T, 1, SEG>(a, b, c, e, o1, o2, nx, ny, nd_pad,
                                  ny_pad, kx, ky, n_seg, seg_len, overlap,
                                  threads, smem, s);
      break;
    case 4:
      err = launch_rpt<T, 4, SEG>(a, b, c, e, o1, o2, nx, ny, nd_pad,
                                  ny_pad, kx, ky, n_seg, seg_len, overlap,
                                  threads, smem, s);
      break;
    default:
      err = launch_rpt<T, 8, SEG>(a, b, c, e, o1, o2, nx, ny, nd_pad,
                                  ny_pad, kx, ky, n_seg, seg_len, overlap,
                                  threads, smem, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Solve on one padded skewed system; launches on `stream` and does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
int fd_wavefront_solve_f32(const void* su, const void* sv, const void* sfu,
                           const void* sfv, void* sdu, void* sdv, int nx,
                           int ny, int nd_pad, int ny_pad, float kx, float ky,
                           void* stream) {
  return launch<float, false>(su, sv, sfu, sfv, sdu, sdv, nx, ny, nd_pad,
                              ny_pad, kx, ky, 1, 0, stream);
}

int fd_wavefront_solve_f64(const void* su, const void* sv, const void* sfu,
                           const void* sfv, void* sdu, void* sdv, int nx,
                           int ny, int nd_pad, int ny_pad, double kx,
                           double ky, void* stream) {
  return launch<double, false>(su, sv, sfu, sfv, sdu, sdv, nx, ny, nd_pad,
                               ny_pad, kx, ky, 1, 0, stream);
}

// The overlapping-segment solve: n_seg CTAs, each owning ceil(nd_pad /
// n_seg) diagonals after `overlap` warm-up diagonals from a zero carry.
int fd_wavefront_solve_seg_f32(const void* su, const void* sv,
                               const void* sfu, const void* sfv, void* sdu,
                               void* sdv, int nx, int ny, int nd_pad,
                               int ny_pad, float kx, float ky, int n_seg,
                               int overlap, void* stream) {
  return launch<float, true>(su, sv, sfu, sfv, sdu, sdv, nx, ny, nd_pad,
                             ny_pad, kx, ky, n_seg, overlap, stream);
}

int fd_wavefront_solve_seg_f64(const void* su, const void* sv,
                               const void* sfu, const void* sfv, void* sdu,
                               void* sdv, int nx, int ny, int nd_pad,
                               int ny_pad, double kx, double ky, int n_seg,
                               int overlap, void* stream) {
  return launch<double, true>(su, sv, sfu, sfv, sdu, sdv, nx, ny, nd_pad,
                              ny_pad, kx, ky, n_seg, overlap, stream);
}

const char* fd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
