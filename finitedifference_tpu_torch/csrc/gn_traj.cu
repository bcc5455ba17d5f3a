// Whole-trajectory HPROM kernel (B6), written by hand for Hopper (sm_90a).
//
// fd_gn_traj_* replaces finitedifference_tpu/ops/pallas_gn.py::
// _make_traj_kernel (trajectory_hprom_pallas, behind
// rom_factored.pallas_traj_hprom and parallel/sweep.sweep_hprom(engine=
// "pallas_traj")): the ENTIRE factored-HPROM time integration of B
// trajectories in ONE launch. Every trajectory shares the six stencil basis
// blocks p6 (6, n_p, kp) and the ECSW weights w (n_p); mu enters only
// through its source + inflow term slbc (n_p). For each of num_steps steps:
//   * the step constant cp = [-u_s + hf_u - slbc, -v_s + hf_v] at the
//     incoming state and init_norm = ||W (2 hf - slbc)||, from the scalars
//     s_p = p6[p] y and the half fluxes hf;
//   * `unroll_its` masked Gauss-Newton iterations, each: the scalars at y,
//     the weighted rows [w J V | w r] (lanes > k zero), the Gram extension
//     G = sum of their outer products, rn = sqrt(G[k, k]), the stop
//     rn / init_norm < cutoff or (an update was made and
//     |rn_prev - rn| / rn_prev < min_delta), and unless stopped a
//     `solve_iters`-step masked CG on G[:k, :k] dy = -G[k, :k] and
//     y += dy. An iteration entered after the stop changes nothing, so it
//     is skipped, and so is the CG of the iteration that stops.
// ys (B, num_steps, kp) gets y after each step (zeros beyond lane k),
// stats (B, 2) the Gauss-Newton updates and the systems built.
//
// What bounds it: operations, and the one SM each trajectory runs on. On
// the 250^2 bench mesh (n_p 1536, 95 modes, 128 live lanes) a system is
// ~59 MFLOP (the Gram of 3072 rows ~57 of them) and 500 steps build ~1500
// systems: ~88 GFLOP, 1.3 ms at the card's 67 TFLOP/s FP32 rate, while
// the bytes (p6 4.7 MB, read once from DRAM, then from L2) are negligible.
// But the trajectory is a chain: its steps and iterations run in sequence
// and the Gram needs all rows before the solve, so one trajectory is one
// CTA on 1 of 132 SMs and a single run reaches under 1% of that rate by
// construction; a batch of B trajectories fills B SMs.
//
// How the design answers it:
//  * the TPU kernel kept p6 (and everything) in 100 MB of VMEM; no CTA can
//    hold 4.7 MB, so p6 stays in global memory and is re-read each
//    iteration through L2, where all B CTAs share it;
//  * the Gram is built from staged chunks of 32 cells (their 64 u and v
//    rows) in shared memory: 256 threads own 4x4 tiles of the upper 64x64
//    blocks and accumulate a chunk in registers with plain FFMA/DFMA (never
//    tensor cores, so never TF32), then add it into a shared-memory Gram in
//    float64 while k + 1 <= 128 lanes (the standing rule of
//    pallas_gn_full.py: summing partials in f32 doubled the error), in
//    float32 at 192 lanes, where 192^2 doubles would not fit in 227 KB;
//  * the CG is gn_common.cuh's block-wide masked CG, one thread per lane,
//    on the shared-memory Gram; y stays in shared memory for the whole run,
//    so no step and no iteration goes back to the host.
// A cluster or cooperative multi-CTA design that spreads one trajectory
// over many SMs is the next step (ROADMAP).

#include <cuda_runtime.h>

#include <cstddef>

#include "gn_common.cuh"

namespace {

using fdgn::kBlock;                       // 256: 16 x 16 tiles of 4 x 4
constexpr int kEdge = fdgn::kGramEdge;    // 64
constexpr int kCells = 32;                // cells per staged chunk
constexpr int kRows = 2 * kCells;         // their u and v rows
constexpr int kWarps = kBlock / 32;
constexpr int kCoef = 12;                 // row coefficients per cell
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ void load4(const float* src, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* src, double (&v)[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(src)[0];
  const double2 q1 = reinterpret_cast<const double2*>(src)[1];
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

// s[p * kCells + c] = sum_{l < k} p6[p, c0 + c, l] y[l] (0 past n_p); one
// warp a cell, its six dot products side by side so that their L2 loads
// overlap.
template <typename T>
__device__ __forceinline__ void chunk_scalars(const T* __restrict__ p6,
                                              const T* y, T* s, int n_p,
                                              int kp, int k, int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t blk = static_cast<size_t>(n_p) * kp;
  for (int c = warp; c < kCells; c += kWarps) {
    const int i = c0 + c;
    T acc[6];
#pragma unroll
    for (int pos = 0; pos < 6; ++pos) acc[pos] = T(0);
    if (i < n_p) {
      const T* row = p6 + static_cast<size_t>(i) * kp;
      for (int l = lane; l < k; l += 32) {
        const T yl = y[l];
#pragma unroll
        for (int pos = 0; pos < 6; ++pos) acc[pos] += row[pos * blk + l] * yl;
      }
    }
#pragma unroll
    for (int pos = 0; pos < 6; ++pos) {
      T v = acc[pos];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s[pos * kCells + c] = v;
    }
  }
}

template <typename T, typename TG, int NB>
constexpr size_t smem_bytes() {
  return sizeof(TG) * NB * kEdge * NB * kEdge +
         sizeof(T) * (kRows * NB * kEdge + (6 + kCoef) * kCells +
                      NB * kEdge + kBlock + kWarps);
}

template <typename T, typename TG, int NB>
__global__ void __launch_bounds__(kBlock, 1)
traj_kernel(const T* __restrict__ p6, const T* __restrict__ y0,
            const T* __restrict__ slbc, const T* __restrict__ wgt,
            T* __restrict__ cp, T* __restrict__ ys, int* __restrict__ stats,
            int n_p, int kp, int k, T hdx, T hdy, int num_steps,
            int unroll_its, int solve_iters, T cutoff, T min_delta) {
  constexpr int K1P = NB * kEdge;
  constexpr int NU = NB * (NB + 1) / 2;   // upper 64x64 blocks of the Gram
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TG* gram = reinterpret_cast<TG*>(smem_raw);         // (K1P, K1P)
  T* a = reinterpret_cast<T*>(gram + K1P * K1P);      // (kRows, K1P)
  T* s = a + kRows * K1P;                             // (6, kCells)
  T* coef = s + 6 * kCells;                           // (kCoef, kCells)
  T* y = coef + kCoef * kCells;                       // (K1P)
  T* p = y + K1P;                                     // (kBlock) CG scratch
  T* red = p + kBlock;                                // (kWarps)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long b = blockIdx.x;
  const T* slbc_b = slbc + b * n_p;
  T* cp_u = cp + b * 2 * n_p;
  T* cp_v = cp_u + n_p;
  T* ys_b = ys + b * num_steps * kp;
  const size_t blk = static_cast<size_t>(n_p) * kp;
  const T one = T(1);
  const T qdx = T(0.5) * hdx, qdy = T(0.5) * hdy;

  for (int l = tid; l < K1P; l += kBlock) y[l] = l < k ? y0[b * kp + l] : T(0);
  __syncthreads();

  int its_total = 0, evals = 0;
  for (int t = 0; t < num_steps; ++t) {
    // the step constant at the incoming state and the initial residual
    T nrm = T(0);
    for (int c0 = 0; c0 < n_p; c0 += kCells) {
      chunk_scalars(p6, y, s, n_p, kp, k, c0);
      __syncthreads();
      const int i = c0 + tid;
      if (tid < kCells && i < n_p) {
        const T u_s = s[tid], u_w = s[kCells + tid];
        const T u_so = s[2 * kCells + tid], v_s = s[3 * kCells + tid];
        const T v_w = s[4 * kCells + tid], v_so = s[5 * kCells + tid];
        const T fuv = u_s * v_s;
        const T hf_u =
            qdx * (u_s * u_s - u_w * u_w) + qdy * (fuv - u_so * v_so);
        const T hf_v =
            qdy * (v_s * v_s - v_so * v_so) + qdx * (fuv - u_w * v_w);
        const T cu = -u_s + hf_u - slbc_b[i];
        const T cv = -v_s + hf_v;
        cp_u[i] = cu;
        cp_v[i] = cv;
        const T w = wgt[i];
        const T ru = w * (u_s + hf_u + cu), rv = w * (v_s + hf_v + cv);
        nrm += ru * ru + rv * rv;
      }
      __syncthreads();   // s is rewritten by the next chunk
    }
    const T init_norm = sqrt(fdgn::block_sum(nrm, red));

    int it = 0;
    bool done = false;   // the same on every thread: all read the same sums
    T rn_prev = init_norm;
    for (int u = 0; u < unroll_its && !done; ++u) {
      __syncthreads();   // every reader of the previous Gram is done
      for (int e = tid; e < K1P * K1P; e += kBlock) gram[e] = TG(0);
      T acc[NU][4][4];
#pragma unroll
      for (int q = 0; q < NU; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[q][i][j] = T(0);

      for (int c0 = 0; c0 < n_p; c0 += kCells) {
        chunk_scalars(p6, y, s, n_p, kp, k, c0);
        __syncthreads();
        if (tid < kCells) {
          // the row coefficients (the Jacobian's, weighted) and residuals
          const int i = c0 + tid;
          T co[kCoef];
#pragma unroll
          for (int j = 0; j < kCoef; ++j) co[j] = T(0);
          if (i < n_p) {
            const T u_s = s[tid], u_w = s[kCells + tid];
            const T u_so = s[2 * kCells + tid], v_s = s[3 * kCells + tid];
            const T v_w = s[4 * kCells + tid], v_so = s[5 * kCells + tid];
            const T w = wgt[i];
            co[0] = (one + hdx * u_s + qdy * v_s) * w;
            co[1] = (-hdx * u_w) * w;
            co[2] = (-qdy * v_so) * w;
            co[3] = (qdy * u_s) * w;
            co[4] = (-qdy * u_so) * w;
            co[5] = (qdx * v_s) * w;
            co[6] = (-qdx * v_w) * w;
            co[7] = (one + hdy * v_s + qdx * u_s) * w;
            co[8] = (-qdx * u_w) * w;
            co[9] = (-hdy * v_so) * w;
            const T fuv = u_s * v_s;
            const T hf_u =
                qdx * (u_s * u_s - u_w * u_w) + qdy * (fuv - u_so * v_so);
            const T hf_v =
                qdy * (v_s * v_s - v_so * v_so) + qdx * (fuv - u_w * v_w);
            co[10] = (u_s + hf_u + cp_u[i]) * w;
            co[11] = (v_s + hf_v + cp_v[i]) * w;
          }
#pragma unroll
          for (int j = 0; j < kCoef; ++j) coef[j * kCells + tid] = co[j];
        }
        __syncthreads();
        // the chunk's rows: u rows 0..kCells-1, v rows kCells..kRows-1
#pragma unroll 4
        for (int e = tid; e < kCells * K1P; e += kBlock) {
          const int c = e / K1P, l = e % K1P;
          const int i = c0 + c;
          T au = T(0), av = T(0);
          if (i < n_p && l < k) {
            const size_t o = static_cast<size_t>(i) * kp + l;
            const T b0 = p6[o], b1 = p6[blk + o], b2 = p6[2 * blk + o];
            const T b3 = p6[3 * blk + o], b4 = p6[4 * blk + o];
            const T b5 = p6[5 * blk + o];
            au = coef[c] * b0 + coef[kCells + c] * b1 +
                 coef[2 * kCells + c] * b2 + coef[3 * kCells + c] * b3 +
                 coef[4 * kCells + c] * b5;
            av = coef[5 * kCells + c] * b0 + coef[6 * kCells + c] * b1 +
                 coef[7 * kCells + c] * b3 + coef[8 * kCells + c] * b4 +
                 coef[9 * kCells + c] * b5;
          } else if (l == k) {
            au = coef[10 * kCells + c];
            av = coef[11 * kCells + c];
          }
          a[c * K1P + l] = au;
          a[(kCells + c) * K1P + l] = av;
        }
        __syncthreads();
        // the chunk's partial Gram, upper blocks only, in registers
#pragma unroll 2
        for (int r = 0; r < kRows; ++r) {
          const T* ar = a + r * K1P;
          T x[NB][4], z[NB][4];
#pragma unroll
          for (int bi = 0; bi < NB; ++bi) {
            load4(ar + bi * kEdge + ty * 4, x[bi]);
            load4(ar + bi * kEdge + tx * 4, z[bi]);
          }
          int q = 0;
#pragma unroll
          for (int bi = 0; bi < NB; ++bi)
#pragma unroll
            for (int bj = bi; bj < NB; ++bj, ++q)
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  acc[q][i][j] += x[bi][i] * z[bj][j];
        }
        // ... added into the Gram's elements this thread owns
        int q = 0;
#pragma unroll
        for (int bi = 0; bi < NB; ++bi)
#pragma unroll
          for (int bj = bi; bj < NB; ++bj, ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                gram[(bi * kEdge + ty * 4 + i) * K1P + bj * kEdge + tx * 4 +
                     j] += static_cast<TG>(acc[q][i][j]);
                acc[q][i][j] = T(0);
              }
      }
      // mirror the upper off-diagonal blocks into the lower ones
#pragma unroll
      for (int bi = 0; bi < NB; ++bi)
#pragma unroll
        for (int bj = bi + 1; bj < NB; ++bj)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int gi = bi * kEdge + ty * 4 + i;
              const int gj = bj * kEdge + tx * 4 + j;
              gram[gj * K1P + gi] = gram[gi * K1P + gj];
            }
      __syncthreads();

      const T rn = sqrt(static_cast<T>(gram[k * K1P + k]));
      const bool stop = rn / init_norm < cutoff ||
                        (it > 0 && fabs(rn_prev - rn) / rn_prev < min_delta);
      ++evals;
      if (!stop) {
        const T dy = fdgn::masked_cg<T, TG>(gram, K1P, k, solve_iters, p, red);
        if (tid < k) y[tid] += dy;
        ++it;
        __syncthreads();   // y is complete before the next scalars
      }
      rn_prev = rn;
      done = stop;
    }
    its_total += it;
    for (int l = tid; l < kp; l += kBlock)
      ys_b[static_cast<size_t>(t) * kp + l] = l < k ? y[l] : T(0);
  }
  if (tid == 0) {
    stats[2 * b] = its_total;
    stats[2 * b + 1] = evals;
  }
}

template <typename T, typename TG, int NB>
cudaError_t launch_nb(const T* p6, const T* y0, const T* slbc, const T* wgt,
                      T* cp, T* ys, int* stats, int batch, int n_p, int kp,
                      int k, T hdx, T hdy, int num_steps, int unroll_its,
                      int solve_iters, T cutoff, T min_delta,
                      cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, TG, NB>();
  auto kernel = traj_kernel<T, TG, NB>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch, kBlock, smem, st>>>(p6, y0, slbc, wgt, cp, ys, stats, n_p,
                                      kp, k, hdx, hdy, num_steps, unroll_its,
                                      solve_iters, cutoff, min_delta);
  return cudaGetLastError();
}

template <typename T>
int gn_traj(const void* p6, const void* y0, const void* slbc,
            const void* wgt, void* cp, void* ys, void* stats, int batch,
            int n_p, int kp, int k, int k1p, T hdx, T hdy, int num_steps,
            int unroll_its, int solve_iters, T cutoff, T min_delta,
            void* stream) {
  if (batch < 1 || n_p < 1 || k < 1 || k >= kp || k >= kBlock ||
      k1p != (k + kEdge) / kEdge * kEdge || num_steps < 0 ||
      unroll_its < 0 || solve_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a = static_cast<const T*>(p6);
  const auto* b = static_cast<const T*>(y0);
  const auto* c = static_cast<const T*>(slbc);
  const auto* w = static_cast<const T*>(wgt);
  auto* o1 = static_cast<T*>(cp);
  auto* o2 = static_cast<T*>(ys);
  auto* o3 = static_cast<int*>(stats);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (k1p / kEdge) {
    case 1:
      err = launch_nb<T, double, 1>(a, b, c, w, o1, o2, o3, batch, n_p, kp, k,
                                    hdx, hdy, num_steps, unroll_its,
                                    solve_iters, cutoff, min_delta, st);
      break;
    case 2:
      err = launch_nb<T, double, 2>(a, b, c, w, o1, o2, o3, batch, n_p, kp, k,
                                    hdx, hdy, num_steps, unroll_its,
                                    solve_iters, cutoff, min_delta, st);
      break;
    case 3:
      // 192 live lanes: a float64 Gram would need 295 KB of shared memory
      if constexpr (sizeof(T) == sizeof(float)) {
        err = launch_nb<T, float, 3>(a, b, c, w, o1, o2, o3, batch, n_p, kp,
                                     k, hdx, hdy, num_steps, unroll_its,
                                     solve_iters, cutoff, min_delta, st);
      }
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Whole trajectories of `batch` mu points, one CTA each: y0 (batch, kp)
// padded, slbc (batch, n_p), cp (batch, 2, n_p) scratch, ys (batch,
// num_steps, kp), stats (batch, 2) int32 [updates, systems built]. k1p =
// round_up(k + 1, 64) must be 64 or 128, or 192 in float32. Launches on
// `stream` without synchronising; returns the cudaError_t of the launch.
int fd_gn_traj_f32(const void* p6, const void* y0, const void* slbc,
                   const void* wgt, void* cp, void* ys, void* stats,
                   int batch, int n_p, int kp, int k, int k1p, float hdx,
                   float hdy, int num_steps, int unroll_its, int solve_iters,
                   float cutoff, float min_delta, void* stream) {
  return gn_traj<float>(p6, y0, slbc, wgt, cp, ys, stats, batch, n_p, kp, k,
                        k1p, hdx, hdy, num_steps, unroll_its, solve_iters,
                        cutoff, min_delta, stream);
}

int fd_gn_traj_f64(const void* p6, const void* y0, const void* slbc,
                   const void* wgt, void* cp, void* ys, void* stats,
                   int batch, int n_p, int kp, int k, int k1p, double hdx,
                   double hdy, int num_steps, int unroll_its, int solve_iters,
                   double cutoff, double min_delta, void* stream) {
  return gn_traj<double>(p6, y0, slbc, wgt, cp, ys, stats, batch, n_p, kp, k,
                         k1p, hdx, hdy, num_steps, unroll_its, solve_iters,
                         cutoff, min_delta, stream);
}

}  // extern "C"
