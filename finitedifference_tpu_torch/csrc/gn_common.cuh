// Shared passes of the sampled-mesh Gauss-Newton system kernels
// (gn_sampled.cu, B4 and B5), written by hand for Hopper (sm_90a), the
// float64 reduction of partial Grams that the full-grid kernel (gn_full.cu,
// B3) ends with too, the block-wide masked CG that B5 runs on a reduced
// Gram, and the 16-byte row accesses of B3 and the trajectory kernel
// (gn_traj.cu, B6).
//
// A sampled system kernel is four passes on the current stream:
//   1. rows_dot:       s = B y, a GEMV over the basis rows (one warp a row);
//   2. a rows pass:    the weighted [J V | r] rows A (rows, k1p), lane k
//                      holding the residual, lanes > k zero (per file);
//   3. gram_partials:  per-CTA partial Grams A_c^T A_c of row chunks, in the
//                      working type with plain FFMA/DFMA (never tensor
//                      cores, so never TF32), one 64x64 output block per CTA
//                      for the upper blocks (bi <= bj), mirrored on store;
//   4. reduce_partials: the chunks' partials summed in float64, one thread an
//                      element, into a (ldo, ldo) output with zeros beyond
//                      k1p.
// B3 fuses passes 1 to 3 into one kernel that keeps A in shared memory
// (gn_full.cu) and shares pass 4.
// The TPU kernels summed their tiles in one VMEM scratch across a grid that
// runs in order; CUDA blocks run in no order, so partials and a second pass
// take its place, and the float64 sum keeps the cross-chunk rounding out of
// the Gram (summing the partials in f32 doubled the trajectory error in the
// JAX package).
#pragma once

#include <cuda_runtime.h>

#include <cfloat>

namespace fdgn {

constexpr int kBlock = 256;     // threads of every pass but the CG
constexpr int kGramEdge = 64;   // output block edge of gram_partials
constexpr int kGramRows = 32;   // rows staged in shared memory per step

// 16 bytes of T
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

template <typename T, int N>
__device__ __forceinline__ void load_lanes(const T* p, T (&out)[N]) {
  using V = typename Vec<T>::type;
#pragma unroll
  for (int i = 0; i < N / kVec<T>; ++i)
    reinterpret_cast<V*>(out)[i] = reinterpret_cast<const V*>(p)[i];
}

template <typename T, int N>
__device__ __forceinline__ void store_lanes(T* p, const T (&in)[N]) {
  using V = typename Vec<T>::type;
#pragma unroll
  for (int i = 0; i < N / kVec<T>; ++i)
    reinterpret_cast<V*>(p)[i] = reinterpret_cast<const V*>(in)[i];
}

template <typename T>
__device__ __forceinline__ T tiny_normal();
template <>
__device__ __forceinline__ float tiny_normal<float>() { return FLT_MIN; }
template <>
__device__ __forceinline__ double tiny_normal<double>() { return DBL_MIN; }

// s[r] = sum_{l < k} a[r * ld + l] * y[l]; lanes >= k of a are zero.
template <typename T>
__global__ void __launch_bounds__(kBlock)
rows_dot_kernel(const T* __restrict__ a, const T* __restrict__ y,
                T* __restrict__ s, long long rows, int ld, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kBlock / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp shares the row
  const T* ar = a + row * ld;
  T acc = T(0);
  for (int l = lane; l < k; l += 32) acc += ar[l] * y[l];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) s[row] = acc;
}

template <typename T>
cudaError_t rows_dot(const T* a, const T* y, T* s, long long rows, int ld,
                     int k, cudaStream_t st) {
  const long long per_block = kBlock / 32;
  const long long blocks = (rows + per_block - 1) / per_block;
  rows_dot_kernel<T><<<static_cast<unsigned>(blocks), kBlock, 0, st>>>(
      a, y, s, rows, ld, k);
  return cudaGetLastError();
}

// partials[c] (k1p x k1p) = A[rows of chunk c]^T A[rows of chunk c], where
// A is (m, k1p) row-major and chunk c is rows [c * rpc, (c + 1) * rpc).
// grid = (n_chunks, nb * (nb + 1) / 2) with nb = k1p / kGramEdge; blockIdx.y
// enumerates the upper blocks (bi, bj), bi <= bj. Each thread owns a 4x4
// tile of the 64x64 block.
template <typename T>
__global__ void __launch_bounds__(kBlock)
gram_partials_kernel(const T* __restrict__ a, long long m, int k1p, int rpc,
                     T* __restrict__ partials) {
  __shared__ __align__(16) T ai[kGramRows][kGramEdge];
  __shared__ __align__(16) T aj[kGramRows][kGramEdge];
  const int nb = k1p / kGramEdge;
  int pair = blockIdx.y, bi = 0;
  while (pair >= nb - bi) {
    pair -= nb - bi;
    ++bi;
  }
  const int bj = bi + pair;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = T(0);

  const long long r0 = static_cast<long long>(blockIdx.x) * rpc;
  const long long r1 = r0 + rpc < m ? r0 + rpc : m;
  for (long long rb = r0; rb < r1; rb += kGramRows) {
    for (int e = threadIdx.x; e < kGramRows * kGramEdge; e += kBlock) {
      const int rr = e / kGramEdge, cc = e % kGramEdge;
      const long long row = rb + rr;
      T vi = T(0), vj = T(0);
      if (row < r1) {
        const T* ar = a + row * k1p;
        vi = ar[bi * kGramEdge + cc];
        vj = ar[bj * kGramEdge + cc];
      }
      ai[rr][cc] = vi;
      aj[rr][cc] = vj;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kGramRows; ++rr) {
      T x[4], z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = ai[rr][ty * 4 + q];
        z[q] = aj[rr][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += x[p] * z[q];
    }
    __syncthreads();
  }
  T* out = partials + static_cast<long long>(blockIdx.x) * k1p * k1p;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long gi = bi * kGramEdge + ty * 4 + p;
      const long long gj = bj * kGramEdge + tx * 4 + q;
      out[gi * k1p + gj] = acc[p][q];
      if (bi != bj) out[gj * k1p + gi] = acc[p][q];
    }
}

template <typename T>
cudaError_t gram_partials(const T* a, long long m, int k1p, int rpc,
                          int n_chunks, T* partials, cudaStream_t st) {
  const int nb = k1p / kGramEdge;
  const dim3 grid(static_cast<unsigned>(n_chunks),
                  static_cast<unsigned>(nb * (nb + 1) / 2));
  gram_partials_kernel<T><<<grid, kBlock, 0, st>>>(a, m, k1p, rpc, partials);
  return cudaGetLastError();
}

// out[i, j] (ldo x ldo) = sum_c partials[c, i, j] in float64 for i, j <
// k1p; 0 elsewhere.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kBlock)
reduce_partials_kernel(const TIn* __restrict__ partials, int n_chunks,
                       int k1p, TOut* __restrict__ out, int ldo) {
  const long long e = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= static_cast<long long>(ldo) * ldo) return;
  const int i = static_cast<int>(e / ldo), j = static_cast<int>(e % ldo);
  double acc = 0.0;
  if (i < k1p && j < k1p) {
    const TIn* p = partials + static_cast<long long>(i) * k1p + j;
    const long long stride = static_cast<long long>(k1p) * k1p;
#pragma unroll 8
    for (int c = 0; c < n_chunks; ++c)
      acc += static_cast<double>(p[c * stride]);
  }
  out[e] = static_cast<TOut>(acc);
}

template <typename TIn, typename TOut>
cudaError_t reduce_partials(const TIn* partials, int n_chunks, int k1p,
                            TOut* out, int ldo, cudaStream_t st) {
  const long long elems = static_cast<long long>(ldo) * ldo;
  const unsigned blocks = static_cast<unsigned>((elems + kBlock - 1) / kBlock);
  reduce_partials_kernel<TIn, TOut><<<blocks, kBlock, 0, st>>>(
      partials, n_chunks, k1p, out, ldo);
  return cudaGetLastError();
}

// Block-wide sum over kBlock threads; every thread gets the same value.
template <typename T>
__device__ T block_sum(T v, T* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();   // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = T(0);
#pragma unroll
  for (int w = 0; w < kBlock / 32; ++w) total += red[w];
  return total;
}

// `iters` masked CG steps on g[:k, :k] x = -g[k, :k], with g (ldg x ldg,
// symmetric, in TG) in global or shared memory, in T, by one block of
// kBlock threads: thread i owns lane i (k < kBlock) and gets x_i (0 for
// i >= k). The iterate freezes once the residual or the curvature falls
// below the smallest normal number. p (kBlock) and red (kBlock / 32) are
// shared scratch.
template <typename T, typename TG>
__device__ T masked_cg(const TG* g, int ldg, int k, int iters, T* p, T* red) {
  const int i = threadIdx.x;
  const bool own = i < k;
  const T b = own ? -static_cast<T>(g[static_cast<long long>(k) * ldg + i])
                  : T(0);
  T x = T(0), r = b;
  p[i] = b;
  T rs = block_sum(b * b, red);
  const T tiny = tiny_normal<T>();
  for (int it = 0; it < iters; ++it) {
    __syncthreads();   // p from the previous update is visible
    T gp = T(0);
    if (own) {
#pragma unroll 8
      for (int j = 0; j < k; ++j)
        gp += static_cast<T>(g[static_cast<long long>(j) * ldg + i]) * p[j];
    }
    const T pi = p[i];
    const T denom = block_sum(pi * gp, red);
    const bool live = rs > tiny && denom > tiny;
    const T alpha = live ? rs / denom : T(0);
    x += alpha * pi;
    r -= alpha * gp;
    const T rs_new = block_sum(r * r, red);
    const T beta = live ? rs_new / rs : T(0);
    p[i] = r + beta * pi;
    rs = rs_new;
  }
  return own ? x : T(0);
}

}  // namespace fdgn
