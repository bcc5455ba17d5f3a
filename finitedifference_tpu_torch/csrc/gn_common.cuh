// Shared pieces of the Gauss-Newton system kernels, written by hand for
// Hopper (sm_90a): the 16-byte row accesses of the full-grid kernel
// (gn_full.cu, B3), the sampled kernels (gn_sampled.cu, B4 and B5) and the
// trajectory kernel (gn_traj.cu, B6), the smallest normal number of their
// CGs, and the float64 reduction of partial Grams that B3 ends with.
// The TPU kernels summed their tiles in one VMEM scratch across a grid that
// runs in order; CUDA blocks run in no order, so B3's partials take a
// second pass, and the float64 sum keeps the cross-chunk rounding out of
// the Gram (summing the partials in f32 doubled the trajectory error in the
// JAX package).
#pragma once

#include <cuda_runtime.h>

#include <cfloat>

namespace fdgn {

constexpr int kBlock = 256;     // threads of the reduction pass

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

}  // namespace fdgn
