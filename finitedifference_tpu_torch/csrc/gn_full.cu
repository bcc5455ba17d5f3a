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
//   over lanes 0..k (zero above k);
//   gext = sum_i A_u[i]^T A_u[i] + A_v[i]^T A_v[i] as (kp, kp) float64.
//
// What bounds it: the card's FP32 (FP64) FMA rate and its memory rate, about
// equally. At 750^2 with 95 modes the basis halves are 0.58 GB (f32), 0.17
// ms at HBM speed, and the symmetric Gram of 1.13 M rows over 96 lanes is
// 10.5 GFLOP, 0.16 ms at the FP32 rate. Whatever moves the rows A (as large
// as the basis) through device memory, or feeds each FMA from shared memory,
// falls far behind both.
//
// How the design answers it: one fused kernel, then the float64 reduction.
// Measured on an H100 at 750^2 (PERF.md): 0.75 ms in f32 where the five
// passes it replaces took 2.43, of which the products are 0.33, the dot
// products, the rows and the barriers between the phases the rest.
//  * A never leaves the SM. A CTA takes chunks of `chunk` consecutive
//    cells. Per chunk it stages the basis rows of those cells, of the cell
//    before them (the first cell's west neighbour) and of the cells one
//    padded grid row back (the south neighbours) in shared memory, two
//    stages deep, so the next chunk's rows arrive under the current chunk's
//    products. A row's live lanes are one bulk copy of the copy engine
//    (cp.async.bulk, completing the stage's mbarrier): 130 instructions a
//    chunk of 32 cells where cp.async took 3120;
//  * the scalars V y come from the staged rows themselves (a team of 8
//    threads per cell takes the six dot products it needs, own, west and
//    south, u and v, in one loop), 4% of the Gram's FMAs, so no GEMV pass
//    reads the basis a second time and a cell's scalars, residual and step
//    constant are computed once per cell, not once per lane;
//  * chunk c goes to CTA c mod gridDim.x, so at any time the CTAs sweep one
//    window of a few grid rows together and the south rows, read one grid
//    row earlier by other CTAs, come from L2: the basis crosses the HBM bus
//    once. The assignment depends on the shape alone, so the result is the
//    same from run to run;
//  * the Gram of a chunk's 2 * chunk rows accumulates in registers straight
//    from shared memory: a thread owns an 8x8 tile of the upper triangle of
//    the live lanes (k + 1 rounded up to 16, not to 64) and reads its two
//    8-lane operands as 16-byte vectors, 4 (f32) or 8 (f64) shared loads for
//    64 FMAs, all threads of a warp on one row so the loads broadcast. The
//    threads of a CTA form groups of one thread per tile; the groups split
//    the chunk's rows and add their tiles, in a fixed order, into the CTA's
//    one partial Gram at the end. FFMA/DFMA only, never tensor cores, so
//    never TF32;
//  * the dead-cell layout stays: a dead row tail is the west zero ghost of
//    the next row's inflow column, and the full-length mask zeroes the dead
//    column tail AND the dead bottom rows, whose real south neighbour
//    would put +14% into ||r||^2 at 250^2;
//  * the CTAs' partials (two or three CTAs per SM, so that one CTA's
//    products run under another's staging and barriers) are summed in
//    float64 by reduce_partials (gn_common.cuh).
// More than 128 live lanes have more tiles than one group holds (160
// threads); blockIdx.y then splits the tiles, every split rebuilding the
// rows.

#include <cuda_runtime.h>

#include "gn_common.cuh"
#include "hopper_sync.cuh"

namespace {

using fdgn::kVec;
using fdgn::load_lanes;
using fdgn::store_lanes;
using fdsync::barrier_expect;
using fdsync::barrier_init;
using fdsync::barrier_wait;
using fdsync::bulk_copy;

constexpr int kTile = 8;         // edge of a thread's register tile
constexpr int kLaneStep = 16;    // live lanes are a multiple
constexpr int kMaxGroup = 160;   // threads of one group: 136 tiles at 128 lanes
constexpr int kTeam = 8;         // threads that share a cell's dot products
constexpr int kCoefs = 12;       // per cell: 10 masked stencil weights, ru, rv
constexpr int kDefaultSmem = 48 * 1024;

// the most threads of a CTA: the 8x8 accumulators and their operands need
// ~110 (f32) or ~150 (f64) registers; the CTAs on an SM share its 64 K
template <typename T> struct Threads;
template <> struct Threads<float> { static constexpr int value = 384; };
template <> struct Threads<double> { static constexpr int value = 320; };

// One stage of the ring, in units of T: the rows of the chunk's cells and
// of the cell before them ([2 halves][chunk + 1][stride]), of their south
// neighbours ([2][chunk][stride]), the cells' mask and their slbc or cp.
struct Stage {
  int own, south, mask, aux, size;
  __host__ __device__ Stage(int chunk, int stride) {
    own = 0;
    south = own + 2 * (chunk + 1) * stride;
    mask = south + 2 * chunk * stride;
    aux = mask + chunk;
    size = aux + 2 * chunk;
  }
};

__host__ __device__ inline int smem_values(int chunk, int lanes, int stride) {
  // y, the coefficients, two stages, the rows A
  return lanes + kCoefs * chunk + 2 * Stage(chunk, stride).size +
         2 * chunk * stride;
}

// The six dot products of a cell's rows with y over the live lanes, split
// over the 8 threads of a team; every thread of the team gets the sums. One
// loop and one round of shuffles for all six, so their latencies overlap.
template <typename T>
__device__ __forceinline__ void team_dots(const T* const (&rows)[6],
                                          const T* y, int j8, int lanes,
                                          T (&sums)[6]) {
#pragma unroll
  for (int q = 0; q < 6; ++q) sums[q] = T(0);
  for (int l = j8 * kVec<T>; l < lanes; l += kTeam * kVec<T>) {
    alignas(16) T b[kVec<T>];
    load_lanes(y + l, b);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      alignas(16) T a[kVec<T>];
      load_lanes(rows[q] + l, a);
#pragma unroll
      for (int i = 0; i < kVec<T>; ++i) sums[q] += a[i] * b[i];
    }
  }
#pragma unroll
  for (int off = kTeam / 2; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < 6; ++q)
      sums[q] += __shfl_xor_sync(0xffffffffu, sums[q], off);
}

template <typename T, bool FIRST>
__global__ void __launch_bounds__(Threads<T>::value)
full_system_kernel(const T* __restrict__ vu, const T* __restrict__ vv,
                   const T* __restrict__ y, const T* __restrict__ aux,
                   const T* __restrict__ dmask, T* __restrict__ cp_out,
                   T* __restrict__ partials, int n_pad, int kp, int k,
                   int lanes, int nxp, T hdx, T hdy, int chunk, int n_chunks,
                   int group_threads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int stride = lanes + kVec<T>;   // rows 16 bytes apart in the banks
  const Stage st(chunk, stride);
  T* ys = smem;
  T* coef = ys + lanes;
  T* stage0 = coef + kCoefs * chunk;
  T* rows_a = stage0 + 2 * st.size;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const T zero = T(0), one = T(1);
  const T qdx = T(0.5) * hdx, qdy = T(0.5) * hdy;
  const int pieces = lanes / kVec<T>;   // 16-byte pieces of a row

  // this thread's tile of the upper triangle, and its group
  const int nt = lanes / kTile;
  const int n_tiles = nt * (nt + 1) / 2;
  const int group = tid / group_threads, n_groups = nthreads / group_threads;
  int tile = blockIdx.y * group_threads + tid % group_threads;
  const bool has_tile = tile < n_tiles;
  int ti = 0;
  if (has_tile) {
    while (tile >= nt - ti) {
      tile -= nt - ti;
      ++ti;
    }
  }
  const int tj = has_tile ? ti + tile : 0;
  T acc[kTile][kTile];
#pragma unroll
  for (int p = 0; p < kTile; ++p)
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[p][q] = zero;

  for (int l = tid; l < lanes; l += nthreads) ys[l] = l < k ? y[l] : zero;

  // start the copies of chunk c into stage s: rows outside the grid are
  // zeros (no west before cell 0, no south in the first grid row)
  // 16-byte pieces of a row are dealt by thread in the pass that builds A
  const int my_p = tid % pieces, my_row = tid / pieces;
  const int row_step = nthreads / pieces;
  const bool deals = my_row < row_step;

  // a stage's copies complete its mbarrier: one arrival, thread 0's, which
  // announces the stage's bytes
  __shared__ __align__(8) unsigned long long stage_bar[2];
  if (tid == 0) {
    barrier_init(fdsync::local_address(&stage_bar[0]), 1);
    barrier_init(fdsync::local_address(&stage_bar[1]), 1);
    fdsync::barrier_init_fence();
  }
  __syncthreads();

  // start the copies of chunk c into stage s, a row (its live lanes) per
  // copy and thread; rows outside the grid are zeros (no west before cell
  // 0, no south in the first grid row)
  const unsigned row_bytes = lanes * sizeof(T);
  auto stage_in = [&](int c, int s) {
    T* base = stage0 + s * st.size;
    const unsigned bar = fdsync::local_address(&stage_bar[s]);
    const long long i0 = static_cast<long long>(c) * chunk;
    const int cells = n_pad - i0 < chunk ? static_cast<int>(n_pad - i0)
                                         : chunk;
    const int n_own = 2 * (chunk + 1), n_rows = n_own + 2 * chunk;
    const int per_cell = FIRST ? 1 : 2;
    if (tid == 0) {
      // the rows inside the grid: own rows of cells i0 - 1 .. i0 + cells
      // - 1 but for cell -1, south rows of cells i0 + j - nxp in [0, n_pad)
      const int own = cells + (i0 > 0 ? 1 : 0);
      const long long lo = nxp - i0 > 0 ? nxp - i0 : 0;
      const long long hi = n_pad + nxp - i0 < chunk ? n_pad + nxp - i0
                                                    : chunk;
      const int south = hi > lo ? static_cast<int>(hi - lo) : 0;
      barrier_expect(bar, 2 * (own + south) * row_bytes +
                              (1 + per_cell) * cells *
                                  static_cast<unsigned>(sizeof(T)));
    }
    // the copy engine writes what other threads have read: order it after
    // their reads, which the block barrier before this call has collected
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int row = tid; row < n_rows; row += nthreads) {
      const bool is_own = row < n_own;
      const int f = is_own ? row : row - n_own;   // row of its buffer
      const int half_rows = is_own ? chunk + 1 : chunk;
      const int h = f >= half_rows, j = f - h * half_rows;
      const long long cell = is_own ? i0 - 1 + j : i0 + j - nxp;
      T* dst = base + (is_own ? st.own : st.south) + f * stride;
      if (cell >= 0 && cell < n_pad) {
        bulk_copy(dst, (h ? vv : vu) + cell * kp, row_bytes, bar);
      } else {
        for (int l = 0; l < lanes; ++l) dst[l] = zero;
      }
    }
    if (tid == nthreads - 1) {
      bulk_copy(base + st.mask, dmask + i0,
                cells * static_cast<unsigned>(sizeof(T)), bar);
      bulk_copy(base + st.aux, aux + i0 * per_cell,
                per_cell * cells * static_cast<unsigned>(sizeof(T)), bar);
      for (int e = cells; e < chunk; ++e) {
        base[st.mask + e] = zero;
        base[st.aux + per_cell * e] = zero;
        base[st.aux + per_cell * e + per_cell - 1] = zero;
      }
    }
  };

  int c = blockIdx.x, s = 0;
  unsigned parity = 0;   // bit s: of stage s's next completion
  if (c < n_chunks) stage_in(c, 0);
  for (; c < n_chunks; c += gridDim.x, s ^= 1) {
    const int next = c + gridDim.x;
    if (next < n_chunks) stage_in(next, s ^ 1);
    barrier_wait(fdsync::local_address(&stage_bar[s]), (parity >> s) & 1);
    parity ^= 1u << s;   // chunk c is in
    __syncthreads();   // the zero rows too; the last Gram has read rows_a
    const T* base = stage0 + s * st.size;
    const T* own_u = base + st.own;
    const T* own_v = own_u + (chunk + 1) * stride;
    const T* so_u = base + st.south;
    const T* so_v = so_u + chunk * stride;
    const long long i0 = static_cast<long long>(c) * chunk;

    // the scalars and the coefficients, a team of 8 threads per cell
    for (int j = tid / kTeam; j < chunk; j += nthreads / kTeam) {
      const int j8 = tid % kTeam;
      const T* const rows[6] = {
          own_u + (j + 1) * stride, own_v + (j + 1) * stride,
          own_u + j * stride,       own_v + j * stride,
          so_u + j * stride,        so_v + j * stride};
      T sums[6];
      team_dots(rows, ys, j8, lanes, sums);
      const T u_s = sums[0], v_s = sums[1], u_w = sums[2], v_w = sums[3];
      const T u_so = sums[4], v_so = sums[5];
      if (j8 == 0) {
        const T m = base[st.mask + j];
        const T fuv = u_s * v_s;
        const T ru_f =
            qdx * (u_s * u_s - u_w * u_w) + qdy * (fuv - u_so * v_so);
        const T rv_f =
            qdy * (v_s * v_s - v_so * v_so) + qdx * (fuv - u_w * v_w);
        T cp_u, cp_v;
        if (FIRST) {
          cp_u = (-u_s + ru_f - base[st.aux + j]) * m;
          cp_v = (-v_s + rv_f) * m;
          if (blockIdx.y == 0 && i0 + j < n_pad) {
            cp_out[2 * (i0 + j)] = cp_u;
            cp_out[2 * (i0 + j) + 1] = cp_v;
          }
        } else {
          cp_u = base[st.aux + 2 * j];
          cp_v = base[st.aux + 2 * j + 1];
        }
        T* cf = coef + kCoefs * j;
        cf[0] = (one + hdx * u_s + qdy * v_s) * m;   // A_u: Vu own
        cf[1] = (-hdx * u_w) * m;                    //      Vu west
        cf[2] = (-qdy * v_so) * m;                   //      Vu south
        cf[3] = (qdy * u_s) * m;                     //      Vv own
        cf[4] = (-qdy * u_so) * m;                   //      Vv south
        cf[5] = (qdx * v_s) * m;                     // A_v: Vu own
        cf[6] = (-qdx * v_w) * m;                    //      Vu west
        cf[7] = (one + hdy * v_s + qdx * u_s) * m;   //      Vv own
        cf[8] = (-qdx * u_w) * m;                    //      Vv west
        cf[9] = (-hdy * v_so) * m;                   //      Vv south
        cf[10] = (u_s + ru_f + cp_u) * m;
        cf[11] = (v_s + rv_f + cp_v) * m;
      }
    }
    __syncthreads();

    // the rows A: [chunk rows of A_u][chunk rows of A_v], 16 bytes a thread
    for (int j = my_row; deals && j < chunk; j += row_step) {
      const int l0 = my_p * kVec<T>;
      alignas(16) T cf[kCoefs];
      load_lanes(coef + kCoefs * j, cf);
      alignas(16) T bu[kVec<T>], bu_w[kVec<T>], bu_so[kVec<T>];
      alignas(16) T bv[kVec<T>], bv_w[kVec<T>], bv_so[kVec<T>];
      alignas(16) T au[kVec<T>], av[kVec<T>];
      load_lanes(own_u + (j + 1) * stride + l0, bu);
      load_lanes(own_u + j * stride + l0, bu_w);
      load_lanes(so_u + j * stride + l0, bu_so);
      load_lanes(own_v + (j + 1) * stride + l0, bv);
      load_lanes(own_v + j * stride + l0, bv_w);
      load_lanes(so_v + j * stride + l0, bv_so);
#pragma unroll
      for (int i = 0; i < kVec<T>; ++i) {
        const int l = l0 + i;
        au[i] = cf[0] * bu[i] + cf[1] * bu_w[i] + cf[2] * bu_so[i] +
                cf[3] * bv[i] + cf[4] * bv_so[i];
        av[i] = cf[5] * bu[i] + cf[6] * bu_w[i] + cf[7] * bv[i] +
                cf[8] * bv_w[i] + cf[9] * bv_so[i];
        if (l == k) {
          au[i] = cf[10];
          av[i] = cf[11];
        } else if (l > k) {
          au[i] = av[i] = zero;
        }
      }
      store_lanes(rows_a + j * stride + l0, au);
      store_lanes(rows_a + (chunk + j) * stride + l0, av);
    }
    __syncthreads();

    // this group's share of the rows into the tile
    if (has_tile) {
      for (int r = group; r < 2 * chunk; r += n_groups) {
        alignas(16) T x[kTile], z[kTile];
        load_lanes(rows_a + r * stride + ti * kTile, x);
        load_lanes(rows_a + r * stride + tj * kTile, z);
#pragma unroll
        for (int p = 0; p < kTile; ++p)
#pragma unroll
          for (int q = 0; q < kTile; ++q) acc[p][q] += x[p] * z[q];
      }
    }
  }

  // the groups add their tiles to the CTA's partial in turn, mirrored
  T* out = partials + static_cast<long long>(blockIdx.x) * lanes * lanes;
  for (int g = 0; g < n_groups; ++g) {
    if (group == g && has_tile) {
#pragma unroll
      for (int p = 0; p < kTile; ++p)
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          const int gi = ti * kTile + p, gj = tj * kTile + q;
          T v = acc[p][q];
          if (g > 0) v += out[gi * lanes + gj];
          out[gi * lanes + gj] = v;
          if (ti != tj) out[gj * lanes + gi] = v;
        }
    }
    __syncthreads();
  }
}

template <typename T>
int gn_full(const void* vu, const void* vv, const void* y, const void* aux,
            const void* dmask, void* cp_out, void* partials, void* gext,
            int n_pad, int kp, int k, int lanes, int nxp, int first, T hdx,
            T hdy, int chunk, int n_ctas, int threads, void* stream) {
  if (k < 1 || lanes % kLaneStep || lanes < k + 1 || lanes > kp ||
      kp % kVec<T> || chunk < 4 || chunk % 4 || n_ctas < 1 || nxp < 1 ||
      n_pad < 1 || n_pad % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = lanes / kTile;
  const int n_tiles = nt * (nt + 1) / 2;
  const int group_threads =
      n_tiles < kMaxGroup ? (n_tiles + 31) / 32 * 32 : kMaxGroup;
  const int splits = (n_tiles + group_threads - 1) / group_threads;
  if (threads < group_threads || threads % group_threads ||
      threads > Threads<T>::value || lanes / kVec<T> > threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_chunks = (n_pad + chunk - 1) / chunk;
  const size_t smem =
      sizeof(T) * smem_values(chunk, lanes, lanes + kVec<T>);
  auto st = static_cast<cudaStream_t>(stream);
  auto kernel = first ? full_system_kernel<T, true>
                      : full_system_kernel<T, false>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_ctas),
                  static_cast<unsigned>(splits));
  kernel<<<grid, threads, smem, st>>>(
      static_cast<const T*>(vu), static_cast<const T*>(vv),
      static_cast<const T*>(y), static_cast<const T*>(aux),
      static_cast<const T*>(dmask), static_cast<T*>(cp_out),
      static_cast<T*>(partials), n_pad, kp, k, lanes, nxp, hdx, hdy, chunk,
      n_chunks, group_threads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fdgn::reduce_partials<T, double>(
      static_cast<const T*>(partials), n_ctas, lanes,
      static_cast<double*>(gext), kp, st));
}

}  // namespace

extern "C" {

// One full-grid system on padded CUDA buffers (ops/cuda_gn_full.py sizes
// them and fixes the geometry: `lanes` live lanes, chunks of `chunk` cells
// dealt in turn to `n_ctas` CTAs of `threads` threads): partials (n_ctas, lanes, lanes) is
// scratch; gext (kp, kp) float64 and, when first != 0, cp_out (n_pad, 2)
// are written. Launches on `stream` without synchronising; returns the
// first cudaError_t of its launches (0 on success).
int fd_gn_full_f32(const void* vu, const void* vv, const void* y,
                   const void* aux, const void* dmask, void* cp_out,
                   void* partials, void* gext, int n_pad, int kp, int k,
                   int lanes, int nxp, int first, float hdx, float hdy,
                   int chunk, int n_ctas, int threads, void* stream) {
  return gn_full<float>(vu, vv, y, aux, dmask, cp_out, partials, gext, n_pad,
                        kp, k, lanes, nxp, first, hdx, hdy, chunk, n_ctas,
                        threads, stream);
}

int fd_gn_full_f64(const void* vu, const void* vv, const void* y,
                   const void* aux, const void* dmask, void* cp_out,
                   void* partials, void* gext, int n_pad, int kp, int k,
                   int lanes, int nxp, int first, double hdx, double hdy,
                   int chunk, int n_ctas, int threads, void* stream) {
  return gn_full<double>(vu, vv, y, aux, dmask, cp_out, partials, gext,
                         n_pad, kp, k, lanes, nxp, first, hdx, hdy, chunk,
                         n_ctas, threads, stream);
}

}  // extern "C"
