// Sampled-mesh (ECSW) Gauss-Newton system (B4) and fused step (B5), written
// by hand for Hopper (sm_90a): ONE launch each.
//
// fd_gn_sampled_system_* replaces
// finitedifference_tpu/ops/pallas_gn.py::_make_kernel (gn_system_pallas):
// from the six stencil-position basis blocks p6 (6, n_p, kp) of the
// factored HPROM (rom_factored.py), reduced coordinates y, the step
// constants cp (n_p, 2) and the ECSW weights w (n_p), it computes the
// scalars s_p = p6[p] y, the CN residual, the weighted rows
//   A_u[i] = [w_i (J_u V)_i | w_i ru_i],  A_v[i] = [w_i (J_v V)_i | w_i rv_i]
// and gext = sum_i A_u[i]^T A_u[i] + A_v[i]^T A_v[i] (kp, kp): the Gram,
// J^T W^2 r and ||W r||^2, zeros beyond lane k. Padded cells carry weight 0
// and vanish.
//
// fd_gn_sampled_step_* replaces pallas_gn.py::_make_step_kernel
// (gn_step_pallas, the engine pallas_hprom(ls_method="fused")): the same
// system, then `iters` masked conjugate-gradient steps on
// gext[:k, :k] dy = -gext[:k, k] in the working type (the iterate frozen
// once the residual or the curvature falls below the smallest normal
// number, as ops/solvers.cg_normal), writing out[0, :] = dy and
// out[1, 0] = ||W r||.
//
// What bounds it: nothing the card finds large. On the 250^2 bench mesh
// (1508 cells, 95 modes) a call needs ~3.5 MB (f32) and ~33 MFLOP over
// the live lanes, about 1 us at the card's rates; the launch, the chain
// of reductions and, in the step, the 24 dependent CG iterations set the
// pace.
//
// How the design answers it (the geometry comes from n_p, k and the working
// type alone; ops/cuda_gn.sampled_geometry is its twin for the tests):
//  * one launch of clusters of kCluster = 8 CTAs, at most kMaxClusters in
//    all (one wave on 132 SMs). The cells go in chunks of `cells` (16, fewer
//    only where a chunk's rows would pass kStageBytes) to the CTAs, chunk c
//    to CTA c mod (CTAs of a part);
//  * a chunk's six p6 rows (their live lanes: k + 1 rounded up to 16, not
//    to 64) come into shared memory by the copy engine (cp.async.bulk on an
//    mbarrier); teams of 8 threads take each cell's six dot products with
//    y from the staged rows, and the weighted rows are built in place over
//    them;
//  * a thread owns an 8x8 tile of the live lanes' upper triangle (FFMA /
//    DFMA, never tensor cores, so never TF32), groups of one thread a tile
//    split the rows; the groups' tiles are summed in group order into a
//    float64 partial over the dead staging buffer. More than kPartTiles
//    tiles (above 176 live lanes) are split into parts over blockIdx.y,
//    each part's clusters staging the same rows for their own tiles;
//  * no second pass: the partials meet in distributed shared memory (CTA r
//    sums row r of every tile over the cluster in rank order, in float64,
//    reading contiguous 16-byte pairs) and each CTA writes that slice to a
//    small float64 workspace; a ticket
//    (fence, then an atomic on a counter in the workspace) picks the last
//    cluster to finish, which sums the clusters' slices in cluster order,
//    resets the counter for the next call (and CUDA-graph replays), and
//    writes gext (the system) or the Gram, rounded to the working type,
//    into the shared memory of its CTA 0 (the step). No atomic sums the
//    Gram, so two runs are bit-equal;
//  * the step's CG keeps the Gram in that CTA's shared memory (columns past
//    what it holds, from 163 modes in float64, in the shared memory of the
//    cluster's other CTAs, read through DSMEM) and runs in kCgWarps = 4
//    warps, one per scheduler: each warp takes a quarter of the columns of
//    G p for all rows (p_j from its own copy of p) and its share of
//    p . G p, writes them to double-buffered slots, and after ONE barrier
//    every warp sums the slots in warp order and holds x, r and p itself
//    (the other dot product by shuffles).
// What holds it now (H100, PERF.md): a system ~16 us f32 / ~22 us f64 at
// the bench shape, of which the launch, the three cluster barriers and
// the ticket are about half; a CG iteration ~0.8 us (f32), its chain of
// two warp sums, two divisions and a barrier as much as its product. More
// CG warps, fewer, the Gram in registers, or 16-byte rows were all slower.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "gn_common.cuh"
#include "hopper_sync.cuh"

namespace {

namespace cg = cooperative_groups;
using fdgn::kVec;
using fdgn::load_lanes;
using fdgn::store_lanes;
using fdsync::barrier_expect;
using fdsync::barrier_init;
using fdsync::barrier_wait;
using fdsync::bulk_copy;
using fdsync::local_address;

constexpr int kCluster = 8;        // CTAs of a cluster (SAMPLED_CLUSTER)
constexpr int kMaxCells = 16;      // cells of a chunk (SAMPLED_MAX_CELLS)
constexpr int kStageBytes = 131072;  // a chunk's staged rows at most
constexpr int kMaxClusters = 16;   // one wave: 128 CTAs on 132 SMs
constexpr int kLaneStep = 16;      // live lanes are a multiple
constexpr int kMaxTileRows = 255;  // 8x8 tiles a side: 8-bit tile indices
constexpr int kTile = 8;           // edge of a thread's register tile
constexpr int kTeam = 8;           // threads that share a cell's dot products
constexpr int kCoef = 12;          // 10 weighted stencil terms, ru, rv
constexpr int kPartTiles = 256;    // tiles of a part: one a thread
constexpr int kCgWarps = 4;        // warps of the CG: one per scheduler
constexpr int kCgMaxRows = 8;      // CG rows a lane holds: k <= 256
constexpr int kMaxStepLanes = 256;  // the step's kp
constexpr int kSharedLimit = 232448;
constexpr int kMaxDevices = 64;

// the most threads of a CTA: the 8x8 accumulators of one tile need 64
// (f32) or 128 (f64) registers
template <typename T> struct Threads;
template <> struct Threads<float> { static constexpr int value = 384; };
template <> struct Threads<double> { static constexpr int value = 256; };

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Byte offsets of the CTA's shared memory. The first region holds in turn
// the staged rows (6 x cells x ls), the float64 partial (64 x part_tiles,
// element-major) with, for more than one group of threads, each group's
// tiles in T (groups x 64 x part_tiles) beside it, and, in the step's last
// cluster, the CG's Gram by columns: columns [0, c0) in CTA 0, followed
// there by b (k), G[k, k], the double-buffered column partials
// (2 x kCgWarps x lanes), each warp's copy of p (kCgWarps x lanes), the
// double-buffered shares of p . G p (2 x kCgWarps) and the addresses of
// the other columns (k - c0); c1 columns in each other CTA. The tail holds
// y, the cells' coefficients, the tile table, the mbarrier and the flag.
struct Layout {
  int c0, c1, y, coef, tij, bar, flag, total;
  __host__ __device__ Layout(int lanes, int k, int part_tiles, int n_tiles,
                             int groups, int t, bool step, int cells) {
    const int ls = lanes + 16 / t;   // staged rows 16 bytes apart in the banks
    int region = 6 * cells * ls * t;
    const int n_el = part_tiles * kTile * kTile;
    const int part = round16(n_el * 8) + (groups > 1 ? groups * n_el * t : 0);
    if (part > region) region = part;
    const int tail = round16(lanes * t) + round16(cells * kCoef * t) +
                     round16(2 * n_tiles) + 32;
    c0 = k;
    c1 = 0;
    if (step) {
      const int col = k * t;
      const int bufs = round16(k * t) + 16 + 3 * kCgWarps * lanes * t +
                       round16(2 * kCgWarps * t) + round16(8 * k);
      const int whole = round16(k * col) + bufs;
      if (whole + tail <= kSharedLimit) {
        if (whole > region) region = whole;
      } else {
        // the Gram spread over the cluster: as much shared memory as a
        // block has
        const int cap = (kSharedLimit - tail) / 16 * 16;
        if (cap > region) region = cap;
        c0 = (region - bufs - 16) / col;
        if (c0 < 0) c0 = 0;
        c1 = region / col;
      }
    }
    y = round16(region);
    coef = y + round16(lanes * t);
    tij = coef + round16(cells * kCoef * t);
    bar = tij + round16(2 * n_tiles);
    flag = bar + 16;
    total = flag + 16;
  }
  __host__ __device__ int cg_offset(int k, int t) const {
    return round16(c0 * k * t);
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a barrier of the first `threads` threads of the CTA only (the CG's warps)
__device__ __forceinline__ void cg_barrier(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// The six dot products of a cell's staged rows with y over the live lanes,
// split over the 8 threads of a team (8 aligned lanes of one warp); every
// thread of the team gets the sums.
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
  const unsigned mask = 0xffu << (threadIdx.x & 24);
#pragma unroll
  for (int off = kTeam / 2; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < 6; ++q)
      sums[q] += __shfl_xor_sync(mask, sums[q], off);
}

// `iters` masked CG steps on g x = b (g: k x k, symmetric, by columns:
// column j at g + j k, or with SPREAD at cols[j - c0] from j = c0; b: k;
// in shared memory) by the first kCgWarps warps; writes out[0, :kp] = x (zeros from
// k) and out[1, :kp] = [rn, 0, ...]. Lane l of every warp holds x, r and p
// at i = l + 32 m (m < ROWS = ceil(k / 32)), and each warp keeps its own
// copy of p in pw (warps x ldq). Warp w sums columns [w span, (w + 1) span)
// of g p into its slot of qpart (2 x warps x ldq) and its share of p . g p
// into dpart (2 x warps); after one barrier every warp sums the slots in
// warp order, so all warps hold the same iterate.
template <typename T, int ROWS, bool SPREAD>
__device__ void sampled_cg(const T* g, const T* const* cols, int c0,
                           const T* b, int k, int iters, T* qpart, T* dpart,
                           T* pw, int ldq, T rn, T* out, int kp) {
  constexpr int warps = kCgWarps;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (w >= warps) return;
  T* my_p = pw + w * ldq;
  T x[ROWS], r[ROWS], p[ROWS];
  T part = T(0);
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int i = lane + 32 * m;
    const T bi = i < k ? b[i] : T(0);
    x[m] = T(0);
    r[m] = p[m] = bi;
    part += bi * bi;
    if (i < k) my_p[i] = bi;
  }
  T rs = warp_sum(part);
  const T tiny = fdgn::tiny_normal<T>();
  const int span = (k + warps - 1) / warps;
  const int j0 = w * span;
  const int j1 = j0 + span < k ? j0 + span : k;
  __syncwarp();
  for (int it = 0; it < iters; ++it) {
    T* qp = qpart + (it & 1) * warps * ldq;
    T* dp = dpart + (it & 1) * warps;
    T acc[ROWS];
#pragma unroll
    for (int m = 0; m < ROWS; ++m) acc[m] = T(0);
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const T pj = my_p[j];
      // the spread Gram's address chain only where it is spread: a select
      // here costs every column a shared-memory load
      const T* gj = SPREAD && j >= c0 ? cols[j - c0] : g + j * k;
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int i = lane + 32 * m;
        if (i < k) acc[m] += gj[i] * pj;
      }
    }
    T dw = T(0);
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const int i = lane + 32 * m;
      if (i < k) qp[w * ldq + i] = acc[m];
      dw += p[m] * acc[m];
    }
    dw = warp_sum(dw);
    if (lane == 0) dp[w] = dw;
    cg_barrier(warps * 32);
    T q[ROWS];
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const int i = lane + 32 * m;
      T v = T(0);
      if (i < k) {
#pragma unroll
        for (int s = 0; s < warps; ++s) v += qp[s * ldq + i];
      }
      q[m] = v;
    }
    T denom = T(0);
#pragma unroll
    for (int s = 0; s < warps; ++s) denom += dp[s];
    const bool live = rs > tiny && denom > tiny;
    const T alpha = live ? rs / denom : T(0);
    T rr = T(0);
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      x[m] += alpha * p[m];
      r[m] -= alpha * q[m];
      rr += r[m] * r[m];
    }
    const T rs_new = warp_sum(rr);
    const T beta = live ? rs_new / rs : T(0);
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const int i = lane + 32 * m;
      p[m] = r[m] + beta * p[m];
      if (i < k) my_p[i] = p[m];
    }
    __syncwarp();
    rs = rs_new;
  }
  if (w == 0) {
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const int i = lane + 32 * m;
      if (i < k) out[i] = x[m];
    }
    for (int i = lane; i < kp; i += 32) {
      if (i >= k) out[i] = T(0);
      out[kp + i] = i == 0 ? rn : T(0);
    }
  }
}

// T: the working type; STEP: the fused step (the system and the CG) or
// the system alone. blockIdx.y is the part: tiles [part part_tiles,
// (part + 1) part_tiles) of the n_tiles of the upper triangle.
template <typename T, bool STEP>
__global__ void __launch_bounds__(Threads<T>::value, 1)
sampled_kernel(const T* __restrict__ p6, const T* __restrict__ y_in,
               const T* __restrict__ cp, const T* __restrict__ wgt,
               double* __restrict__ ws, int* __restrict__ counter,
               T* __restrict__ out, int n_p, int kp, int k, int lanes,
               int part_tiles, int group_threads, int cells, int n_clusters,
               T hdx, T hdy, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / kCluster;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ls = lanes + kVec<T>;
  const int nt = lanes / kTile, n_tiles = nt * (nt + 1) / 2;
  const int t0 = blockIdx.y * part_tiles;
  const int tp = n_tiles - t0 < part_tiles ? n_tiles - t0 : part_tiles;
  const Layout lay(lanes, k, part_tiles, n_tiles, nthreads / group_threads,
                   sizeof(T), STEP, cells);
  T* stage = reinterpret_cast<T*>(smem_raw);            // [6][cells][ls]
  double* part = reinterpret_cast<double*>(smem_raw);   // [64][tp]
  T* y = reinterpret_cast<T*>(smem_raw + lay.y);
  T* coef = reinterpret_cast<T*>(smem_raw + lay.coef);  // [cells][kCoef]
  unsigned char* tij = smem_raw + lay.tij;
  auto* bar = reinterpret_cast<unsigned long long*>(smem_raw + lay.bar);
  int* flag = reinterpret_cast<int*>(smem_raw + lay.flag);

  // the tile table, one row of tiles a thread: tile (ti, tj), ti <= tj, is
  // number ti nt - ti (ti - 1) / 2 + tj - ti
  for (int ti = tid; ti < nt; ti += nthreads) {
    const int base = ti * nt - ti * (ti - 1) / 2;
    for (int tj = ti; tj < nt; ++tj) {
      tij[2 * (base + tj - ti)] = static_cast<unsigned char>(ti);
      tij[2 * (base + tj - ti) + 1] = static_cast<unsigned char>(tj);
    }
  }
  if (tid == 0) {
    barrier_init(local_address(bar), 1);
    fdsync::barrier_init_fence();
  }
  for (int l = tid; l < lanes; l += nthreads) y[l] = l < k ? y_in[l] : T(0);
  __syncthreads();

  // this thread's tile of the part, and its group
  const int group = tid / group_threads;
  const int n_groups = nthreads / group_threads;
  const int my_t = tid % group_threads;
  const bool has = my_t < tp;
  const int ti = has ? tij[2 * (t0 + my_t)] : 0;
  const int tj = has ? tij[2 * (t0 + my_t) + 1] : 0;
  T acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[i][q] = T(0);

  const T zero = T(0), one = T(1);
  const T qdx = T(0.5) * hdx, qdy = T(0.5) * hdy;
  const size_t blk = static_cast<size_t>(n_p) * kp;
  const unsigned row_bytes = lanes * sizeof(T);
  const unsigned bar_addr = local_address(bar);
  const int n_chunks = (n_p + cells - 1) / cells;
  unsigned parity = 0;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int i0 = c * cells;
    const int valid = n_p - i0 < cells ? n_p - i0 : cells;
    if (tid == 0) barrier_expect(bar_addr, 6 * valid * row_bytes);
    // the copy engine writes what other threads have read: order it after
    // their reads, which the block barrier ending the last chunk collected
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int e = tid; e < 6 * valid; e += nthreads) {
      const int pos = e / valid, cc = e % valid;
      bulk_copy(stage + (pos * cells + cc) * ls,
                p6 + pos * blk + static_cast<size_t>(i0 + cc) * kp,
                row_bytes, bar_addr);
    }
    barrier_wait(bar_addr, parity);
    parity ^= 1u;

    // the scalars and the row coefficients, a team of 8 per cell; a cell
    // past n_p has no staged rows and all-zero coefficients
    for (int cc = tid / kTeam; cc < cells; cc += nthreads / kTeam) {
      const int i = i0 + cc;
      alignas(16) T co[kCoef];
#pragma unroll
      for (int q = 0; q < kCoef; ++q) co[q] = zero;
      if (cc < valid) {
        const T* const rws[6] = {
            stage + cc * ls, stage + (cells + cc) * ls,
            stage + (2 * cells + cc) * ls, stage + (3 * cells + cc) * ls,
            stage + (4 * cells + cc) * ls, stage + (5 * cells + cc) * ls};
        T s[6];
        team_dots(rws, y, tid % kTeam, lanes, s);
        const T u_s = s[0], u_w = s[1], u_so = s[2];
        const T v_s = s[3], v_w = s[4], v_so = s[5];
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
        const T ru = u_s + qdx * (u_s * u_s - u_w * u_w) +
                     qdy * (fuv - u_so * v_so) + cp[2 * i];
        const T rv = v_s + qdy * (v_s * v_s - v_so * v_so) +
                     qdx * (fuv - u_w * v_w) + cp[2 * i + 1];
        co[10] = ru * w;
        co[11] = rv * w;
      }
      if (tid % kTeam == 0) store_lanes(coef + kCoef * cc, co);
    }
    __syncthreads();

    // the rows, in place: u rows over position 0's rows, v rows over
    // position 1's, 16 bytes a thread
    const int pieces = lanes / kVec<T>;
    for (int e = tid; e < cells * pieces; e += nthreads) {
      const int cc = e / pieces, l0 = (e % pieces) * kVec<T>;
      const bool ok = cc < valid;
      alignas(16) T cf[kCoef];
      load_lanes(coef + kCoef * cc, cf);
      alignas(16) T b0[kVec<T>], b1[kVec<T>], b2[kVec<T>];
      alignas(16) T b3[kVec<T>], b4[kVec<T>], b5[kVec<T>];
      alignas(16) T au[kVec<T>], av[kVec<T>];
      load_lanes(stage + cc * ls + l0, b0);
      load_lanes(stage + (cells + cc) * ls + l0, b1);
      load_lanes(stage + (2 * cells + cc) * ls + l0, b2);
      load_lanes(stage + (3 * cells + cc) * ls + l0, b3);
      load_lanes(stage + (4 * cells + cc) * ls + l0, b4);
      load_lanes(stage + (5 * cells + cc) * ls + l0, b5);
#pragma unroll
      for (int i = 0; i < kVec<T>; ++i) {
        const int l = l0 + i;
        au[i] = cf[0] * b0[i] + cf[1] * b1[i] + cf[2] * b2[i] +
                cf[3] * b3[i] + cf[4] * b5[i];
        av[i] = cf[5] * b0[i] + cf[6] * b1[i] + cf[7] * b3[i] +
                cf[8] * b4[i] + cf[9] * b5[i];
        if (l == k) {
          au[i] = cf[10];
          av[i] = cf[11];
        }
        if (l > k || !ok) au[i] = av[i] = zero;
      }
      store_lanes(stage + cc * ls + l0, au);
      store_lanes(stage + (cells + cc) * ls + l0, av);
    }
    __syncthreads();

    // this group's share of the rows into its tiles
    if (has) {
      for (int r = group; r < 2 * cells; r += n_groups) {
        if (r % cells >= valid) continue;
        alignas(16) T xa[kTile], za[kTile];
        load_lanes(stage + r * ls + ti * kTile, xa);
        load_lanes(stage + r * ls + tj * kTile, za);
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int q = 0; q < kTile; ++q) acc[i][q] += xa[i] * za[q];
      }
    }
    __syncthreads();   // the staged rows are free for the next chunk
  }

  // the tiles into the float64 partial (over the staged rows): one group
  // straight in; more groups each into a region of their own in T beside
  // the partial, summed in group order by all threads
  const int n_el = kTile * kTile * tp;
  T* gpart = reinterpret_cast<T*>(smem_raw + round16(n_el * 8));
  if (has) {
    double* o = part + my_t;
    T* og = gpart + group * n_el + my_t;
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        if (n_groups == 1) {
          o[(i * kTile + q) * tp] = static_cast<double>(acc[i][q]);
        } else {
          og[(i * kTile + q) * tp] = acc[i][q];
        }
      }
  }
  __syncthreads();
  if (n_groups > 1) {
    for (int e = tid; e < n_el; e += nthreads) {
      T sum = gpart[e];
      for (int gr = 1; gr < n_groups; ++gr) sum += gpart[gr * n_el + e];
      part[e] = static_cast<double>(sum);
    }
    __syncthreads();
  }

  // reduce-scatter: CTA r takes row r of every tile of the part (the
  // partial's elements [8 r tp, 8 (r + 1) tp), contiguous), sums it over
  // the cluster's partials in rank order, in float64, two elements a
  // thread, into its slice of the workspace (slices 8 part_tiles apart)
  cluster.sync();
  const int slice = kTile * tp;
  const size_t stride = static_cast<size_t>(kTile) * part_tiles;
  const double* own = part + static_cast<size_t>(rank) * slice;
  double* mine =
      ws + ((static_cast<size_t>(blockIdx.y) * n_clusters + cl) * kCluster +
            rank) * stride;
  for (int e = 2 * tid; e < slice; e += 2 * nthreads) {
    double2 v[kCluster];
#pragma unroll
    for (int c = 0; c < kCluster; ++c)
      v[c] = *reinterpret_cast<const double2*>(
          cluster.map_shared_rank(own + e, c));
    double2 sum = make_double2(0.0, 0.0);
#pragma unroll
    for (int c = 0; c < kCluster; ++c) {
      sum.x += v[c].x;
      sum.y += v[c].y;
    }
    *reinterpret_cast<double2*>(mine + e) = sum;
  }
  __threadfence();
  cluster.sync();   // every read of the partials is done, the slices fenced

  if constexpr (!STEP) {
    // gext's zeros beyond the live lanes, by every CTA of the grid: the
    // last cluster writes the rest
    const long long total = static_cast<long long>(kp) * kp;
    const long long bid =
        static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
    const long long all =
        static_cast<long long>(gridDim.x) * gridDim.y * nthreads;
    for (long long e = bid * nthreads + tid; e < total; e += all) {
      const int i = static_cast<int>(e / kp), j = static_cast<int>(e % kp);
      if (i >= lanes || j >= lanes) out[e] = zero;
    }
  }

  // the ticket: the cluster that takes the last one sums all slices
  if (rank == 0 && tid == 0) {
    const int tickets = n_clusters * static_cast<int>(gridDim.y);
    const int last = atomicAdd(counter, 1) == tickets - 1;
    if (last) *counter = 0;   // every cluster has taken its ticket
    for (int c = 0; c < kCluster; ++c)
      *cluster.map_shared_rank(flag, c) = last;
  }
  cluster.sync();
  if (!*flag) return;
  __threadfence();

  // the last cluster: CTA r sums row r of every tile over the clusters'
  // slices, part by part, in cluster order, in float64, and rounds it to T
  const bool spread = STEP && lay.c0 < k;
  T* gram = reinterpret_cast<T*>(smem_raw);   // the Gram's columns here
  T* bvec = reinterpret_cast<T*>(smem_raw + lay.cg_offset(k, sizeof(T)));
  T* gkk = bvec + round16(k * sizeof(T)) / sizeof(T);
  auto place = [&](int i, int j, T v) {
    if constexpr (STEP) {
      if (i < k && j < k) {
        // column i: the first c0 in CTA 0, then c1 in each other CTA
        const int r = i < lay.c0 ? 0 : 1 + (i - lay.c0) / lay.c1;
        const int col = i < lay.c0 ? i : (i - lay.c0) % lay.c1;
        cluster.map_shared_rank(gram, r)[col * k + j] = v;
      } else if (i == k && j < k) {
        cluster.map_shared_rank(bvec, 0)[j] = -v;
      } else if (i == k && j == k) {
        *cluster.map_shared_rank(gkk, 0) = v;
      }
    } else {
      out[static_cast<size_t>(i) * kp + j] = v;
    }
  };
  const int n_parts = static_cast<int>(gridDim.y);
  for (int pt = 0; pt < n_parts; ++pt) {
    const int u0 = pt * part_tiles;
    const int up = n_tiles - u0 < part_tiles ? n_tiles - u0 : part_tiles;
    const double* base = ws + static_cast<size_t>(pt) * n_clusters *
                                  kCluster * stride;
    for (int e = 2 * tid; e < kTile * up; e += 2 * nthreads) {
      // every cluster's pair in flight, then summed in cluster order
      double2 v[kMaxClusters];
#pragma unroll
      for (int c = 0; c < kMaxClusters; ++c) {
        if (c < n_clusters) {
          v[c] = __ldcg(reinterpret_cast<const double2*>(
              base + (static_cast<size_t>(c) * kCluster + rank) * stride +
              e));
        }
      }
      double2 s = make_double2(0.0, 0.0);
#pragma unroll
      for (int c = 0; c < kMaxClusters; ++c) {
        if (c < n_clusters) {
          s.x += v[c].x;
          s.y += v[c].y;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = u0 + (e + h) % up;   // element (rank, q) of tile t
        const int q = (e + h) / up;
        const int a = tij[2 * t], b = tij[2 * t + 1];
        const int gi = a * kTile + rank, gj = b * kTile + q;
        const T val = static_cast<T>(h == 0 ? s.x : s.y);
        place(gi, gj, val);
        if (a != b) place(gj, gi, val);
      }
    }
  }
  if constexpr (STEP) {
    cluster.sync();   // the Gram is in place; the other CTAs are done
    if (rank != 0) {
      if (spread) cluster.sync();   // their columns live until the CG ends
      return;
    }
    T* qpart = gkk + 16 / sizeof(T);
    T* pw = qpart + 2 * kCgWarps * lanes;
    T* dpart = pw + kCgWarps * lanes;
    const T** cols = reinterpret_cast<const T**>(
        reinterpret_cast<unsigned char*>(dpart) +
        round16(2 * kCgWarps * sizeof(T)));
    if (spread) {
      for (int j = tid; j < k - lay.c0; j += nthreads)
        cols[j] = cluster.map_shared_rank(gram, 1 + j / lay.c1) +
                  static_cast<size_t>(j % lay.c1) * k;
      __syncthreads();
    }
    const T rn = sqrt(*gkk);
    // the CG with ROWS = ceil(k / 32) rows a lane, so no lane runs masked
    // rows; the Gram spreads only from k = 163 (fits), 6 rows a lane
#define FD_SAMPLED_CG(ROWS, SPREAD)                                         \
  case ROWS:                                                                \
    sampled_cg<T, ROWS, SPREAD>(gram, cols, lay.c0, bvec, k, iters, qpart,  \
                                dpart, pw, lanes, rn, out, kp);             \
    break;
    if (spread) {
      switch ((k + 31) / 32) {
        FD_SAMPLED_CG(6, true)
        FD_SAMPLED_CG(7, true)
        FD_SAMPLED_CG(kCgMaxRows, true)
      }
    } else {
      switch ((k + 31) / 32) {
        FD_SAMPLED_CG(1, false)
        FD_SAMPLED_CG(2, false)
        FD_SAMPLED_CG(3, false)
        FD_SAMPLED_CG(4, false)
        FD_SAMPLED_CG(5, false)
        FD_SAMPLED_CG(6, false)
        FD_SAMPLED_CG(7, false)
        FD_SAMPLED_CG(kCgMaxRows, false)
      }
    }
#undef FD_SAMPLED_CG
    if (spread) cluster.sync();
  }
}

// The geometry of one call, from n_p, k and the working type alone (its
// twin: ops/cuda_gn.sampled_geometry): the live lanes, k + 1 rounded up to
// 16; their upper triangle of 8x8 tiles in parts of at most kPartTiles;
// one thread per tile of a part in each group of threads, as many groups
// as the thread cap holds; chunks of `cells` cells (kMaxCells, halved
// while a chunk's rows pass kStageBytes), and one cluster for each
// kCluster of them, at most kMaxClusters over all parts (at least one a
// part).
struct Geometry {
  int lanes, n_tiles, n_parts, part_tiles, group, threads, cells, n_chunks,
      n_clusters, smem, ws_len;
  int c0, c1;
};

Geometry geometry(int n_p, int k, int itemsize, bool step) {
  Geometry g{};
  g.lanes = (k + kLaneStep) / kLaneStep * kLaneStep;
  const int nt = g.lanes / kTile;
  g.n_tiles = nt * (nt + 1) / 2;
  g.n_parts = (g.n_tiles + kPartTiles - 1) / kPartTiles;
  g.part_tiles = (g.n_tiles + g.n_parts - 1) / g.n_parts;
  g.group = (g.part_tiles + 31) / 32 * 32;
  const int cap = itemsize == 4 ? Threads<float>::value
                                : Threads<double>::value;
  g.threads = (cap / g.group > 1 ? cap / g.group : 1) * g.group;
  const int ls = g.lanes + 16 / itemsize;
  g.cells = kMaxCells;
  while (g.cells > 1 && 6 * g.cells * ls * itemsize > kStageBytes)
    g.cells /= 2;
  g.n_chunks = (n_p + g.cells - 1) / g.cells;
  const int clusters = (g.n_chunks + kCluster - 1) / kCluster;
  const int most = kMaxClusters / g.n_parts > 1 ? kMaxClusters / g.n_parts
                                                : 1;
  g.n_clusters = clusters < most ? clusters : most;
  const Layout lay(g.lanes, k, g.part_tiles, g.n_tiles, g.threads / g.group,
                   itemsize, step, g.cells);
  g.smem = lay.total;
  g.c0 = lay.c0;
  g.c1 = lay.c1;
  g.ws_len = g.n_parts * g.n_clusters * kCluster * kTile * g.part_tiles;
  return g;
}

bool fits(const Geometry& g, int k, bool step) {
  return g.lanes / kTile <= kMaxTileRows && g.smem <= kSharedLimit &&
         g.threads / kTeam >= g.cells && g.threads >= 32 * kCgWarps &&
         (!step || (k <= 32 * kCgMaxRows &&
                    (g.c0 >= k || (k > 5 * 32 &&
                                   g.c0 + (kCluster - 1) * g.c1 >= k))));
}

template <typename T, bool STEP>
cudaError_t launch(const T* p6, const T* y, const T* cp, const T* wgt,
                   double* ws, int* counter, T* out, int n_p, int kp, int k,
                   const Geometry& g, T hdx, T hdy, int iters,
                   cudaStream_t st) {
  auto kernel = sampled_kernel<T, STEP>;
  // once per instantiation and device, so that a CUDA-graph capture issues
  // no attribute call
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedLimit);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(g.n_clusters * kCluster),
                     static_cast<unsigned>(g.n_parts));
  cfg.blockDim = dim3(static_cast<unsigned>(g.threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(g.smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p6, y, cp, wgt, ws, counter, out,
                           n_p, kp, k, g.lanes, g.part_tiles, g.group,
                           g.cells, g.n_clusters, hdx, hdy, iters);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool STEP>
int gn_sampled(const void* p6, const void* y, const void* cp,
               const void* wgt, void* ws, void* counter, void* out, int n_p,
               int kp, int k, T hdx, T hdy, int iters, void* stream) {
  const int itemsize = static_cast<int>(sizeof(T));
  if (n_p < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(n_p, k, itemsize, STEP);
  if (g.lanes > kp || kp % kVec<T> || iters < 0 ||
      (STEP && kp > kMaxStepLanes) || !fits(g, k, STEP)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch<T, STEP>(
      static_cast<const T*>(p6), static_cast<const T*>(y),
      static_cast<const T*>(cp), static_cast<const T*>(wgt),
      static_cast<double*>(ws), static_cast<int*>(counter),
      static_cast<T*>(out), n_p, kp, k, g, hdx, hdy, iters,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// The weighted sampled system into gext (kp, kp) in the working type. ws:
// the float64 workspace of ws_len elements (fd_gn_sampled_geometry;
// ops/cuda_gn.SampledWorkspace), counter: an int32 that is 0 between
// calls. Launches on `stream` without synchronising; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape the kernel
// does not take).
int fd_gn_sampled_system_f32(const void* p6, const void* y, const void* cp,
                             const void* wgt, void* ws, void* counter,
                             void* gext, int n_p, int kp, int k, float hdx,
                             float hdy, void* stream) {
  return gn_sampled<float, false>(p6, y, cp, wgt, ws, counter, gext, n_p, kp,
                                  k, hdx, hdy, 0, stream);
}

int fd_gn_sampled_system_f64(const void* p6, const void* y, const void* cp,
                             const void* wgt, void* ws, void* counter,
                             void* gext, int n_p, int kp, int k, double hdx,
                             double hdy, void* stream) {
  return gn_sampled<double, false>(p6, y, cp, wgt, ws, counter, gext, n_p,
                                   kp, k, hdx, hdy, 0, stream);
}

// The same system, then `iters` CG steps: out (2, kp) gets dy in row 0
// and ||W r|| in row 1, lane 0.
int fd_gn_sampled_step_f32(const void* p6, const void* y, const void* cp,
                           const void* wgt, void* ws, void* counter,
                           void* out, int n_p, int kp, int k, float hdx,
                           float hdy, int iters, void* stream) {
  return gn_sampled<float, true>(p6, y, cp, wgt, ws, counter, out, n_p, kp,
                                 k, hdx, hdy, iters, stream);
}

int fd_gn_sampled_step_f64(const void* p6, const void* y, const void* cp,
                           const void* wgt, void* ws, void* counter,
                           void* out, int n_p, int kp, int k, double hdx,
                           double hdy, int iters, void* stream) {
  return gn_sampled<double, true>(p6, y, cp, wgt, ws, counter, out, n_p, kp,
                                  k, hdx, hdy, iters, stream);
}

// The kernel's geometry: out[0..10] = lanes, n_tiles, n_parts, part_tiles,
// group, threads, cells, n_chunks, n_clusters, shared bytes, workspace
// length (float64 elements); returns 1 if the kernel takes the shape.
int fd_gn_sampled_geometry(int n_p, int k, int itemsize, int step,
                           int* out) {
  if (n_p < 1 || k < 1 || (itemsize != 4 && itemsize != 8)) return 0;
  const Geometry g = geometry(n_p, k, itemsize, step != 0);
  const int v[11] = {g.lanes,    g.n_tiles,  g.n_parts, g.part_tiles,
                     g.group,    g.threads,  g.cells,   g.n_chunks,
                     g.n_clusters, g.smem,   g.ws_len};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return fits(g, k, step != 0) ? 1 : 0;
}

}  // extern "C"
