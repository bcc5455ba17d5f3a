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
// What bounds it: operations, and the chain. On the 250^2 bench mesh (n_p
// 1536, 95 modes, 96 live lanes) a system is ~30 MFLOP over the upper
// triangle of the live lanes, and 500 steps build ~1500 systems, each of
// which needs the whole Gram of the one before it: the steps and
// iterations of a trajectory run in sequence, so one trajectory can use
// only the SMs that share its Gram. The bytes (p6 4.7 MB f32, read from L2
// once a system) are far below the card's rate.
//
// How the design answers it (the geometry comes from the shape and the
// working type alone, never from the batch; ops/cuda_gn.traj_geometry is
// the cut of the cells and tiles over the cluster, for the tests):
//  * one trajectory on a thread block cluster of kCluster = 8 CTAs. The
//    cells go in chunks of 32 (ops/cuda_gn.TRAJ_CELLS) to the CTAs in turn;
//    each CTA builds its chunks' rows and sums their Gram, chunk by chunk
//    in the working type, into a float64 partial of the upper 8x8 tiles
//    (float32 at 192 lanes) in its shared memory;
//  * the partials meet in distributed shared memory: CTA r sums tiles r,
//    r + C, ... over the C partials, in rank order, in float64 (a
//    reduce-scatter), then every CTA copies every CTA's reduced tiles into
//    its own square Gram (an all-gather). Two cluster barriers a system,
//    none a chunk. Every CTA then runs the same CG on the same Gram and
//    updates its own copy of y, so nothing is broadcast;
//  * the step constant and init_norm come out of the first system of each
//    step, whose rows are built at the incoming state anyway: one pass over
//    p6 a system. init_norm's partial sums ride the first system's
//    reduction;
//  * each chunk's p6 rows (their live lanes) come into shared memory once,
//    in sub-chunks of `cells` cells (the most that fit), by the copy engine
//    (cp.async.bulk on an mbarrier), two stages deep so the next
//    sub-chunk arrives under the current one's products. A team of 8
//    threads takes a cell's six dot products from the staged rows, and the
//    rows A are built from the same copy;
//  * the products run over the live lanes (k + 1 rounded up to 16, not to
//    64): a thread owns an 8x8 tile of the upper triangle and reads its
//    two operands as 16-byte vectors; groups of one thread per tile split
//    the rows and add their tiles into the partial in turn, a fixed order.
//    FFMA/DFMA only, never tensor cores, so never TF32;
//  * the CG: every warp takes a slice of the columns of G p for 32 rows
//    (no dependent chain longer than k / slices); warp 0 holds x, r and
//    p and takes both dot products by shuffles: two block barriers an
//    iteration, where the one-thread-a-lane CG took five. (Every warp
//    holding all of x, r and p, for one barrier an iteration, was slower:
//    45 against 31 us a CG at 95 modes, PERF.md);
//  * a cluster barrier at the end keeps every CTA's shared memory alive
//    until the last remote read of it.
// The reductions run in a fixed order, so a trajectory's result is the
// same from run to run and whatever the batch.
// What holds it now (H100, PERF.md): ~70 us a system and ~40 us a CG at
// the bench shape, against 690 us a system on one SM before; left out one
// at a time, the products save ~34 us a system, the scalars and rows ~22,
// the reduce-scatter and all-gather ~15, the chunks' sums into the
// partial ~10, the two cluster barriers ~8. A cluster of 16 takes a
// single trajectory 23% faster but a 9-point sweep 47% slower (two waves
// of clusters on 132 SMs), so the cluster is 8.

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

constexpr int kCluster = 8;   // CTAs of a trajectory (ops/cuda_gn.TRAJ_CLUSTER)
constexpr int kChunk = 32;   // cells of a partial Gram (ops/cuda_gn.TRAJ_CELLS)
constexpr int kTile = 8;          // edge of a thread's register tile
constexpr int kLaneStep = 16;     // live lanes are a multiple
constexpr int kTeam = 8;          // threads that share a cell's dot products
constexpr int kCoef = 12;         // per cell: 10 weighted stencil terms, ru, rv
constexpr int kMaxGroup = 160;    // threads of a group of tiles
constexpr int kMaxPerLane = 6;    // CG entries a lane of warp 0 holds: 192
constexpr int kSharedLimit = 232448;

// the most threads of a CTA, the faster of two caps each, timed on an H100
// at 96 live lanes (PERF.md): the 8x8 accumulators and their operands need
// ~110 (f32) or ~150 (f64) registers
template <typename T> struct Threads;
template <> struct Threads<float> { static constexpr int value = 384; };
template <> struct Threads<double> { static constexpr int value = 192; };

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Byte offsets of the CTA's shared memory. The square Gram the CG reads
// shares its bytes with the partial: the partial is dead once the
// reduce-scatter has read it.
struct Layout {
  int gram, slice, stage, rows, coef, y, p, qpart, red, nrm, tij, bars, total;
  __host__ __device__ Layout(int lanes, int cells, int threads, int t,
                             int tg) {
    const int nt = lanes / kTile, n_tiles = nt * (nt + 1) / 2;
    const int ls = lanes + 16 / t;   // staged rows 16 bytes apart in the banks
    const int part = n_tiles * kTile * kTile * tg, square = lanes * lanes * t;
    gram = 0;
    slice = gram + round16(part > square ? part : square);
    stage = slice + round16((n_tiles + kCluster - 1) / kCluster * 64 * t);
    rows = stage + 2 * 6 * cells * ls * t;
    coef = rows + 2 * cells * ls * t;
    y = coef + round16(kCoef * cells * t);
    p = y + round16(lanes * t);
    qpart = p + round16(lanes * t);
    red = qpart + round16(threads * t);
    nrm = red + round16(32 * t);
    tij = nrm + 16;
    bars = tij + round16(2 * n_tiles);
    total = bars + 16;
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sum; every thread gets the same value. red: 32 values.
template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  __syncthreads();   // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = T(0);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += red[w];
  return total;
}

// sum over the cluster's CTAs, in rank order, in float64, of the value at
// `p` in each CTA's shared memory; every load is issued before the sum
template <typename TG>
__device__ __forceinline__ double cluster_sum(cg::cluster_group& cluster,
                                              TG* p) {
  TG v[kCluster];
#pragma unroll
  for (int c = 0; c < kCluster; ++c) v[c] = *cluster.map_shared_rank(p, c);
  double sum = 0.0;
#pragma unroll
  for (int c = 0; c < kCluster; ++c) sum += static_cast<double>(v[c]);
  return sum;
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

// `iters` masked CG steps on g[:k, :k] x = -g[k, :k] (g: lanes x lanes,
// symmetric, in shared memory), then y[:k] += x. Warp 0 holds x, r and p
// (lane owns i = lane + 32 m) and takes both dot products by shuffles;
// G p is taken by all threads, each a slice of the columns of one row,
// into qpart, which warp 0 sums in slice order. The iterate freezes once
// the residual or the curvature falls below the smallest normal number,
// as ops/solvers.cg_normal.
template <typename T>
__device__ void cluster_cg(const T* g, int lanes, int k, int iters, T* pv,
                           T* qpart, T* y) {
  const int tid = threadIdx.x, lane = tid & 31;
  const bool lead = tid < 32;
  const int rows_pad = (k + 31) / 32 * 32;
  const int n_slices = blockDim.x / rows_pad;
  const int slice_len = (k + n_slices - 1) / n_slices;
  const int row = tid % rows_pad, sl = tid / rows_pad;
  const int j0 = sl * slice_len;
  const int j1 = j0 + slice_len < k ? j0 + slice_len : k;
  T x[kMaxPerLane], r[kMaxPerLane], p[kMaxPerLane];
  T rs = T(0);
  if (lead) {
    T part = T(0);
#pragma unroll
    for (int m = 0; m < kMaxPerLane; ++m) {
      const int i = lane + 32 * m;
      const T b = i < k ? -g[k * lanes + i] : T(0);
      x[m] = T(0);
      r[m] = p[m] = b;
      if (i < lanes) pv[i] = b;
      part += b * b;
    }
    rs = warp_sum(part);
  }
  const T tiny = fdgn::tiny_normal<T>();
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    if (sl < n_slices && row < k) {
      T s0 = T(0), s1 = T(0);
      int j = j0;
#pragma unroll 4
      for (; j + 1 < j1; j += 2) {
        s0 += g[j * lanes + row] * pv[j];
        s1 += g[(j + 1) * lanes + row] * pv[j + 1];
      }
      if (j < j1) s0 += g[j * lanes + row] * pv[j];
      qpart[sl * rows_pad + row] = s0 + s1;
    }
    __syncthreads();
    if (lead) {
      T q[kMaxPerLane];
      T d = T(0);
#pragma unroll
      for (int m = 0; m < kMaxPerLane; ++m) {
        const int i = lane + 32 * m;
        T v = T(0);
        if (i < k) {
          for (int s = 0; s < n_slices; ++s) v += qpart[s * rows_pad + i];
        }
        q[m] = v;
        d += p[m] * v;
      }
      const T denom = warp_sum(d);
      const bool live = rs > tiny && denom > tiny;
      const T alpha = live ? rs / denom : T(0);
      T rr = T(0);
#pragma unroll
      for (int m = 0; m < kMaxPerLane; ++m) {
        x[m] += alpha * p[m];
        r[m] -= alpha * q[m];
        rr += r[m] * r[m];
      }
      const T rs_new = warp_sum(rr);
      const T beta = live ? rs_new / rs : T(0);
#pragma unroll
      for (int m = 0; m < kMaxPerLane; ++m) {
        const int i = lane + 32 * m;
        p[m] = r[m] + beta * p[m];
        if (i < lanes) pv[i] = p[m];
      }
      rs = rs_new;
    }
    __syncthreads();
  }
  if (lead) {
#pragma unroll
    for (int m = 0; m < kMaxPerLane; ++m) {
      const int i = lane + 32 * m;
      if (i < k) y[i] += x[m];
    }
  }
  __syncthreads();
}

// T: the working type; TG: the partial's; PASSES: 8x8 tiles a thread owns
template <typename T, typename TG, int PASSES>
__global__ void __launch_bounds__(Threads<T>::value, 1)
traj_kernel(const T* __restrict__ p6, const T* __restrict__ y0,
            const T* __restrict__ slbc, const T* __restrict__ wgt,
            T* __restrict__ cp, T* __restrict__ ys, int* __restrict__ stats,
            int n_p, int kp, int k, int lanes, int cells,
            int group_threads, T hdx, T hdy, int num_steps, int unroll_its,
            int solve_iters, T cutoff, T min_delta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / kCluster;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ls = lanes + kVec<T>;
  const int nt = lanes / kTile, n_tiles = nt * (nt + 1) / 2;
  const Layout lay(lanes, cells, nthreads, sizeof(T), sizeof(TG));
  TG* part = reinterpret_cast<TG*>(smem_raw + lay.gram);   // (8, 8, n_tiles)
  T* gram = reinterpret_cast<T*>(smem_raw + lay.gram);     // (lanes, lanes)
  T* slice = reinterpret_cast<T*>(smem_raw + lay.slice);
  T* stage0 = reinterpret_cast<T*>(smem_raw + lay.stage);  // [2][6][cells][ls]
  T* rows_a = reinterpret_cast<T*>(smem_raw + lay.rows);   // [2 cells][ls]
  T* coef = reinterpret_cast<T*>(smem_raw + lay.coef);     // [cells][kCoef]
  T* y = reinterpret_cast<T*>(smem_raw + lay.y);
  T* pv = reinterpret_cast<T*>(smem_raw + lay.p);
  T* qpart = reinterpret_cast<T*>(smem_raw + lay.qpart);
  T* red = reinterpret_cast<T*>(smem_raw + lay.red);
  double* nrm_part = reinterpret_cast<double*>(smem_raw + lay.nrm);
  unsigned char* tij = smem_raw + lay.tij;
  auto* bars = reinterpret_cast<unsigned long long*>(smem_raw + lay.bars);

  const T* slbc_b = slbc + b * n_p;
  T* cp_u = cp + b * 2 * n_p;
  T* cp_v = cp_u + n_p;
  T* ys_b = ys + b * num_steps * kp;
  const size_t blk = static_cast<size_t>(n_p) * kp;
  const T zero = T(0), one = T(1);
  const T qdx = T(0.5) * hdx, qdy = T(0.5) * hdy;
  const int spc = kChunk / cells;   // sub-chunks of a chunk

  if (tid == 0) {
    for (int ti = 0, t = 0; ti < nt; ++ti)
      for (int tj = ti; tj < nt; ++tj, ++t) {
        tij[2 * t] = static_cast<unsigned char>(ti);
        tij[2 * t + 1] = static_cast<unsigned char>(tj);
      }
    barrier_init(local_address(&bars[0]), 1);
    barrier_init(local_address(&bars[1]), 1);
    fdsync::barrier_init_fence();
  }
  for (int l = tid; l < lanes; l += nthreads)
    y[l] = l < k ? y0[b * kp + l] : zero;
  __syncthreads();

  // this thread's tiles of the upper triangle, and its group
  const int group = tid / group_threads;
  const int n_groups = nthreads / group_threads;
  int ti[PASSES], tj[PASSES];
  bool has[PASSES];
#pragma unroll
  for (int m = 0; m < PASSES; ++m) {
    const int t = tid % group_threads + m * group_threads;
    has[m] = t < n_tiles;
    ti[m] = has[m] ? tij[2 * t] : 0;
    tj[m] = has[m] ? tij[2 * t + 1] : 0;
  }

  // own sub-chunk j: chunk rank + (j / spc) * kCluster, its sub-chunk j % spc
  auto first_cell = [&](int j) {
    return (rank + (j / spc) * kCluster) * kChunk + (j % spc) * cells;
  };
  // the bulk copies of sub-chunk j's p6 rows (live lanes) into stage s
  const unsigned row_bytes = lanes * sizeof(T);
  auto stage_in = [&](int j, int s) {
    const int i0 = first_cell(j);
    const int valid = n_p - i0 < cells ? n_p - i0 : cells;
    T* dst = stage0 + s * 6 * cells * ls;
    const unsigned bar = local_address(&bars[s]);
    if (tid == 0) barrier_expect(bar, 6 * valid * row_bytes);
    // the copy engine writes what other threads have read: order it after
    // their reads, which a block barrier before this call has collected
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int e = tid; e < 6 * valid; e += nthreads) {
      const int pos = e / valid, c = e % valid;
      bulk_copy(dst + (pos * cells + c) * ls,
                p6 + pos * blk + static_cast<size_t>(i0 + c) * kp, row_bytes,
                bar);
    }
  };
  unsigned parity = 0;   // bit s: of stage s's next completion

  int its_total = 0, evals = 0;
  for (int t = 0; t < num_steps; ++t) {
    int it = 0;
    bool done = false;   // the same on every thread of every CTA
    T init_norm = zero, rn_prev = zero;
    for (int u = 0; u < unroll_its && !done; ++u) {
      const bool first = u == 0;   // also the step constant and init_norm
      __syncthreads();   // every reader of the last Gram (aliased) is done
      for (int e = tid; e < n_tiles * kTile * kTile; e += nthreads)
        part[e] = TG(0);
      T acc[PASSES][kTile][kTile];
#pragma unroll
      for (int m = 0; m < PASSES; ++m)
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int q = 0; q < kTile; ++q) acc[m][i][q] = zero;
      T nrm = zero;
      __syncthreads();

      if (first_cell(0) < n_p) stage_in(0, 0);
      for (int j = 0; first_cell(j) < n_p; ++j) {
        const int s = j & 1;
        const bool more = first_cell(j + 1) < n_p;
        if (more) stage_in(j + 1, s ^ 1);
        barrier_wait(local_address(&bars[s]), (parity >> s) & 1);
        parity ^= 1u << s;
        const int i0 = first_cell(j);
        const T* st = stage0 + s * 6 * cells * ls;

        // the scalars and the row coefficients, a team of 8 per cell; a
        // cell past n_p has no staged rows and all-zero coefficients
        for (int c = tid / kTeam; c < cells; c += nthreads / kTeam) {
          const int i = i0 + c;
          const bool valid = i < n_p;
          const T* const rws[6] = {
              st + c * ls, st + (cells + c) * ls, st + (2 * cells + c) * ls,
              st + (3 * cells + c) * ls, st + (4 * cells + c) * ls,
              st + (5 * cells + c) * ls};
          T sums[6];
          team_dots(rws, y, tid % kTeam, lanes, sums);
          if (tid % kTeam == 0) {
            alignas(16) T co[kCoef];
#pragma unroll
            for (int q = 0; q < kCoef; ++q) co[q] = zero;
            if (valid) {
              const T u_s = sums[0], u_w = sums[1], u_so = sums[2];
              const T v_s = sums[3], v_w = sums[4], v_so = sums[5];
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
              T cu, cv;
              if (first) {
                cu = -u_s + hf_u - slbc_b[i];
                cv = -v_s + hf_v;
                cp_u[i] = cu;
                cp_v[i] = cv;
              } else {
                cu = cp_u[i];
                cv = cp_v[i];
              }
              co[10] = (u_s + hf_u + cu) * w;
              co[11] = (v_s + hf_v + cv) * w;
              if (first) nrm += co[10] * co[10] + co[11] * co[11];
            }
            store_lanes(coef + kCoef * c, co);
          }
        }
        __syncthreads();

        // the rows: u rows 0..cells-1, v rows cells..2 cells-1, 16 bytes a
        // thread
        const int pieces = lanes / kVec<T>;
        for (int e = tid; e < cells * pieces; e += nthreads) {
          const int c = e / pieces, l0 = (e % pieces) * kVec<T>;
          const bool valid = i0 + c < n_p;
          alignas(16) T cf[kCoef];
          load_lanes(coef + kCoef * c, cf);
          alignas(16) T b0[kVec<T>], b1[kVec<T>], b2[kVec<T>];
          alignas(16) T b3[kVec<T>], b4[kVec<T>], b5[kVec<T>];
          alignas(16) T au[kVec<T>], av[kVec<T>];
          load_lanes(st + c * ls + l0, b0);
          load_lanes(st + (cells + c) * ls + l0, b1);
          load_lanes(st + (2 * cells + c) * ls + l0, b2);
          load_lanes(st + (3 * cells + c) * ls + l0, b3);
          load_lanes(st + (4 * cells + c) * ls + l0, b4);
          load_lanes(st + (5 * cells + c) * ls + l0, b5);
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
            } else if (l > k || !valid) {
              au[i] = av[i] = zero;
            }
          }
          store_lanes(rows_a + c * ls + l0, au);
          store_lanes(rows_a + (cells + c) * ls + l0, av);
        }
        __syncthreads();

        // this group's share of the rows into its tiles
        for (int r = group; r < 2 * cells; r += n_groups) {
#pragma unroll
          for (int m = 0; m < PASSES; ++m) {
            if (!has[m]) continue;
            alignas(16) T xa[kTile], za[kTile];
            load_lanes(rows_a + r * ls + ti[m] * kTile, xa);
            load_lanes(rows_a + r * ls + tj[m] * kTile, za);
#pragma unroll
            for (int i = 0; i < kTile; ++i)
#pragma unroll
              for (int q = 0; q < kTile; ++q) acc[m][i][q] += xa[i] * za[q];
          }
        }
        // a chunk's sums go into the partial, group after group
        if (j % spc == spc - 1 || !more) {
          for (int g = 0; g < n_groups; ++g) {
            if (group == g) {
#pragma unroll
              for (int m = 0; m < PASSES; ++m) {
                if (!has[m]) continue;
                TG* out = part + tid % group_threads + m * group_threads;
                // a row of the tile at a time, its loads before its stores:
                // the compiler cannot tell the strided elements apart
#pragma unroll
                for (int i = 0; i < kTile; ++i) {
                  TG sum[kTile];
#pragma unroll
                  for (int q = 0; q < kTile; ++q)
                    sum[q] = out[(i * kTile + q) * n_tiles];
#pragma unroll
                  for (int q = 0; q < kTile; ++q) {
                    out[(i * kTile + q) * n_tiles] =
                        sum[q] + static_cast<TG>(acc[m][i][q]);
                    acc[m][i][q] = zero;
                  }
                }
              }
            }
            __syncthreads();
          }
        }
      }
      if (first) {
        const T blk_nrm = block_sum(nrm, red);
        if (tid == 0) *nrm_part = static_cast<double>(blk_nrm);
      }

      // reduce-scatter: this CTA's tiles rank, rank + C, ... over every
      // CTA's partial, in rank order, in float64
      cluster.sync();
      const int own_tiles = (n_tiles - rank + kCluster - 1) / kCluster;
      for (int e = tid; e < own_tiles * kTile * kTile; e += nthreads) {
        const int at = (e % 64) * n_tiles + rank + (e / 64) * kCluster;
        slice[e] = static_cast<T>(cluster_sum(cluster, part + at));
      }
      if (first) {
        init_norm = sqrt(static_cast<T>(cluster_sum(cluster, nrm_part)));
        rn_prev = init_norm;
      }
      cluster.sync();
      // all-gather into the square Gram (over the dead partial), a few
      // remote loads in flight before their stores
      constexpr int kGather = 4;
      for (int e0 = tid; e0 < n_tiles * kTile * kTile;
           e0 += kGather * nthreads) {
        T v[kGather];
#pragma unroll
        for (int g = 0; g < kGather; ++g) {
          const int e = e0 + g * nthreads;
          const int tile = e / 64;
          v[g] = e < n_tiles * kTile * kTile
                     ? cluster.map_shared_rank(slice, tile % kCluster)
                           [(tile / kCluster) * 64 + e % 64]
                     : zero;
        }
#pragma unroll
        for (int g = 0; g < kGather; ++g) {
          const int e = e0 + g * nthreads;
          if (e >= n_tiles * kTile * kTile) break;
          const int tile = e / 64, w = e % 64;
          const int a = tij[2 * tile], c = tij[2 * tile + 1];
          const int gi = a * kTile + w / kTile, gj = c * kTile + w % kTile;
          gram[gi * lanes + gj] = v[g];
          if (a != c) gram[gj * lanes + gi] = v[g];
        }
      }
      __syncthreads();

      const T rn = sqrt(gram[k * lanes + k]);
      const bool stop = rn / init_norm < cutoff ||
                        (it > 0 && fabs(rn_prev - rn) / rn_prev < min_delta);
      ++evals;
      if (!stop) {
        cluster_cg(gram, lanes, k, solve_iters, pv, qpart, y);
        ++it;
      }
      rn_prev = rn;
      done = stop;
    }
    its_total += it;
    if (rank == 0) {
      for (int l = tid; l < kp; l += nthreads)
        ys_b[static_cast<size_t>(t) * kp + l] = l < k ? y[l] : zero;
    }
  }
  if (rank == 0 && tid == 0) {
    stats[2 * b] = its_total;
    stats[2 * b + 1] = evals;
  }
  cluster.sync();   // no CTA leaves while another may read its memory
}

// The geometry of one system, from the shape and the working type alone,
// never the batch: the live lanes, k + 1 rounded up to 16; one thread per
// 8x8 tile of their upper triangle in each group of threads (two tiles a
// thread above kMaxGroup tiles); as many groups as the thread cap holds;
// and the largest sub-chunk of staged cells that fits in shared memory
// (cells 0 if none does).
struct Geometry {
  int lanes, n_tiles, group, threads, passes, tg, cells, smem;
};

template <typename T>
Geometry geometry(int k) {
  Geometry g{};
  g.lanes = (k + kLaneStep) / kLaneStep * kLaneStep;
  const int nt = g.lanes / kTile;
  g.n_tiles = nt * (nt + 1) / 2;
  const int group = (g.n_tiles + 31) / 32 * 32;
  g.group = group < kMaxGroup ? group : kMaxGroup;
  const int groups = Threads<T>::value / g.group;
  g.threads = (groups > 1 ? groups : 1) * g.group;
  g.passes = (g.n_tiles + g.group - 1) / g.group;
  g.tg = g.lanes <= 128 ? 8 : 4;   // the partial's type: float64 to 128 lanes
  for (int c = kChunk; c >= 2 && g.cells == 0; c /= 2) {
    const int smem = Layout(g.lanes, c, g.threads, sizeof(T), g.tg).total;
    if (smem <= kSharedLimit && g.threads / kTeam >= c) {
      g.cells = c;
      g.smem = smem;
    }
  }
  return g;
}

template <typename T, typename TG, int PASSES>
cudaError_t launch(const T* p6, const T* y0, const T* slbc, const T* wgt,
                   T* cp, T* ys, int* stats, int batch, int n_p, int kp,
                   int k, const Geometry& g, T hdx, T hdy, int num_steps,
                   int unroll_its, int solve_iters, T cutoff, T min_delta,
                   cudaStream_t st) {
  auto kernel = traj_kernel<T, TG, PASSES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * kCluster));
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
  err = cudaLaunchKernelEx(&cfg, kernel, p6, y0, slbc, wgt, cp, ys, stats,
                           n_p, kp, k, g.lanes, g.cells, g.group, hdx, hdy,
                           num_steps, unroll_its, solve_iters, cutoff,
                           min_delta);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int gn_traj(const void* p6, const void* y0, const void* slbc,
            const void* wgt, void* cp, void* ys, void* stats, int batch,
            int n_p, int kp, int k, T hdx, T hdy, int num_steps,
            int unroll_its, int solve_iters, T cutoff, T min_delta,
            void* stream) {
  const int max_lanes = sizeof(T) == sizeof(float) ? 192 : 128;
  const Geometry g = geometry<T>(k);
  if (batch < 1 || n_p < 1 || k < 1 || g.lanes > kp ||
      g.lanes > max_lanes || kp % kVec<T> || g.cells == 0 || g.passes > 2 ||
      (k + 31) / 32 * 32 > g.threads || num_steps < 0 || unroll_its < 0 ||
      solve_iters < 0) {
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
  if (g.tg == 8) {
    if (g.passes == 1) {
      err = launch<T, double, 1>(a, b, c, w, o1, o2, o3, batch, n_p, kp, k,
                                 g, hdx, hdy, num_steps, unroll_its,
                                 solve_iters, cutoff, min_delta, st);
    }
  } else if constexpr (sizeof(T) == sizeof(float)) {
    // above 128 live lanes (float32 only): up to 300 tiles, two a thread,
    // and a float32 partial
    err = launch<T, float, 2>(a, b, c, w, o1, o2, o3, batch, n_p, kp, k, g,
                              hdx, hdy, num_steps, unroll_its, solve_iters,
                              cutoff, min_delta, st);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Whole trajectories of `batch` mu points, one thread block cluster of
// kCluster CTAs each: y0 (batch, kp) padded, slbc (batch, n_p), cp
// (batch, 2, n_p) scratch, ys (batch, num_steps, kp), stats (batch, 2)
// int32 [updates, systems built]. The kernel's geometry comes from k and
// the working type (geometry above). Launches on `stream` without
// synchronising; returns the cudaError_t of the launch.
int fd_gn_traj_f32(const void* p6, const void* y0, const void* slbc,
                   const void* wgt, void* cp, void* ys, void* stats,
                   int batch, int n_p, int kp, int k, float hdx, float hdy,
                   int num_steps, int unroll_its, int solve_iters,
                   float cutoff, float min_delta, void* stream) {
  return gn_traj<float>(p6, y0, slbc, wgt, cp, ys, stats, batch, n_p, kp, k,
                        hdx, hdy, num_steps, unroll_its, solve_iters, cutoff,
                        min_delta, stream);
}

int fd_gn_traj_f64(const void* p6, const void* y0, const void* slbc,
                   const void* wgt, void* cp, void* ys, void* stats,
                   int batch, int n_p, int kp, int k, double hdx,
                   double hdy, int num_steps, int unroll_its,
                   int solve_iters, double cutoff, double min_delta,
                   void* stream) {
  return gn_traj<double>(p6, y0, slbc, wgt, cp, ys, stats, batch, n_p, kp,
                         k, hdx, hdy, num_steps, unroll_its, solve_iters,
                         cutoff, min_delta, stream);
}

}  // extern "C"
