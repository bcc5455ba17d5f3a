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
// is 1536 steps in sequence. One CTA of ny_pad threads on one SM spent most
// of a step dispatching instructions (24 warps on 4 schedulers, half of them
// off the band) and the rest in a shared-memory exchange and a 24-warp
// barrier.
//
// How the exact solve (B1) answers it:
//  * the dependency is local: cell (d, r) needs (d-1, r) and (d-1, r-1).
//    The rows are cut into warps of 32, one row a lane, and the warps are
//    spread over a thread block cluster of 8 CTAs (3 warps a CTA at 750^2,
//    so every warp has a scheduler of its own). A warp walks its diagonals
//    alone: the west carry stays in the lane's registers, the south carry
//    comes from the lane below by __shfl_up_sync;
//  * only lane 0 needs another warp: the carry (du, dv, u, v) of the row
//    just below, one diagonal back. A warp walks its diagonals in blocks of
//    8 (f32) or 4 (f64), and the warp below posts the carries of a block,
//    when it has solved it, into a ring of 4 blocks in this warp's shared
//    memory, its own CTA's or, through distributed shared memory, the next
//    CTA's. The posts are st.async stores that count their bytes on the
//    block's mbarrier there, so the poster never waits for them; the reader
//    waits on that mbarrier once a block and takes the block's mail into
//    registers. Then it reports the block free the same way (an st.async
//    that completes the poster's `empty` mbarrier of that block), and the
//    poster waits on that before it uses the block again. There is no block
//    or cluster barrier in the loop: the warps run staggered, each as far
//    ahead as the ring lets it;
//  * a warp begins its walk up to 7 (3) diagonals before its first row
//    enters the band, so that its blocks start one diagonal after those of
//    the warp below: the carries one of its blocks needs are then exactly
//    one block of the warp below, and it looks at its mailbox once a block
//    and not once a diagonal;
//  * what did not work, measured at 750^2 f32 on an H100 (PERF.md): a post
//    per diagonal published with st.release.cluster and polled with
//    ld.acquire.cluster took 2.3 ms (the fence waits for the lane's global
//    stores to land); plain or volatile stores of tagged words 1.8 ms (a
//    store to another warp's shared memory holds up the poster's next
//    shared-memory load until it has landed); st.async with an mbarrier per
//    diagonal 0.69 ms; per block 0.49 ms; with the reciprocals, the shuffles
//    of the inputs and the mail taken out of the per-diagonal chain, branch-
//    free cells and 32-bit offsets, 0.34 ms;
//  * a warp works only on the diagonals where one of its rows is on the band
//    (at most nx + 38 of them); before and after it only writes its zeros;
//  * each lane loads the four inputs of the next block's diagonals into
//    registers before it solves the current block, so no load latency is on
//    the chain (cp.async of 4 bytes a lane cost more than it hid); the block
//    inverse depends only on u_d, v_d and is formed off the chain;
//  * every cell runs solve_cell_with, the same arithmetic in the same
//    order as solve_skewed_ref, each operation rounded as written, whatever
//    warp it falls in, and every hand-off is fixed by the shape: the
//    result does not depend on timing;
//  * any ny_pad up to 4096 is 128 warps, 16 a CTA.
// What holds it now: one warp alone on its scheduler takes ~0.17 us a
// diagonal (the dependent latency of its instructions, run in order with
// no other warp to hide it), ~0.22 us with the hand-off.
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
// runs on n_seg SMs at once, and the issue rate of those SMs: a diagonal
// is 24 warp-rows of ~50 instructions on one SM. The bytes (each input
// diagonal read by at most two segments) stay far below the card's rate.
// The first design (one CTA, one thread a row, a shared-memory exchange and a
// 768-thread barrier per diagonal) spent 0.58 us a diagonal.
//
// How the segment solve (B7) answers it: the TPU kernel packed the
// segments into (j_pad, n_seg, ny_pad) slabs to fill its sublanes; here
// each segment is one CTA on the (nd_pad, ny_pad) arrays as they are, so no
// pack or unpack copy is needed, and inside it B1's chain of warps, with
// no block barrier in the loop (measured at 750^2 on an H100, PERF.md):
//  * first a pass over all SMs forms every cell's block reciprocal: they
//    depend on a cell's own inputs alone, and on the chain they took a
//    quarter of a segment's time (0.165 -> 0.129 ms f32). Every operation
//    of a cell is rounded as written (Rn), so one segment with no overlap
//    gives B1's bits, though B1 forms the reciprocals inline;
//  * up to 768 rows, a lane holds 2 rows, r0 and r0 + 32, in 12 warps: one
//    warp per scheduler and 6 rows a lane left no other warp to hide a
//    warp's latencies, and the rows did not overlap (0.37 ms). Above 768
//    rows (launch_seg) a lane holds 2, 4 or 8 rows in 8 to 16 warps, with
//    blocks of fewer diagonals so that its inputs fit its registers; in
//    f64 these layouts are slower than the first design's one thread a
//    row, except at 1025-1536 rows. A warp's loads and stores of one row
//    are 128 contiguous bytes;
//  * the south carry comes from the lane below by a shuffle (lane 0 takes
//    lane 31's row one lower), the west carry stays in registers; the
//    warp's bottom row takes the carry of the warp below, whose lane 31
//    posts the block's top-row carries into a ring of 4 blocks in this
//    warp's shared memory and arrives on the block's mbarrier; the reader
//    waits once a block, takes the block into registers and frees it on a
//    second mbarrier. Blocks are 4 diagonals (f32) or 2 (f64); all warps
//    start on the segment's first diagonal, so the chain fills in
//    (warps - 1) blocks: 44 diagonals at 750^2, where the segment walks
//    256 (blocks of 8: 0.26 ms);
//  * as in B1, each lane loads the next block's inputs and reciprocals
//    while it solves the current one, and takes the row below's inputs
//    by shuffles before the chain. The addresses are clamped into the
//    arrays and the values never masked: a select on a load's result
//    waits for the load at once (0.17 ms of 0.38 when tried);
//  * every cell runs solve_cell_with, the same arithmetic in the same order
//    as solve_skewed_seg_ref, and every hand-off is fixed by the shape:
//    the result does not depend on timing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "hopper_sync.cuh"

namespace {

namespace cg = cooperative_groups;
using fdsync::barrier_expect;
using fdsync::barrier_init;
using fdsync::barrier_wait;
using fdsync::local_address;

constexpr int kSegMaxRows = 32 * 8 * 16;   // the segment solve: 4096 rows

// The block and the reciprocal of its determinant, every operation rounded
// as written: the compiler fuses a free a * b + c by what surrounds it, and
// B1 forms the reciprocal inline, B7 in a pass of its own, yet a cell must
// give the same bits in both. The fused multiply-adds are those the
// compiler made of the plain expressions in B1 (its outputs did not change,
// measured on an H100, PERF.md); 1 / x is the correctly rounded reciprocal.
// The right-hand sides and the solve stay plain expressions: both chains
// inline them from solve_cell_with. Spelled out in the reciprocal alone
// (the block left plain in the solve), B1 formed the block twice and took
// twice its time in f64.
template <typename T> struct Rn;
template <> struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  static __device__ __forceinline__ float inv(float a) {
    return __frcp_rn(a);
  }
};
template <> struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double fma(double a, double b,
                                               double c) {
    return __fma_rn(a, b, c);
  }
  static __device__ __forceinline__ double inv(double a) {
    return __drcp_rn(a);
  }
};

// The 2x2 block at (u, v):
//   [[1 + kx u + ky/2 v, ky/2 u], [kx/2 v, 1 + ky v + kx/2 u]]
template <typename T>
struct Block {
  T b11, b12, b21, b22;
  __device__ __forceinline__ Block(T u, T v, T kx, T ky) {
    using R = Rn<T>;
    const T hkx = R::mul(T(0.5), kx), hky = R::mul(T(0.5), ky);
    b11 = R::fma(hky, v, R::fma(kx, u, T(1)));
    b12 = R::mul(hky, u);
    b21 = R::mul(hkx, v);
    b22 = R::fma(hkx, u, R::fma(ky, v, T(1)));
  }
};

// One band cell: the block, the right-hand sides from the west carry (d-1,
// r) and the south carry (d-1, r-1), and the solve. The reciprocal of the
// determinant depends on the cell's inputs alone, so a caller may form it
// ahead of the chain (solve_cell_with).
template <typename T>
__device__ __forceinline__ T inverse_det(T u, T v, T kx, T ky) {
  using R = Rn<T>;
  const Block<T> b(u, v, kx, ky);
  return R::inv(R::fma(b.b11, b.b22, -R::mul(b.b12, b.b21)));
}

template <typename T>
__device__ __forceinline__ void solve_cell_with(T inv_det, T u, T v, T fu,
                                                T fv, T du_w, T dv_w, T u_w,
                                                T v_w, T du_s, T dv_s, T u_s,
                                                T v_s, T kx, T ky, T& du,
                                                T& dv) {
  const T half = T(0.5);
  const Block<T> b(u, v, kx, ky);
  const T rhs_u = fu + kx * u_w * du_w + half * ky * (v_s * du_s + u_s * dv_s);
  const T rhs_v = fv + half * kx * (v_w * du_w + u_w * dv_w) + ky * v_s * dv_s;
  du = (b.b22 * rhs_u - b.b12 * rhs_v) * inv_det;
  dv = (b.b11 * rhs_v - b.b21 * rhs_u) * inv_det;
}

// ----------------------------------------------------------------------
// B1: the exact solve, a chain of warps over a thread block cluster
// ----------------------------------------------------------------------

constexpr int kCluster = 8;     // CTAs of the one cluster (the portable size)
constexpr int kMaxWarps = 16;   // warps of a CTA: 8 * 16 * 32 = 4096 rows
constexpr int kRing = 4;        // blocks of posts a warp's mailbox holds

// A post is the carry (du, dv, u, v) of the poster's last row on one
// diagonal, as 64-bit words. kBlock: the diagonals a warp takes between two
// looks at its mailbox, which are also the diagonals whose inputs a lane
// holds in registers while the block before them is solved.
template <typename T> struct Post;
template <> struct Post<float> {
  static constexpr int n = 2;
  static constexpr int kBlock = 8;
  static __device__ __forceinline__ void pack(float du, float dv, float u,
                                              float v,
                                              unsigned long long (&w)[2]) {
    w[0] = (static_cast<unsigned long long>(__float_as_uint(dv)) << 32) |
           __float_as_uint(du);
    w[1] = (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
           __float_as_uint(u);
  }
  static __device__ __forceinline__ void unpack(
      const unsigned long long (&w)[2], float& du, float& dv, float& u,
      float& v) {
    du = __uint_as_float(static_cast<unsigned>(w[0]));
    dv = __uint_as_float(static_cast<unsigned>(w[0] >> 32));
    u = __uint_as_float(static_cast<unsigned>(w[1]));
    v = __uint_as_float(static_cast<unsigned>(w[1] >> 32));
  }
};
template <> struct Post<double> {
  static constexpr int n = 4;
  static constexpr int kBlock = 4;
  static __device__ __forceinline__ void pack(double du, double dv, double u,
                                              double v,
                                              unsigned long long (&w)[4]) {
    w[0] = static_cast<unsigned long long>(__double_as_longlong(du));
    w[1] = static_cast<unsigned long long>(__double_as_longlong(dv));
    w[2] = static_cast<unsigned long long>(__double_as_longlong(u));
    w[3] = static_cast<unsigned long long>(__double_as_longlong(v));
  }
  static __device__ __forceinline__ void unpack(
      const unsigned long long (&w)[4], double& du, double& dv, double& u,
      double& v) {
    du = __longlong_as_double(static_cast<long long>(w[0]));
    dv = __longlong_as_double(static_cast<long long>(w[1]));
    u = __longlong_as_double(static_cast<long long>(w[2]));
    v = __longlong_as_double(static_cast<long long>(w[3]));
  }
};

// A warp's mailbox, in its CTA's shared memory: a ring of kRing blocks of
// kBlock posts. The warp below writes ring with st.async, which counts its
// bytes on the block's mbarrier `full`; the warp above (the reader of this
// warp's posts) writes `done` the same way, which counts on `empty` and
// frees the block of its own ring for the next use.
template <typename T>
struct alignas(16) Mailbox {
  unsigned long long ring[kRing][Post<T>::kBlock][Post<T>::n];
  unsigned long long full[kRing];
  unsigned long long empty[kRing];
  unsigned long long done[kRing];
};

// Shared-memory accesses by 32-bit address. The waits read this CTA's
// window; posts and reports go to any CTA of the cluster (mapa maps a local
// address to the same offset in CTA `rank`).
__device__ __forceinline__ unsigned cluster_address(const void* p,
                                                    unsigned rank) {
  unsigned mapped;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(mapped) : "r"(local_address(p)), "r"(rank));
  return mapped;
}

// An asynchronous store of one word to (another) CTA's shared memory that
// counts its 8 bytes on the mbarrier `bar` there. The posting warp does not
// wait for it; a plain store to another CTA's shared memory holds up the
// warp's next shared-memory load until it has landed, 0.4 us a diagonal
// when tried, and a release fence waits for the lane's global stores too.
__device__ __forceinline__ void post_word(unsigned addr,
                                          unsigned long long v,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 "
      "[%0], %1, [%2];\n"
      :: "r"(addr), "l"(v), "r"(bar) : "memory");
}

// MAXW: the most warps a CTA is launched with; up to 8 leave a lane 255
// registers
template <typename T, int MAXW>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(32 * MAXW)
wavefront_exact_kernel(const T* __restrict__ su, const T* __restrict__ sv,
                       const T* __restrict__ sfu, const T* __restrict__ sfv,
                       T* __restrict__ sdu, T* __restrict__ sdv, int nx,
                       int ny, int nd_pad, int ny_pad, T kx, T ky) {
  constexpr int kWords = Post<T>::n;
  constexpr int kBlock = Post<T>::kBlock;
  constexpr unsigned kBlockBytes = 8 * kWords * kBlock;
  extern __shared__ __align__(16) unsigned char smem_raw[];   // mailboxes
  cg::cluster_group cluster = cg::this_cluster();
  const int wpc = blockDim.x / 32;
  const int wi = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = static_cast<int>(cluster.block_rank());
  const int gw = rank * wpc + wi;              // the warp's place in the chain
  const int n_warps = (ny_pad + 31) / 32;
  auto* boxes = reinterpret_cast<Mailbox<T>*>(smem_raw);
  Mailbox<T>* mine = boxes + wi;
  // every barrier takes one arrival, its waiter's, which also announces the
  // bytes to come: the first use of every block is expected at once
  if (lane == 0) {
    for (int i = 0; i < kRing; ++i) {
      barrier_init(local_address(&mine->full[i]), 1);
      barrier_init(local_address(&mine->empty[i]), 1);
    }
    fdsync::barrier_init_fence();
    for (int i = 0; i < kRing; ++i) {
      barrier_expect(local_address(&mine->full[i]), kBlockBytes);
      barrier_expect(local_address(&mine->empty[i]), 8);
    }
  }
  cluster.sync();   // every mailbox is set before anyone posts

  if (gw < n_warps) {
    const T zero = T(0);
    const int r0 = gw * 32, r = r0 + lane;
    const bool row_ok = r < ny_pad;
    // The diagonals this warp walks, [d_lo, d_hi): those where one of its
    // rows is on the band, begun up to kBlock - 1 diagonals early so that a
    // warp's blocks start one diagonal after those of the warp below: the
    // carries a block needs are then exactly one block of the warp below.
    const bool active = r0 < ny;
    const int r_hi = r0 + 31 < ny ? r0 + 31 : ny - 1;
    const int early = (kBlock - gw % kBlock) % kBlock;
    const int d_lo = active ? r0 - early : nd_pad;
    const int d_hi = active ? r_hi + nx : nd_pad;
    const int n_blocks = (d_hi - d_lo + kBlock - 1) / kBlock;
    // the warp below walks [d_lo - 1 - 32 + ..., r0 - 1 + nx): its blocks
    // start at below_lo, and block b of this warp reads its block
    // b + below_skip while that exists
    const bool reads = gw > 0 && active;
    const int below_early = (kBlock - (gw + kBlock - 1) % kBlock) % kBlock;
    const int below_lo = r0 - 32 - below_early;
    const int below_blocks = (r0 - 1 + nx - below_lo + kBlock - 1) / kBlock;
    const int below_skip = (d_lo - 1 - below_lo) / kBlock;
    // the warp above reads this warp's blocks from above_skip on, so only
    // those are posted
    const bool posts = r0 + 32 < ny;        // the warp above has a band row
    const int above_early = (kBlock - (gw + 1) % kBlock) % kBlock;
    const int above_skip = (r0 + 32 - above_early - 1 - d_lo) / kBlock;
    const unsigned my_full = local_address(mine->full);
    const unsigned my_empty = local_address(mine->empty);
    unsigned below_done = 0, below_empty = 0;   // where reads are reported
    unsigned above_ring = 0, above_full = 0;    // where the posts go
    if (reads) {
      const Mailbox<T>* box = wi > 0 ? boxes + wi - 1 : boxes + wpc - 1;
      const unsigned to = wi > 0 ? rank : rank - 1;
      below_done = cluster_address(box->done, to);
      below_empty = cluster_address(box->empty, to);
    }
    if (posts) {
      const Mailbox<T>* box = wi + 1 < wpc ? boxes + wi + 1 : boxes;
      const unsigned to = wi + 1 < wpc ? rank : rank + 1;
      above_ring = cluster_address(box->ring, to);
      above_full = cluster_address(box->full, to);
    }

    for (int d = 0; d < d_lo; ++d) {
      if (row_ok) {
        sdu[static_cast<size_t>(d) * ny_pad + r] = zero;
        sdv[static_cast<size_t>(d) * ny_pad + r] = zero;
      }
    }

    // inputs u, v, fu, fv at (d, r) of the kBlock diagonals from d0 on;
    // nd_pad * ny_pad elements are far below 2^31
    auto load_block = [&](int d0, T (&in)[4][kBlock]) {
      unsigned at = static_cast<unsigned>(d0) * ny_pad + r;
#pragma unroll
      for (int i = 0; i < kBlock; ++i, at += ny_pad) {
        const bool ok = row_ok && d0 + i < d_hi;
        in[0][i] = ok ? su[at] : zero;
        in[1][i] = ok ? sv[at] : zero;
        in[2][i] = ok ? sfu[at] : zero;
        in[3][i] = ok ? sfv[at] : zero;
      }
    };
    T cur[4][kBlock], nxt[4][kBlock];
    load_block(d_lo, cur);

    T du_p = zero, dv_p = zero, u_p = zero, v_p = zero;   // diagonal d-1
    for (int b = 0; b < n_blocks; ++b) {
      const int d0 = d_lo + b * kBlock;
      load_block(d0 + kBlock, nxt);
      const unsigned slot = b % kRing;   // of this block's mail
      const bool sends = posts && b >= above_skip;
      const unsigned to_slot = (b - above_skip) % kRing;
      const unsigned to_use = (b - above_skip) / kRing;
      // the block of the warp below that holds this block's south carries:
      // lane 0 waits for it and takes it into registers
      const int from = b + below_skip;
      const bool has_mail = reads && from < below_blocks;
      unsigned long long mail[kBlock][kWords];
#pragma unroll
      for (int i = 0; i < kBlock; ++i)
#pragma unroll
        for (int q = 0; q < kWords; ++q) mail[i][q] = 0;
      if (lane == 0 && has_mail) {
        barrier_wait(my_full + 8 * slot, (b / kRing) & 1);
#pragma unroll
        for (int i = 0; i < kBlock; ++i)
#pragma unroll
          for (int q = 0; q < kWords; ++q) {
            mail[i][q] = *static_cast<const volatile unsigned long long*>(
                &mine->ring[slot][i][q]);
          }
        barrier_expect(my_full + 8 * slot, kBlockBytes);   // its next use
        // the mail is read: its block of the ring is free again
        post_word(below_done + 8 * slot, 0, below_empty + 8 * slot);
      }

      // ahead of the chain, for the whole block: the reciprocals of the
      // determinants, and the inputs of the row below one diagonal back
      // (lane 0 takes them from its mail instead)
      T inv[kBlock], us[kBlock], vs[kBlock];
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
        inv[i] = inverse_det(cur[0][i], cur[1][i], kx, ky);
        us[i] = __shfl_up_sync(0xffffffffu, i ? cur[0][i - 1] : u_p, 1);
        vs[i] = __shfl_up_sync(0xffffffffu, i ? cur[1][i - 1] : v_p, 1);
      }

      T du_b[kBlock], dv_b[kBlock];   // this block's results, for the posts
      unsigned at = static_cast<unsigned>(d0) * ny_pad + r;
#pragma unroll
      for (int i = 0; i < kBlock; ++i, at += ny_pad) {
        const int d = d0 + i;
        const T u = cur[0][i], v = cur[1][i], fu = cur[2][i], fv = cur[3][i];
        const bool on = r < ny && r <= d && d - r < nx;

        T du_s = __shfl_up_sync(0xffffffffu, du_p, 1);
        T dv_s = __shfl_up_sync(0xffffffffu, dv_p, 1);
        T u_s = us[i], v_s = vs[i];
        if (lane == 0) Post<T>::unpack(mail[i], du_s, dv_s, u_s, v_s);

        T du, dv;
        solve_cell_with(inv[i], u, v, fu, fv, du_p, dv_p, u_p, v_p, du_s,
                        dv_s, u_s, v_s, kx, ky, du, dv);
        du = on ? du : zero;
        dv = on ? dv : zero;
        if (row_ok && d < d_hi) {
          sdu[at] = du;
          sdv[at] = dv;
        }
        du_b[i] = du_p = du;
        dv_b[i] = dv_p = dv;
        u_p = u;
        v_p = v;
      }

      // the block's carries go up in one go: the warp above waits for the
      // whole block anyway. Its block of the ring is free once the reader
      // has reported the use before.
      if (lane == 31 && sends) {
        if (to_use > 0) {
          barrier_wait(my_empty + 8 * to_slot, (to_use - 1) & 1);
          barrier_expect(my_empty + 8 * to_slot, 8);
        }
#pragma unroll
        for (int i = 0; i < kBlock; ++i) {
          unsigned long long w[kWords];
          Post<T>::pack(du_b[i], dv_b[i], cur[0][i], cur[1][i], w);
#pragma unroll
          for (int q = 0; q < kWords; ++q) {
            post_word(above_ring + 8 * ((to_slot * kBlock + i) * kWords + q),
                      w[q], above_full + 8 * to_slot);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kBlock; ++i) {
#pragma unroll
        for (int a = 0; a < 4; ++a) cur[a][i] = nxt[a][i];
      }
    }

    // every post has been read before this warp's CTA may leave
    if (lane == 31 && posts) {
      const int sent = n_blocks - above_skip;
      for (int pb = sent > kRing ? sent - kRing : 0; pb < sent; ++pb)
        barrier_wait(my_empty + 8 * (pb % kRing), (pb / kRing) & 1);
    }
    for (int d = d_hi; d < nd_pad; ++d) {
      if (row_ok) {
        sdu[static_cast<size_t>(d) * ny_pad + r] = zero;
        sdv[static_cast<size_t>(d) * ny_pad + r] = zero;
      }
    }
  }
  cluster.sync();   // no CTA leaves while another may still write to it
}

template <typename T>
int launch_exact(const void* su, const void* sv, const void* sfu,
                 const void* sfv, void* sdu, void* sdv, int nx, int ny,
                 int nd_pad, int ny_pad, T kx, T ky, void* stream) {
  if (nx < 1 || ny < 1 || ny > ny_pad || nd_pad < nx + ny - 1 ||
      ny_pad > 32 * kMaxWarps * kCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_warps = (ny_pad + 31) / 32;
  const int wpc = (n_warps + kCluster - 1) / kCluster;
  const size_t smem = wpc * sizeof(Mailbox<T>);
  auto kernel = wpc <= 8 ? wavefront_exact_kernel<T, 8>
                         : wavefront_exact_kernel<T, kMaxWarps>;
  kernel<<<kCluster, 32 * wpc, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(su), static_cast<const T*>(sv),
      static_cast<const T*>(sfu), static_cast<const T*>(sfv),
      static_cast<T*>(sdu), static_cast<T*>(sdv), nx, ny, nd_pad, ny_pad, kx,
      ky);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------------
// B7: the overlapping-segment solve, one CTA of chained warps per segment
// ----------------------------------------------------------------------

constexpr int kSegRing = 4;    // blocks of posts a warp's mailbox holds

// A warp's mailbox for the segment solve: the warp below posts the carries
// (du, dv, u, v) of its top row on the K diagonals of a block into a block
// of the ring and arrives on `full`; this warp takes the block into
// registers and arrives on `empty`, which frees it for the block kSegRing
// later.
template <typename T, int K>
struct alignas(16) SegMailbox {
  T ring[kSegRing][K][4];
  unsigned long long full[kSegRing];
  unsigned long long empty[kSegRing];
};

// a plain arrival (release at CTA scope) on a barrier of this CTA
__device__ __forceinline__ void barrier_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// The reciprocals of every cell's block determinant, inv = 1 / det B(u, v),
// formed for the whole field at once, all SMs in parallel, before the
// chains: they depend on a cell's own inputs alone, and on the chain they
// cost a segment's warps over a quarter of their time (PERF.md).
template <typename T>
__global__ void __launch_bounds__(256)
seg_inverse_kernel(const T* __restrict__ su, const T* __restrict__ sv,
                   T* __restrict__ sinv, int n, T kx, T ky) {
  for (int e = blockIdx.x * 256 + threadIdx.x; e < n; e += gridDim.x * 256)
    sinv[e] = inverse_det(su[e], sv[e], kx, ky);
}

// R: the rows a lane holds; K: the diagonals of a block; MAXW: the most
// warps a CTA is launched with
template <typename T, int R, int K, int MAXW>
__global__ void __launch_bounds__(32 * MAXW)
wavefront_seg_kernel(const T* __restrict__ su, const T* __restrict__ sv,
                     const T* __restrict__ sfu, const T* __restrict__ sfv,
                     const T* __restrict__ sinv, T* __restrict__ sdu,
                     T* __restrict__ sdv, int nx, int ny, int nd_pad,
                     int ny_pad, T kx, T ky, int seg_len, int overlap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];   // mailboxes
  // this CTA's segment: owned diagonals [d_own, d_end), warm-up from d_begin
  const int d_own = blockIdx.x * seg_len;
  const int d_begin = d_own - overlap > 0 ? d_own - overlap : 0;
  const int d_end = d_own + seg_len < nd_pad ? d_own + seg_len : nd_pad;
  if (d_own >= d_end) return;   // a trailing segment owns nothing

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  auto* boxes = reinterpret_cast<SegMailbox<T, K>*>(smem_raw);
  SegMailbox<T, K>* mine = boxes + w;
  if (lane == 0) {
    for (int i = 0; i < kSegRing; ++i) {
      barrier_init(local_address(&mine->full[i]), 1);
      barrier_init(local_address(&mine->empty[i]), 1);
    }
    fdsync::barrier_init_fence();
  }
  __syncthreads();   // every mailbox is set before anyone posts

  const T zero = T(0);
  // this lane's rows: r0 + 32 j, j < R, so that a warp's loads and stores
  // of one j are 128 contiguous bytes
  const int r0 = w * 32 * R + lane;
  const bool reads = w > 0;             // the row below r0 is in the warp below
  const bool posts = w + 1 < n_warps;   // the warp above reads its top row
  SegMailbox<T, K>* above = posts ? boxes + w + 1 : boxes;
  const unsigned my_full = local_address(mine->full);
  const unsigned my_empty = local_address(mine->empty);
  const unsigned above_full = local_address(above->full);
  const unsigned above_empty = local_address(above->empty);

  // inputs u, v, fu, fv and the reciprocal of this lane's rows on the K
  // diagonals from d0.
  // The address is clamped into the arrays, never the value masked, so no
  // instruction waits on a load before its use: rows past ny_pad are off
  // the band (their results are zeros, and only rows above them read their
  // carries), and diagonals past the segment are never solved.
  // nd_pad * ny_pad is far below 2^31.
  unsigned row_at[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    row_at[j] = r0 + 32 * j < ny_pad ? r0 + 32 * j : ny_pad - 1;
  auto load_block = [&](int d0, T (&in)[5][R][K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const unsigned at =
          static_cast<unsigned>(d0 + i < nd_pad ? d0 + i : nd_pad - 1) *
          ny_pad;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        in[0][j][i] = su[at + row_at[j]];
        in[1][j][i] = sv[at + row_at[j]];
        in[2][j][i] = sfu[at + row_at[j]];
        in[3][j][i] = sfv[at + row_at[j]];
        in[4][j][i] = sinv[at + row_at[j]];
      }
    }
  };
  // the row below row j of this lane: the lane below; for lane 0, lane
  // 31's row one j lower (and for j = 0 the warp below, taken from the
  // mail instead)
  const int below = (lane + 31) & 31;
  auto from_below = [&](const T (&x)[R], int j) {
    return __shfl_sync(0xffffffffu, lane == 31 && j ? x[j ? j - 1 : 0] : x[j],
                       below);
  };

  T du_p[R], dv_p[R], u_p[R], v_p[R];   // diagonal d - 1, this lane's rows
#pragma unroll
  for (int j = 0; j < R; ++j) du_p[j] = dv_p[j] = u_p[j] = v_p[j] = zero;
  // the carry of the warp below's top row on the diagonal before the block
  // (zero before the warm-up and below row 0)
  T last[4] = {zero, zero, zero, zero};
  T cur[5][R][K], nxt[5][R][K];
  load_block(d_begin, cur);

  const int n_blocks = (d_end - d_begin + K - 1) / K;
  for (int m = 0; m < n_blocks; ++m) {
    const int d0 = d_begin + m * K;
    const int n_diag = d_end - d0 < K ? d_end - d0 : K;
    const unsigned slot = m % kSegRing;
    load_block(d0 + K, nxt);
    // lane 0 takes the block's mail: the warp below's top row on d0 .. d0
    // + K - 1; diagonal d0 + i needs the one before it
    T mail[K][4];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) mail[i][q] = zero;
    if (lane == 0 && reads) {
      barrier_wait(my_full + 8 * slot, (m / kSegRing) & 1);
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) mail[i][q] = mine->ring[slot][i][q];
      barrier_arrive(my_empty + 8 * slot);   // the block is free again
    }

    // ahead of the chain, for the whole block: the inputs of the row below
    // one diagonal back
    T us[R][K], vs[R][K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      T cu[R], cv[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        cu[j] = i ? cur[0][j][i - 1] : u_p[j];
        cv[j] = i ? cur[1][j][i - 1] : v_p[j];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        us[j][i] = from_below(cu, j);
        vs[j][i] = from_below(cv, j);
      }
      if (lane == 0) {
        us[0][i] = i ? mail[i - 1][2] : last[2];
        vs[0][i] = i ? mail[i - 1][3] : last[3];
      }
    }

    T du_b[K], dv_b[K];   // the top row's results, for the posts
    const bool own0 = d0 >= d_own;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i >= n_diag) break;
      const int d = d0 + i;
      T s_du[R], s_dv[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s_du[j] = from_below(du_p, j);
        s_dv[j] = from_below(dv_p, j);
      }
      if (lane == 0) {
        s_du[0] = i ? mail[i - 1][0] : last[0];
        s_dv[0] = i ? mail[i - 1][1] : last[1];
      }
      const bool own_d = own0 || d >= d_own;
      const unsigned at = static_cast<unsigned>(d) * ny_pad + r0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = r0 + 32 * j;
        const bool on = r < ny && r <= d && d - r < nx;
        T du, dv;
        solve_cell_with(cur[4][j][i], cur[0][j][i], cur[1][j][i],
                        cur[2][j][i], cur[3][j][i], du_p[j], dv_p[j], u_p[j],
                        v_p[j], s_du[j], s_dv[j], us[j][i], vs[j][i], kx, ky,
                        du, dv);
        du = on ? du : zero;
        dv = on ? dv : zero;
        if (own_d && r < ny_pad) {
          sdu[at + 32 * j] = du;
          sdv[at + 32 * j] = dv;
        }
        du_p[j] = du;
        dv_p[j] = dv;
        u_p[j] = cur[0][j][i];
        v_p[j] = cur[1][j][i];
      }
      du_b[i] = du_p[R - 1];
      dv_b[i] = dv_p[R - 1];
    }
    // only the last block is short, and nothing reads `last` after it
#pragma unroll
    for (int q = 0; q < 4; ++q) last[q] = mail[K - 1][q];

    // the block's carries go up in one go: the warp above waits for the
    // whole block anyway. Its block of the ring is free once the reader
    // has taken the block kSegRing before.
    if (lane == 31 && posts) {
      if (m >= kSegRing)
        barrier_wait(above_empty + 8 * slot, (m / kSegRing - 1) & 1);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i >= n_diag) break;
        T* post = above->ring[slot][i];
        post[0] = du_b[i];
        post[1] = dv_b[i];
        post[2] = cur[0][R - 1][i];
        post[3] = cur[1][R - 1][i];
      }
      barrier_arrive(above_full + 8 * slot);
    }
#pragma unroll
    for (int a = 0; a < 5; ++a)
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int i = 0; i < K; ++i) cur[a][j][i] = nxt[a][j][i];
  }
}

template <typename T, int R, int K, int MAXW>
cudaError_t launch_rows(const T* su, const T* sv, const T* sfu, const T* sfv,
                        const T* sinv, T* sdu, T* sdv, int nx, int ny,
                        int nd_pad, int ny_pad, T kx, T ky, int n_seg,
                        int seg_len, int overlap, cudaStream_t stream) {
  const int warps = (ny_pad + 32 * R - 1) / (32 * R);
  wavefront_seg_kernel<T, R, K, MAXW>
      <<<n_seg, 32 * warps, warps * sizeof(SegMailbox<T, K>), stream>>>(
          su, sv, sfu, sfv, sinv, sdu, sdv, nx, ny, nd_pad, ny_pad, kx, ky,
          seg_len, overlap);
  return cudaGetLastError();
}

template <typename T>
int launch_seg(const void* su, const void* sv, const void* sfu,
               const void* sfv, void* sinv, void* sdu, void* sdv, int nx,
               int ny, int nd_pad, int ny_pad, T kx, T ky, int n_seg,
               int overlap, void* stream) {
  if (nx < 1 || ny < 1 || ny > ny_pad || nd_pad < 1 || n_seg < 1 ||
      n_seg > nd_pad || overlap < 0 || ny_pad > kSegMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int seg_len = (nd_pad + n_seg - 1) / n_seg;
  const auto* a = static_cast<const T*>(su);
  const auto* b = static_cast<const T*>(sv);
  const auto* c = static_cast<const T*>(sfu);
  const auto* e = static_cast<const T*>(sfv);
  auto* inv = static_cast<T*>(sinv);
  auto* o1 = static_cast<T*>(sdu);
  auto* o2 = static_cast<T*>(sdv);
  auto s = static_cast<cudaStream_t>(stream);
  const int n = nd_pad * ny_pad;
  seg_inverse_kernel<T><<<(n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024,
                          256, 0, s>>>(a, b, inv, n, kx, ky);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // up to 768 rows (750^2): 2 rows a lane in up to 12 warps, the carries
  // handed up every 4 diagonals (f32) or 2 (f64: twice the registers); up
  // to 1024, 2 rows in 16 warps, every 2 (1); up to 1536, 4 rows in up to
  // 12 warps, every 2 (1); up to 2048, 8 rows in up to 8 warps (255
  // registers a lane), every diagonal; above, 8 rows in up to 16 warps,
  // which spill in f64 (PERF.md has the times of each band)
  constexpr int kMainK = sizeof(T) == sizeof(float) ? 4 : 2;
  if (ny_pad <= 32 * 2 * 12) {
    err = launch_rows<T, 2, kMainK, 12>(a, b, c, e, inv, o1, o2, nx, ny,
                                        nd_pad, ny_pad, kx, ky, n_seg,
                                        seg_len, overlap, s);
  } else if (ny_pad <= 32 * 2 * 16) {
    err = launch_rows<T, 2, kMainK / 2, 16>(a, b, c, e, inv, o1, o2, nx, ny,
                                            nd_pad, ny_pad, kx, ky, n_seg,
                                            seg_len, overlap, s);
  } else if (ny_pad <= 32 * 4 * 12) {
    err = launch_rows<T, 4, kMainK / 2, 12>(a, b, c, e, inv, o1, o2, nx, ny,
                                            nd_pad, ny_pad, kx, ky, n_seg,
                                            seg_len, overlap, s);
  } else if (ny_pad <= 32 * 8 * 8) {
    err = launch_rows<T, 8, 1, 8>(a, b, c, e, inv, o1, o2, nx, ny, nd_pad,
                                  ny_pad, kx, ky, n_seg, seg_len, overlap, s);
  } else {
    err = launch_rows<T, 8, 1, 16>(a, b, c, e, inv, o1, o2, nx, ny, nd_pad,
                                   ny_pad, kx, ky, n_seg, seg_len, overlap,
                                   s);
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
  return launch_exact<float>(su, sv, sfu, sfv, sdu, sdv, nx, ny, nd_pad,
                             ny_pad, kx, ky, stream);
}

int fd_wavefront_solve_f64(const void* su, const void* sv, const void* sfu,
                           const void* sfv, void* sdu, void* sdv, int nx,
                           int ny, int nd_pad, int ny_pad, double kx,
                           double ky, void* stream) {
  return launch_exact<double>(su, sv, sfu, sfv, sdu, sdv, nx, ny, nd_pad,
                              ny_pad, kx, ky, stream);
}

// The overlapping-segment solve: the reciprocals of the field into sinv
// (nd_pad, ny_pad) scratch, then n_seg CTAs, each owning ceil(nd_pad /
// n_seg) diagonals after `overlap` warm-up diagonals from a zero carry.
int fd_wavefront_solve_seg_f32(const void* su, const void* sv,
                               const void* sfu, const void* sfv, void* sinv,
                               void* sdu, void* sdv, int nx, int ny,
                               int nd_pad, int ny_pad, float kx, float ky,
                               int n_seg, int overlap, void* stream) {
  return launch_seg<float>(su, sv, sfu, sfv, sinv, sdu, sdv, nx, ny, nd_pad,
                           ny_pad, kx, ky, n_seg, overlap, stream);
}

int fd_wavefront_solve_seg_f64(const void* su, const void* sv,
                               const void* sfu, const void* sfv, void* sinv,
                               void* sdu, void* sdv, int nx, int ny,
                               int nd_pad, int ny_pad, double kx, double ky,
                               int n_seg, int overlap, void* stream) {
  return launch_seg<double>(su, sv, sfu, sfv, sinv, sdu, sdv, nx, ny,
                            nd_pad, ny_pad, kx, ky, n_seg, overlap, stream);
}

const char* fd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
