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
//  * every cell runs solve_cell, the same arithmetic in the same order as
//    solve_skewed_ref, whatever warp it falls in, and every hand-off is
//    fixed by the shape: the result does not depend on timing;
//  * any ny_pad up to 4096 is 128 warps, 16 a CTA.
// What holds it now: one warp alone on its scheduler takes ~0.17 us a
// diagonal (the dependent latency of its instructions, run in order with
// no other warp to hide it), ~0.22 us with the hand-off.
// The first design (one CTA, one thread a row, a shared-memory exchange and
// a barrier per diagonal) remains as the segment kernel below.
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
// one CTA on the (nd_pad, ny_pad) arrays as they are, so no pack or unpack
// copy is needed. A segment's CTA has one thread per skewed row r up to
// ny_pad = 1024; above that each of at most 512 threads owns RPT = 4 or 8
// rows (strided by blockDim). The west carry stays in registers; the south
// carry comes from a double-buffered shared array of the four carries, so
// one __syncthreads() per diagonal orders every exchange; the next
// diagonal's inputs are loaded before the barrier; a thread with several
// rows makes every read of a diagonal before any write, so its rows'
// chains overlap (one row per thread runs in half the time of two, measured
// on an H100 SXM at 700 W, PERF.md).

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

constexpr size_t kDefaultSmem = 48 * 1024;

// One band cell: the 2x2 block at (u, v), the right-hand sides from the west
// carry (d-1, r) and the south carry (d-1, r-1), and the solve. The
// reciprocal of the determinant depends on the cell's inputs alone, so a
// caller may form it ahead of the chain (solve_cell_with).
template <typename T>
__device__ __forceinline__ T inverse_det(T u, T v, T kx, T ky) {
  const T one = T(1);
  const T half = T(0.5);
  const T b11 = one + kx * u + half * ky * v;
  const T b12 = half * ky * u;
  const T b21 = half * kx * v;
  const T b22 = one + ky * v + half * kx * u;
  return one / (b11 * b22 - b12 * b21);
}

template <typename T>
__device__ __forceinline__ void solve_cell_with(T inv_det, T u, T v, T fu,
                                                T fv, T du_w, T dv_w, T u_w,
                                                T v_w, T du_s, T dv_s, T u_s,
                                                T v_s, T kx, T ky, T& du,
                                                T& dv) {
  const T one = T(1);
  const T half = T(0.5);
  const T b11 = one + kx * u + half * ky * v;
  const T b12 = half * ky * u;
  const T b21 = half * kx * v;
  const T b22 = one + ky * v + half * kx * u;
  const T rhs_u = fu + kx * u_w * du_w + half * ky * (v_s * du_s + u_s * dv_s);
  const T rhs_v = fv + half * kx * (v_w * du_w + u_w * dv_w) + ky * v_s * dv_s;
  du = (b22 * rhs_u - b12 * rhs_v) * inv_det;
  dv = (b11 * rhs_v - b21 * rhs_u) * inv_det;
}

template <typename T>
__device__ __forceinline__ void solve_cell(T u, T v, T fu, T fv, T du_w,
                                           T dv_w, T u_w, T v_w, T du_s,
                                           T dv_s, T u_s, T v_s, T kx, T ky,
                                           T& du, T& dv) {
  solve_cell_with(inverse_det(u, v, kx, ky), u, v, fu, fv, du_w, dv_w, u_w,
                  v_w, du_s, dv_s, u_s, v_s, kx, ky, du, dv);
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
// B7: the overlapping-segment solve, one CTA per segment
// ----------------------------------------------------------------------

constexpr int kMaxThreadsOneRow = 1024;   // RPT == 1
constexpr int kMaxThreadsRows = 512;      // RPT > 1: room for 128 registers

template <typename T, int RPT>
__global__ void __launch_bounds__(RPT == 1 ? kMaxThreadsOneRow
                                           : kMaxThreadsRows)
wavefront_seg_kernel(const T* __restrict__ su, const T* __restrict__ sv,
                     const T* __restrict__ sfu, const T* __restrict__ sfv,
                     T* __restrict__ sdu, T* __restrict__ sdv,
                     int nx, int ny, int nd_pad, int ny_pad, T kx, T ky,
                     int seg_len, int overlap) {
  // [2 buffers][4 carries: du, dv, u, v][ny_pad]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* carry = reinterpret_cast<T*>(smem_raw);

  const T zero = T(0);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  // this CTA's segment: owned diagonals [d_own, d_end), warm-up from d_begin
  const int d_own = blockIdx.x * seg_len;
  const int d_begin = d_own - overlap > 0 ? d_own - overlap : 0;
  const int d_end = d_own + seg_len < nd_pad ? d_own + seg_len : nd_pad;
  if (d_own >= d_end) return;   // a trailing segment owns nothing

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
        solve_cell(u[j], v[j], fu[j], fv[j], du_p[j], dv_p[j], u_p[j],
                   v_p[j], du_s[j], dv_s[j], u_s[j], v_s[j], kx, ky, du, dv);
      }
      if (d >= d_own) {
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

template <typename T, int RPT>
cudaError_t launch_rpt(const T* su, const T* sv, const T* sfu, const T* sfv,
                       T* sdu, T* sdv, int nx, int ny, int nd_pad, int ny_pad,
                       T kx, T ky, int n_seg, int seg_len, int overlap,
                       int threads, size_t smem, cudaStream_t stream) {
  auto kernel = wavefront_seg_kernel<T, RPT>;
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

template <typename T>
int launch_seg(const void* su, const void* sv, const void* sfu,
               const void* sfv, void* sdu, void* sdv, int nx, int ny,
               int nd_pad, int ny_pad, T kx, T ky, int n_seg, int overlap,
               void* stream) {
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
      err = launch_rpt<T, 1>(a, b, c, e, o1, o2, nx, ny, nd_pad, ny_pad, kx,
                             ky, n_seg, seg_len, overlap, threads, smem, s);
      break;
    case 4:
      err = launch_rpt<T, 4>(a, b, c, e, o1, o2, nx, ny, nd_pad, ny_pad, kx,
                             ky, n_seg, seg_len, overlap, threads, smem, s);
      break;
    default:
      err = launch_rpt<T, 8>(a, b, c, e, o1, o2, nx, ny, nd_pad, ny_pad, kx,
                             ky, n_seg, seg_len, overlap, threads, smem, s);
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

// The overlapping-segment solve: n_seg CTAs, each owning ceil(nd_pad /
// n_seg) diagonals after `overlap` warm-up diagonals from a zero carry.
int fd_wavefront_solve_seg_f32(const void* su, const void* sv,
                               const void* sfu, const void* sfv, void* sdu,
                               void* sdv, int nx, int ny, int nd_pad,
                               int ny_pad, float kx, float ky, int n_seg,
                               int overlap, void* stream) {
  return launch_seg<float>(su, sv, sfu, sfv, sdu, sdv, nx, ny, nd_pad,
                           ny_pad, kx, ky, n_seg, overlap, stream);
}

int fd_wavefront_solve_seg_f64(const void* su, const void* sv,
                               const void* sfu, const void* sfv, void* sdu,
                               void* sdv, int nx, int ny, int nd_pad,
                               int ny_pad, double kx, double ky, int n_seg,
                               int overlap, void* stream) {
  return launch_seg<double>(su, sv, sfu, sfv, sdu, sdv, nx, ny, nd_pad,
                            ny_pad, kx, ky, n_seg, overlap, stream);
}

const char* fd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
