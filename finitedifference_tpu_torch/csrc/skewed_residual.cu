// The skewed Crank-Nicolson residual of the FOM's Newton loop and its norm
// in one pass, written by hand for Hopper (sm_90a).
//
// It replaces no Pallas kernel: on the TPU, XLA fused
// finitedifference_tpu/ops/skewed.py::skewed_residual_iter, the norm and the
// stop test under jit. Run eagerly on the card, the same expressions are ~45
// launches an update (ops/skewed.skewed_residual_iter, norm2, the stop test)
// and ~48 a step (skewed_step_constant), each with its pads and temporaries,
// and the host issued them more slowly than the card ran them.
//
// Both entry points evaluate the current-state half of the residual on
// padded skewed fields S[d, r] = X[r, d - r] of shape (nd_pad, ny_pad),
// row-major, zero outside the array:
//   au = u + dt/2 (ddx(u u / 2) + ddy(u v / 2))
//   av = v + dt/2 (ddy(v v / 2) + ddx(u v / 2))
//   ddx(f)[d, r] = (f[d, r] - f[d-1, r]) / dx      (west)
//   ddy(f)[d, r] = (f[d, r] - f[d-1, r-1]) / dy    (south)
// with the band mask m = (r < ny) & (0 <= d - r < nx), from the indices.
//  * fd_skewed_update_residual_*: one Newton update. u' = u - du, v' = v - dv
//    (with no du, u' = u: the extrapolated guess), ru = au(u', v') m + cp_u,
//    rv = av(u', v') m + cp_v, rn = sqrt(sum ru^2 + sum rv^2) and
//    stop = rn / init_norm < cutoff, or rn > 0.99 rn_prev (with no rn_prev,
//    the cutoff alone). The neighbours' u' come from their u and du: the
//    kernel reads no output, so it never updates in place.
//  * fd_skewed_step_constant_*: one step's constant. cp_u = (au(up, vp) -
//    2 up - src - lbc) m, cp_v = (av - 2 vp) m, r0 = a m + cp and
//    init_norm = sqrt(sum r0u^2 + sum r0v^2).
//
// What bounds it: memory. The update reads six fields (u, v, du, dv, cp_u,
// cp_v) and writes four (u', v', ru, rv): 94.4 MB at 750^2 in float64, 0.028
// ms at 3.35 TB/s. The step constant reads four and writes four: 75.5 MB,
// 0.023 ms. About 25 operations a cell are far below the card's rate.
//
// Its design: one pass. A block is 128 consecutive rows r, a lane a row, so
// every load and store of a warp is 32 neighbouring elements along r, and
// it walks 16 diagonals d in order. The west neighbour (d-1, r) is the
// lane's own cell of the diagonal before, kept in registers; the south one
// (d-1, r-1) is the lane below's, taken by __shfl_up_sync, and lane 0 reads
// it from row d-1 (another warp's row). Only the diagonal before a block's
// first is read twice (1/16 more of u, v, du, dv).
//  * Rounding: every operation is the eager expression's, in its order
//    (((0.5 u) u, (f - f_w) / dx, u + half_dt (ddx + ddy), ((au - 2 up) -
//    src) - lbc, au m + cp), each rounded as written with the _rn
//    intrinsics (Rn below, as csrc/wavefront.cu does for B7), so that nvcc
//    contracts nothing into a fused multiply-add. PyTorch on the card
//    divides by a Python scalar as a multiplication by its reciprocal,
//    taken in float64 and rounded to the working type, and multiplies by
//    a Python scalar rounded to it (measured on an H100 with torch 2.11:
//    no other form gave its float32 bits); the caller passes 1/dx, 1/dy
//    and dt/2 so formed, and u', v', ru, rv, cp and r0 are the eager
//    bits.
//  * The norm: each lane sums its cells in order, each block its lanes by a
//    fixed tree, and writes its two sums to the caller's scratch; the block
//    that takes the last ticket (atomicInc on an integer that wraps back to
//    zero for the next launch) sums every block's in index order and writes
//    rn (and stop). No float atomics: the same bits on every run. The sums
//    are in the working type, as torch.sum's on the card, in another order:
//    rn is eager's to rounding.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 128;    // rows of a block, one a lane
constexpr int kDiags = 16;    // diagonals a block walks
constexpr int kWarps = kRows / 32;

template <typename T> struct Rn;
template <> struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return __fsqrt_rn(a);
  }
};
template <> struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double sqrt(double a) {
    return __dsqrt_rn(a);
  }
};

// The current-state half of the residual at a cell (u, v) from its west
// (uw, vw) and south (us, vs) neighbours: ops/skewed._half_flux.
template <typename T>
__device__ __forceinline__ void half_flux(T u, T v, T uw, T vw, T us, T vs,
                                          T rdx, T rdy, T half_dt, T& au,
                                          T& av) {
  using R = Rn<T>;
  const T h = T(0.5);
  const T hu = R::mul(h, u), huw = R::mul(h, uw), hus = R::mul(h, us);
  const T fu = R::mul(hu, u), fu_w = R::mul(huw, uw);
  const T fv = R::mul(R::mul(h, v), v), fv_s = R::mul(R::mul(h, vs), vs);
  const T fuv = R::mul(hu, v), fuv_w = R::mul(huw, vw);
  const T fuv_s = R::mul(hus, vs);
  const T ddx_fu = R::mul(R::sub(fu, fu_w), rdx);
  const T ddy_fuv = R::mul(R::sub(fuv, fuv_s), rdy);
  const T ddy_fv = R::mul(R::sub(fv, fv_s), rdy);
  const T ddx_fuv = R::mul(R::sub(fuv, fuv_w), rdx);
  au = R::add(u, R::mul(half_dt, R::add(ddx_fu, ddy_fuv)));
  av = R::add(v, R::mul(half_dt, R::add(ddy_fv, ddx_fuv)));
}

struct Shape {
  int nx, ny, nd_pad, ny_pad;
  __device__ __forceinline__ bool band(int d, int r) const {
    return r < ny && d - r >= 0 && d - r < nx;
  }
};

// The block's walk: for each of its diagonals d, `load(i)` gives the state
// (u, v) of cell i = d * ny_pad + r, and `cell(i, m, u, v, au, av, xu, xv)`
// stores what the cell gives and returns its two residuals, whose squares
// the lane sums in order into su, sv.
template <typename T, typename Load, typename Cell>
__device__ __forceinline__ void walk(const Shape& s, T rdx, T rdy,
                                     T half_dt, Load load, Cell cell, T& su,
                                     T& sv) {
  using R = Rn<T>;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRows + threadIdx.x;
  const int d0 = blockIdx.y * kDiags;
  const bool live = r < s.ny_pad;
  const size_t row = static_cast<size_t>(s.ny_pad);
  T pu = T(0), pv = T(0);   // the state of (d - 1, r): zero before d = 0
  if (live && d0 > 0) load((d0 - 1) * row + r, pu, pv);
  su = T(0);
  sv = T(0);
#pragma unroll 4
  for (int k = 0; k < kDiags; ++k) {
    const int d = d0 + k;
    if (d >= s.nd_pad) break;   // the same d in every lane of the block
    T us = __shfl_up_sync(0xffffffffu, pu, 1);
    T vs = __shfl_up_sync(0xffffffffu, pv, 1);
    if (lane == 0) {
      us = T(0);
      vs = T(0);
      if (live && d > 0 && r > 0) load((d - 1) * row + r - 1, us, vs);
    }
    T cu = T(0), cv = T(0);
    if (live) {
      const size_t i = d * row + r;
      load(i, cu, cv);
      T au, av;
      half_flux(cu, cv, pu, pv, us, vs, rdx, rdy, half_dt, au, av);
      T xu, xv;
      cell(i, s.band(d, r) ? T(1) : T(0), cu, cv, au, av, xu, xv);
      su = R::add(su, R::mul(xu, xu));
      sv = R::add(sv, R::mul(xv, xv));
    }
    pu = cu;
    pv = cv;
  }
}

// The sum of x over the block, in thread 0, by a fixed tree.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
  }
  __syncthreads();
  return total;
}

// Posts the block's sums (su, sv) to partials and takes a ticket. In the
// block that takes the last one, thread 0 returns true with the sums over
// every block, taken in block order; everywhere else it returns false.
template <typename T>
__device__ bool grid_sum(T su, T sv, T* partials, unsigned* ticket, T& tu,
                         T& tv) {
  __shared__ T scratch[kWarps];
  __shared__ bool last;
  const unsigned blocks = gridDim.x * gridDim.y;
  const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
  su = block_sum(su, scratch);
  sv = block_sum(sv, scratch);
  if (threadIdx.x == 0) {
    partials[2 * b] = su;
    partials[2 * b + 1] = sv;
    __threadfence();
    // wraps to 0 at the last ticket, ready for the next launch
    last = atomicInc(ticket, blocks - 1) == blocks - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  T au = T(0), av = T(0);
  for (unsigned k = threadIdx.x; k < blocks; k += kRows) {
    au += __ldcg(partials + 2 * k);
    av += __ldcg(partials + 2 * k + 1);
  }
  tu = block_sum(au, scratch);
  tv = block_sum(av, scratch);
  return threadIdx.x == 0;
}

template <typename T, bool kUpdate>
__global__ void __launch_bounds__(kRows) skewed_update_residual_kernel(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ du, const T* __restrict__ dv,
    const T* __restrict__ cp_u, const T* __restrict__ cp_v,
    T* __restrict__ u_out, T* __restrict__ v_out, T* __restrict__ ru,
    T* __restrict__ rv, T* __restrict__ partials, unsigned* ticket,
    T* __restrict__ rn_out, bool* __restrict__ stop_out,
    const T* __restrict__ init_norm, const T* __restrict__ rn_prev,
    Shape s, T rdx, T rdy, T half_dt, T cutoff) {
  using R = Rn<T>;
  auto load = [&](size_t i, T& a, T& b) {
    a = u[i];
    b = v[i];
    if constexpr (kUpdate) {
      a = R::sub(a, du[i]);
      b = R::sub(b, dv[i]);
    }
  };
  auto cell = [&](size_t i, T m, T cu, T cv, T au, T av, T& xu, T& xv) {
    if constexpr (kUpdate) {
      u_out[i] = cu;
      v_out[i] = cv;
    }
    xu = R::add(R::mul(au, m), cp_u[i]);
    xv = R::add(R::mul(av, m), cp_v[i]);
    ru[i] = xu;
    rv[i] = xv;
  };
  T su, sv, tu, tv;
  walk<T>(s, rdx, rdy, half_dt, load, cell, su, sv);
  if (grid_sum(su, sv, partials, ticket, tu, tv)) {
    const T rn = R::sqrt(R::add(tu, tv));
    bool stop = R::div(rn, *init_norm) < cutoff;
    if (rn_prev != nullptr) stop = stop || rn > R::mul(T(0.99), *rn_prev);
    *rn_out = rn;
    *stop_out = stop;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRows) skewed_step_constant_kernel(
    const T* __restrict__ up, const T* __restrict__ vp,
    const T* __restrict__ src, const T* __restrict__ lbc,
    T* __restrict__ cp_u, T* __restrict__ cp_v, T* __restrict__ r0u,
    T* __restrict__ r0v, T* __restrict__ partials, unsigned* ticket,
    T* __restrict__ norm_out, Shape s, T rdx, T rdy, T half_dt) {
  using R = Rn<T>;
  auto load = [&](size_t i, T& a, T& b) {
    a = up[i];
    b = vp[i];
  };
  auto cell = [&](size_t i, T m, T cu, T cv, T au, T av, T& xu, T& xv) {
    const T two = T(2);
    const T cu_ = R::mul(
        R::sub(R::sub(R::sub(au, R::mul(two, cu)), src[i]), lbc[i]), m);
    const T cv_ = R::mul(R::sub(av, R::mul(two, cv)), m);
    cp_u[i] = cu_;
    cp_v[i] = cv_;
    xu = R::add(R::mul(au, m), cu_);
    xv = R::add(R::mul(av, m), cv_);
    r0u[i] = xu;
    r0v[i] = xv;
  };
  T su, sv, tu, tv;
  walk<T>(s, rdx, rdy, half_dt, load, cell, su, sv);
  if (grid_sum(su, sv, partials, ticket, tu, tv))
    *norm_out = R::sqrt(R::add(tu, tv));
}

dim3 grid_of(int nd_pad, int ny_pad) {
  return dim3((ny_pad + kRows - 1) / kRows, (nd_pad + kDiags - 1) / kDiags);
}

bool bad_shape(int nx, int ny, int nd_pad, int ny_pad) {
  return nx < 1 || ny < 1 || ny > ny_pad || nd_pad < nx + ny - 1 ||
         (nd_pad + kDiags - 1) / kDiags > 65535;
}

template <typename T, bool kUpdate>
void launch_update_kernel(const void* u, const void* v, const void* du,
                          const void* dv, const void* cp_u, const void* cp_v,
                          void* u_out, void* v_out, void* ru, void* rv,
                          void* partials, void* ticket, void* rn, void* stop,
                          const void* init_norm, const void* rn_prev,
                          const Shape& s, T rdx, T rdy, T half_dt, T cutoff,
                          cudaStream_t stream) {
  skewed_update_residual_kernel<T, kUpdate>
      <<<grid_of(s.nd_pad, s.ny_pad), kRows, 0, stream>>>(
          static_cast<const T*>(u), static_cast<const T*>(v),
          static_cast<const T*>(du), static_cast<const T*>(dv),
          static_cast<const T*>(cp_u), static_cast<const T*>(cp_v),
          static_cast<T*>(u_out), static_cast<T*>(v_out),
          static_cast<T*>(ru), static_cast<T*>(rv),
          static_cast<T*>(partials), static_cast<unsigned*>(ticket),
          static_cast<T*>(rn), static_cast<bool*>(stop),
          static_cast<const T*>(init_norm), static_cast<const T*>(rn_prev),
          s, rdx, rdy, half_dt, cutoff);
}

template <typename T>
int launch_update(const void* u, const void* v, const void* du,
                  const void* dv, const void* cp_u, const void* cp_v,
                  void* u_out, void* v_out, void* ru, void* rv,
                  void* partials, void* ticket, void* rn, void* stop,
                  const void* init_norm, const void* rn_prev, int nx, int ny,
                  int nd_pad, int ny_pad, T rdx, T rdy, T half_dt, T cutoff,
                  void* stream) {
  if (bad_shape(nx, ny, nd_pad, ny_pad) || (du == nullptr) != (dv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{nx, ny, nd_pad, ny_pad};
  const auto st = static_cast<cudaStream_t>(stream);
  if (du != nullptr)
    launch_update_kernel<T, true>(u, v, du, dv, cp_u, cp_v, u_out, v_out, ru,
                                  rv, partials, ticket, rn, stop, init_norm,
                                  rn_prev, s, rdx, rdy, half_dt, cutoff, st);
  else
    launch_update_kernel<T, false>(u, v, du, dv, cp_u, cp_v, u_out, v_out,
                                   ru, rv, partials, ticket, rn, stop,
                                   init_norm, rn_prev, s, rdx, rdy, half_dt,
                                   cutoff, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_step_constant(const void* up, const void* vp, const void* src,
                         const void* lbc, void* cp_u, void* cp_v, void* r0u,
                         void* r0v, void* partials, void* ticket, void* norm,
                         int nx, int ny, int nd_pad, int ny_pad, T rdx, T rdy,
                         T half_dt, void* stream) {
  if (bad_shape(nx, ny, nd_pad, ny_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{nx, ny, nd_pad, ny_pad};
  skewed_step_constant_kernel<T>
      <<<grid_of(nd_pad, ny_pad), kRows, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(up), static_cast<const T*>(vp),
          static_cast<const T*>(src), static_cast<const T*>(lbc),
          static_cast<T*>(cp_u), static_cast<T*>(cp_v), static_cast<T*>(r0u),
          static_cast<T*>(r0v), static_cast<T*>(partials),
          static_cast<unsigned*>(ticket), static_cast<T*>(norm), s, rdx, rdy,
          half_dt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The blocks of a launch on (nd_pad, ny_pad) fields: the scratch
// `partials` holds two sums a block, in the working type.
int fd_skewed_residual_blocks(int nd_pad, int ny_pad) {
  const dim3 g = grid_of(nd_pad, ny_pad);
  return static_cast<int>(g.x * g.y);
}

// One Newton update on padded skewed fields; du = dv = NULL for none (then
// u_out, v_out are not written), rn_prev = NULL for no stagnation term.
// `ticket` is an unsigned 32-bit zero, left zero; `rdx`, `rdy` are 1/dx,
// 1/dy in the working type. Launches on `stream` and does not synchronise;
// returns the cudaError_t of the launch (0 on success).
int fd_skewed_update_residual_f32(
    const void* u, const void* v, const void* du, const void* dv,
    const void* cp_u, const void* cp_v, void* u_out, void* v_out, void* ru,
    void* rv, void* partials, void* ticket, void* rn, void* stop,
    const void* init_norm, const void* rn_prev, int nx, int ny, int nd_pad,
    int ny_pad, float rdx, float rdy, float half_dt, float cutoff,
    void* stream) {
  return launch_update<float>(u, v, du, dv, cp_u, cp_v, u_out, v_out, ru, rv,
                              partials, ticket, rn, stop, init_norm, rn_prev,
                              nx, ny, nd_pad, ny_pad, rdx, rdy, half_dt,
                              cutoff, stream);
}

int fd_skewed_update_residual_f64(
    const void* u, const void* v, const void* du, const void* dv,
    const void* cp_u, const void* cp_v, void* u_out, void* v_out, void* ru,
    void* rv, void* partials, void* ticket, void* rn, void* stop,
    const void* init_norm, const void* rn_prev, int nx, int ny, int nd_pad,
    int ny_pad, double rdx, double rdy, double half_dt, double cutoff,
    void* stream) {
  return launch_update<double>(u, v, du, dv, cp_u, cp_v, u_out, v_out, ru,
                               rv, partials, ticket, rn, stop, init_norm,
                               rn_prev, nx, ny, nd_pad, ny_pad, rdx, rdy,
                               half_dt, cutoff, stream);
}

// One step's constant and the norm of its residual r0 = r(up, vp).
int fd_skewed_step_constant_f32(const void* up, const void* vp,
                                const void* src, const void* lbc, void* cp_u,
                                void* cp_v, void* r0u, void* r0v,
                                void* partials, void* ticket, void* norm,
                                int nx, int ny, int nd_pad, int ny_pad,
                                float rdx, float rdy, float half_dt,
                                void* stream) {
  return launch_step_constant<float>(up, vp, src, lbc, cp_u, cp_v, r0u, r0v,
                                     partials, ticket, norm, nx, ny, nd_pad,
                                     ny_pad, rdx, rdy, half_dt, stream);
}

int fd_skewed_step_constant_f64(const void* up, const void* vp,
                                const void* src, const void* lbc, void* cp_u,
                                void* cp_v, void* r0u, void* r0v,
                                void* partials, void* ticket, void* norm,
                                int nx, int ny, int nd_pad, int ny_pad,
                                double rdx, double rdy, double half_dt,
                                void* stream) {
  return launch_step_constant<double>(up, vp, src, lbc, cp_u, cp_v, r0u, r0v,
                                      partials, ticket, norm, nx, ny, nd_pad,
                                      ny_pad, rdx, rdy, half_dt, stream);
}

}  // extern "C"
