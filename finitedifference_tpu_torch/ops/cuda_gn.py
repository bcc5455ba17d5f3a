"""Wrappers of the hand-written sampled-mesh Gauss-Newton kernels
(csrc/gn_sampled.cu, csrc/gn_traj.cu).

gn_system_cuda replaces finitedifference_tpu/ops/pallas_gn.py::
_make_kernel (B4): the weighted (kp, kp) Gram extension of the factored
HPROM system on the ECSW mesh. gn_step_cuda replaces
pallas_gn.py::_make_step_kernel (B5): the same system, then a masked CG
on the device, giving (dy, ||W r||) for one fused Gauss-Newton
iteration. gn_traj_cuda replaces pallas_gn.py::_make_traj_kernel (B6):
whole HPROM trajectories, every step and every Gauss-Newton iteration,
one thread block cluster per trajectory (traj_geometry), all in one
launch. All run in float32 or float64. Their plain versions are
ops/gn.gn_system_ref, gn_step_ref and trajectory_hprom_ref.

SYSTEM_LAUNCHES, STEP_LAUNCHES and TRAJ_LAUNCHES count the kernels'
launches in this process (one per call), so a run can show that its main
path went through them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from finitedifference_tpu_torch.ops._build import (
    SCALARS,
    check_launch,
    check_tensor,
    symbol,
)

SYSTEM_LAUNCHES = 0
STEP_LAUNCHES = 0
TRAJ_LAUNCHES = 0

# the CG runs one CTA with one thread per lane (csrc/gn_sampled.cu)
MAX_STEP_LANES = 256
# live lanes of the trajectory kernel, k + 1 rounded up to TRAJ_LANE_STEP:
# every CTA of a cluster holds the (lanes, lanes) Gram in shared memory,
# its partial summed in float64 up to 128 lanes, in float32 above (float32
# only); 227 KB hold no more
MAX_TRAJ_LANES = {torch.float32: 192, torch.float64: 128}

# how the trajectory kernel (csrc/gn_traj.cu) cuts a system over its
# cluster: fixed by the shape, never by the batch, so that a point's
# result does not depend on the points beside it. The kernel picks its
# threads and the cells it stages at a time itself, from k and the type.
TRAJ_CLUSTER = 8          # CTAs of a trajectory's cluster (kCluster there)
TRAJ_CELLS = 32           # cells of a partial Gram, trajectory_hprom_ref's too
TRAJ_LANE_STEP = 16
TRAJ_TILE = 8             # the Gram is summed and reduced in 8x8 tiles


class TrajGeometry(NamedTuple):
    """How the trajectory kernel cuts one system over its cluster:
    `lanes` live lanes; chunks of TRAJ_CELLS cells, chunk c going to CTA
    c mod `cluster`; the 8x8 tiles of the live lanes' upper triangle,
    tile t summed over the cluster by CTA t mod `cluster`."""
    lanes: int
    cluster: int
    n_chunks: int

    def cta_chunks(self, rank: int) -> range:
        """The chunks CTA `rank` of a cluster sums, in order."""
        return range(rank, self.n_chunks, self.cluster)

    @staticmethod
    def chunk_cells(c: int, n_p: int) -> range:
        """The cells of chunk c."""
        return range(c * TRAJ_CELLS, min((c + 1) * TRAJ_CELLS, n_p))

    def n_tiles(self) -> int:
        nt = self.lanes // TRAJ_TILE
        return nt * (nt + 1) // 2

    def cta_tiles(self, rank: int) -> range:
        """The upper 8x8 tiles whose cluster-wide sum CTA `rank` takes
        (the reduce-scatter)."""
        return range(rank, self.n_tiles(), self.cluster)


def traj_geometry(n_p: int, k: int, itemsize: int) -> TrajGeometry:
    """The trajectory kernel's cut for n_p sampled cells, k modes and a
    working type of `itemsize` bytes."""
    lanes = _round_up(k + 1, TRAJ_LANE_STEP)
    if lanes > MAX_TRAJ_LANES[torch.float32 if itemsize == 4
                              else torch.float64]:
        raise ValueError(f"gn_traj kernel: k={k} needs more shared memory "
                         f"than a block has ({lanes} live lanes)")
    return TrajGeometry(lanes, TRAJ_CLUSTER, -(-n_p // TRAJ_CELLS))

# the partial-Gram geometry of the shared passes (csrc/gn_common.cuh)
GRAM_EDGE = 64     # output block edge: live lanes pad to a multiple
GRAM_ROWS = 32     # rows staged per step: chunks are a multiple
TARGET_CHUNKS = 256


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def live_lanes(k: int) -> int:
    """k1p: lanes 0..k rounded up to the Gram's block edge."""
    return _round_up(k + 1, GRAM_EDGE)


def gram_chunks(rows: int) -> tuple[int, int]:
    """(rows per chunk, number of chunks) of the partial Grams: about
    TARGET_CHUNKS chunks of at least GRAM_ROWS rows."""
    rpc = max(GRAM_ROWS, _round_up(-(-rows // TARGET_CHUNKS), GRAM_ROWS))
    return rpc, -(-rows // rpc)


@functools.cache
def _kernel(kind: str, dtype):
    suffix, scalar = SCALARS[dtype]
    n_ptr = 8 if kind == "system" else 9
    tail = [ctypes.c_int] * (2 if kind == "system" else 3)
    return symbol(f"fd_gn_sampled_{kind}_{suffix}",
                  [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                  + [scalar, scalar] + tail + [ctypes.c_void_p])


@functools.cache
def _traj_kernel(dtype):
    suffix, scalar = SCALARS[dtype]
    return symbol(f"fd_gn_traj_{suffix}",
                  [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                  + [scalar, scalar] + [ctypes.c_int] * 3
                  + [scalar, scalar, ctypes.c_void_p])


def _prepare(p6p, y, cp, wgt_p, k):
    """Check the inputs; return (n_p, kp, k1p, rpc, n_chunks, scratch)."""
    if not isinstance(p6p, torch.Tensor) or p6p.dim() != 3 \
            or p6p.shape[0] != 6:
        raise ValueError("p6p: expected a (6, n_p, kp) tensor")
    dtype, device = p6p.dtype, p6p.device
    if dtype not in SCALARS:
        raise ValueError(f"the gn_sampled kernels take float32 or float64, "
                         f"got {dtype}")
    _, n_p, kp = p6p.shape
    check_tensor("p6p", p6p, device, dtype, [(6, n_p, kp)])
    check_tensor("y", y, device, dtype, [(k,)])
    check_tensor("cp", cp, device, dtype, [(n_p, 2)])
    check_tensor("wgt_p", wgt_p, device, dtype, [(n_p,), (n_p, 1)])
    k1p = live_lanes(k)
    if not 0 < k < kp or k1p > kp or 6 * n_p * kp >= 2 ** 31:
        raise ValueError(f"gn_sampled kernels: k={k} does not fit the "
                         f"padded blocks (n_p={n_p}, kp={kp})")
    rows = 2 * n_p
    rpc, n_chunks = gram_chunks(rows)
    s = torch.empty(6 * n_p, dtype=dtype, device=device)
    a = torch.empty((rows, k1p), dtype=dtype, device=device)
    partials = torch.empty((n_chunks, k1p, k1p), dtype=dtype, device=device)
    return n_p, kp, k1p, rpc, n_chunks, (s, a, partials)


def gn_system_cuda(p6p, y, cp, wgt_p, k: int, hdx: float, hdy: float):
    """The weighted sampled system on padded CUDA tensors.

    p6p: (6, n_p, kp) blocks, float32 or float64; y: (k,); cp: (n_p, 2);
    wgt_p: (n_p[, 1]); all contiguous, of one dtype, on one device.
    Returns gext (kp, kp) in that dtype (the partials summed in float64).
    Launches on the current stream and does not synchronise; raises on
    any input the kernel does not take and on a refused launch.
    """
    global SYSTEM_LAUNCHES
    n_p, kp, k1p, rpc, n_chunks, (s, a, part) = _prepare(p6p, y, cp,
                                                         wgt_p, k)
    gext = torch.empty((kp, kp), dtype=p6p.dtype, device=p6p.device)
    stream = torch.cuda.current_stream(p6p.device).cuda_stream
    with torch.cuda.device(p6p.device):
        rc = _kernel("system", p6p.dtype)(
            p6p.data_ptr(), y.data_ptr(), cp.data_ptr(), wgt_p.data_ptr(),
            s.data_ptr(), a.data_ptr(), part.data_ptr(), gext.data_ptr(),
            n_p, kp, k, k1p, float(hdx), float(hdy), rpc, n_chunks, stream)
    check_launch(rc, "gn_sampled_system")
    SYSTEM_LAUNCHES += 1
    return gext


def gn_step_cuda(p6p, y, cp, wgt_p, k: int, hdx: float, hdy: float, *,
                 solve_iters: int = 24):
    """One fused Gauss-Newton iteration on padded CUDA tensors: the
    system of gn_system_cuda, then `solve_iters` masked CG steps.
    Returns (dy (k,), rn 0-dim), both in the blocks' dtype, on the
    device. Needs kp <= 256 (one CG thread per lane)."""
    global STEP_LAUNCHES
    n_p, kp, k1p, rpc, n_chunks, (s, a, part) = _prepare(p6p, y, cp,
                                                         wgt_p, k)
    if kp > MAX_STEP_LANES or solve_iters < 0:
        raise ValueError(f"gn_step kernel: kp={kp} > {MAX_STEP_LANES} or "
                         f"solve_iters={solve_iters} < 0")
    gram = torch.empty((kp, kp), dtype=torch.float64, device=p6p.device)
    out = torch.empty((2, kp), dtype=p6p.dtype, device=p6p.device)
    stream = torch.cuda.current_stream(p6p.device).cuda_stream
    with torch.cuda.device(p6p.device):
        rc = _kernel("step", p6p.dtype)(
            p6p.data_ptr(), y.data_ptr(), cp.data_ptr(), wgt_p.data_ptr(),
            s.data_ptr(), a.data_ptr(), part.data_ptr(), gram.data_ptr(),
            out.data_ptr(), n_p, kp, k, k1p, float(hdx), float(hdy), rpc,
            n_chunks, int(solve_iters), stream)
    check_launch(rc, "gn_sampled_step")
    STEP_LAUNCHES += 1
    return out[0, :k], out[1, 0]


def gn_traj_cuda(p6p, y0, slbc_p, wgt_p, k: int, hdx: float, hdy: float,
                 num_steps: int, *, unroll_its: int = 3,
                 solve_iters: int = 24, relnorm_cutoff: float = 1e-5,
                 min_delta: float = 0.1):
    """Whole HPROM trajectories on padded CUDA tensors, in ONE launch.

    p6p: (6, n_p, kp) blocks, float32 or float64; y0: (k,) or (B, k);
    slbc_p: (n_p[, 1]) or (B, n_p[, 1]), the padded source + inflow term
    of each trajectory; wgt_p: (n_p[, 1]); all contiguous, of one dtype,
    on one device. Needs round_up(k + 1, 16) <= MAX_TRAJ_LANES[dtype].
    One cluster of TRAJ_CLUSTER CTAs runs each trajectory.
    Returns (ys (B?, num_steps, k), its (B?,), evals (B?,)): the reduced
    coords after each step, the Gauss-Newton updates and the systems
    built. Launches on the current stream and does not synchronise;
    raises on any input the kernel does not take and on a refused launch.
    """
    global TRAJ_LAUNCHES
    if not isinstance(p6p, torch.Tensor) or p6p.dim() != 3 \
            or p6p.shape[0] != 6:
        raise ValueError("p6p: expected a (6, n_p, kp) tensor")
    dtype, device = p6p.dtype, p6p.device
    if dtype not in SCALARS:
        raise ValueError(f"the gn_traj kernel takes float32 or float64, "
                         f"got {dtype}")
    _, n_p, kp = p6p.shape
    batched = isinstance(y0, torch.Tensor) and y0.dim() == 2
    b = y0.shape[0] if batched else 1
    check_tensor("p6p", p6p, device, dtype, [(6, n_p, kp)])
    check_tensor("y0", y0, device, dtype, [(b, k)] if batched else [(k,)])
    check_tensor("slbc_p", slbc_p, device, dtype,
                 [(b, n_p, 1), (b, n_p)] if batched else [(n_p, 1), (n_p,)])
    check_tensor("wgt_p", wgt_p, device, dtype, [(n_p,), (n_p, 1)])
    limit = MAX_TRAJ_LANES[dtype]
    if not 0 < k < kp or _round_up(k + 1, TRAJ_LANE_STEP) > min(limit, kp):
        raise ValueError(f"gn_traj kernel: k={k} with kp={kp} needs k < kp "
                         f"and round_up(k + 1, {TRAJ_LANE_STEP}) <= {limit} "
                         f"lanes in {dtype} (the Gram in each CTA's shared "
                         f"memory)")
    if b < 1 or 6 * n_p * kp >= 2 ** 31 or min(num_steps, unroll_its,
                                                 solve_iters) < 0:
        raise ValueError(f"gn_traj kernel: batch {b}, n_p={n_p}, "
                         f"num_steps={num_steps}, unroll_its={unroll_its}, "
                         f"solve_iters={solve_iters} out of range")
    y = torch.zeros((b, kp), dtype=dtype, device=device)
    y[:, :k] = y0
    cp = torch.empty((b, 2, n_p), dtype=dtype, device=device)
    ys = torch.empty((b, num_steps, kp), dtype=dtype, device=device)
    stats = torch.empty((b, 2), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = _traj_kernel(dtype)(
            p6p.data_ptr(), y.data_ptr(), slbc_p.data_ptr(),
            wgt_p.data_ptr(), cp.data_ptr(), ys.data_ptr(),
            stats.data_ptr(), b, n_p, kp, k, float(hdx), float(hdy),
            int(num_steps), int(unroll_its), int(solve_iters),
            float(relnorm_cutoff), float(min_delta), stream)
    check_launch(rc, "gn_traj")
    TRAJ_LAUNCHES += 1
    out = (ys[..., :k], stats[:, 0].long(), stats[:, 1].long())
    return out if batched else tuple(x[0] for x in out)
