"""Wrappers of the hand-written sampled-mesh Gauss-Newton kernels
(csrc/gn_sampled.cu, csrc/gn_traj.cu).

gn_system_cuda replaces finitedifference_tpu/ops/pallas_gn.py::
_make_kernel (B4): the weighted (kp, kp) Gram extension of the factored
HPROM system on the ECSW mesh. gn_step_cuda replaces
pallas_gn.py::_make_step_kernel (B5): the same system, then a masked CG
on the device, giving (dy, ||W r||) for one fused Gauss-Newton
iteration. Each is ONE launch of clusters of SAMPLED_CLUSTER CTAs
(sampled_geometry) that sums the Gram across its clusters through a
small float64 workspace (SampledWorkspace). gn_traj_cuda replaces
pallas_gn.py::_make_traj_kernel (B6): whole HPROM trajectories, every
step and every Gauss-Newton iteration, one thread block cluster per
trajectory (traj_geometry), all in one launch. All run in float32 or
float64. Their plain versions are ops/gn.gn_system_ref, gn_step_ref and
trajectory_hprom_ref.

SYSTEM_LAUNCHES, STEP_LAUNCHES and TRAJ_LAUNCHES count the kernels'
launches in this process (one per call, one device kernel each), so a
run can show that its main path went through them.
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

# the fused step takes kp <= 256 (kMaxLanes in csrc/gn_sampled.cu)
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


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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

# how the sampled kernels (csrc/gn_sampled.cu) cut one system: fixed by
# n_p, k and the type, the kernel's constants of the same names. The
# kernel owns its shared-memory layout and says whether it takes a shape
# (kernel_geometry); sampled_geometry is the cut alone, for the tests.
SAMPLED_CLUSTER = 8          # CTAs of a cluster (kCluster)
SAMPLED_MAX_CELLS = 16       # cells of a chunk (kMaxCells)
SAMPLED_STAGE_BYTES = 131072  # a chunk's staged rows at most (kStageBytes)
SAMPLED_MAX_CLUSTERS = 16    # one wave: 128 CTAs on 132 SMs (kMaxClusters)
SAMPLED_LANE_STEP = 16
SAMPLED_MAX_TILE_ROWS = 255  # 8x8 tiles a side: 8-bit tile indices
SAMPLED_PART_TILES = 256     # tiles of a part, one a thread (kPartTiles)
SAMPLED_THREADS = {4: 384, 8: 256}   # the most threads of a CTA (Threads)


class SampledGeometry(NamedTuple):
    """How the sampled kernels cut one system: `lanes` live lanes, whose
    upper triangle of 8x8 tiles (`n_tiles`) goes in `n_parts` parts of at
    most `part_tiles` over blockIdx.y, one thread a tile of its part in
    each group of `group` threads, `threads` a CTA; chunks of `cells`
    cells, chunk c to CTA c mod (n_clusters * cluster), in every part."""
    lanes: int
    n_tiles: int
    n_parts: int
    part_tiles: int
    group: int
    threads: int
    cells: int
    cluster: int
    n_chunks: int
    n_clusters: int

    def cta_chunks(self, cta: int) -> range:
        """The chunks CTA `cta` (of a part's clusters) sums, in order."""
        return range(cta, self.n_chunks, self.n_clusters * self.cluster)

    def chunk_cells(self, c: int, n_p: int) -> range:
        """The cells of chunk c."""
        return range(c * self.cells, min((c + 1) * self.cells, n_p))

    def part_tile_range(self, part: int) -> range:
        """The tiles (numbered row by row over the upper triangle) whose
        sums part `part` takes."""
        return range(part * self.part_tiles,
                     min((part + 1) * self.part_tiles, self.n_tiles))

    def workspace_len(self) -> int:
        """float64 elements of the workspace: a slice (row `rank` of every
        tile of its part) for each CTA of each part."""
        return (self.n_parts * self.n_clusters * self.cluster * 8
                * self.part_tiles)


@functools.lru_cache(maxsize=64)
def sampled_geometry(n_p: int, k: int, itemsize: int) -> SampledGeometry:
    """The sampled kernels' cut for n_p cells, k modes and a working type
    of `itemsize` bytes; raises ValueError for more live lanes than the
    kernel's 8-bit tile table numbers."""
    if not 0 < k or n_p < 1:
        raise ValueError(f"gn_sampled kernels: k={k}, n_p={n_p}")
    lanes = _round_up(k + 1, SAMPLED_LANE_STEP)
    nt = lanes // 8
    if nt > SAMPLED_MAX_TILE_ROWS:
        raise ValueError(f"gn_sampled kernels: k={k} needs {lanes} live "
                         f"lanes, more than the kernel takes "
                         f"({8 * SAMPLED_MAX_TILE_ROWS})")
    n_tiles = nt * (nt + 1) // 2
    n_parts = -(-n_tiles // SAMPLED_PART_TILES)
    part_tiles = -(-n_tiles // n_parts)
    group = _round_up(part_tiles, 32)
    threads = max(1, SAMPLED_THREADS[itemsize] // group) * group
    cells = SAMPLED_MAX_CELLS
    while cells > 1 and (6 * cells * (lanes + 16 // itemsize) * itemsize
                         > SAMPLED_STAGE_BYTES):
        cells //= 2
    n_chunks = -(-n_p // cells)
    n_clusters = min(-(-n_chunks // SAMPLED_CLUSTER),
                     max(1, SAMPLED_MAX_CLUSTERS // n_parts))
    return SampledGeometry(lanes, n_tiles, n_parts, part_tiles, group,
                           threads, cells, SAMPLED_CLUSTER, n_chunks,
                           n_clusters)


class KernelGeometry(NamedTuple):
    """The CUDA source's own geometry (fd_gn_sampled_geometry): whether
    the kernel takes the shape, its cut (SampledGeometry's fields from
    `lanes` to `n_clusters`, cluster left out), its shared memory a CTA
    and its workspace length."""
    fits: bool
    lanes: int
    n_tiles: int
    n_parts: int
    part_tiles: int
    group: int
    threads: int
    cells: int
    n_chunks: int
    n_clusters: int
    smem: int
    ws_len: int


@functools.lru_cache(maxsize=64)
def kernel_geometry(n_p: int, k: int, itemsize: int,
                    step: bool) -> KernelGeometry:
    """fd_gn_sampled_geometry for n_p cells, k modes, a working type of
    `itemsize` bytes and the step (True) or the system."""
    fn = symbol("fd_gn_sampled_geometry", [ctypes.c_int] * 4
                + [ctypes.c_void_p])
    out = (ctypes.c_int * 11)()
    ok = fn(n_p, k, itemsize, int(step), ctypes.addressof(out))
    return KernelGeometry(bool(ok), *out)


class SampledWorkspace:
    """Scratch of the sampled kernels for systems of one shape: the
    clusters' float64 slices of the Gram and the int32 ticket counter
    (zero between calls; the last cluster of a call resets it). Make one
    per run and pass it to every call (ops/gn.gn_system / gn_step): the
    calls then allocate no scratch, and a CUDA graph can capture them.
    A workspace serves ONE stream at a time: two calls in flight on two
    streams would share the counter. On a CPU device it holds nothing
    (the plain versions need no scratch)."""

    def __init__(self, n_p: int, kp: int, k: int, dtype, device):
        self.key = (n_p, kp, k, dtype, torch.device(device))
        self.partials = self.counter = None
        if torch.device(device).type == "cuda":
            itemsize = torch.empty((), dtype=dtype).element_size()
            geo = kernel_geometry(n_p, k, itemsize, False)
            self.partials = torch.empty(max(geo.ws_len, 1),
                                        dtype=torch.float64, device=device)
            self.counter = torch.zeros(1, dtype=torch.int32, device=device)


@functools.cache
def _kernel(kind: str, dtype):
    suffix, scalar = SCALARS[dtype]
    tail = [ctypes.c_int] if kind == "step" else []
    return symbol(f"fd_gn_sampled_{kind}_{suffix}",
                  [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                  + [scalar, scalar] + tail + [ctypes.c_void_p])


@functools.cache
def _traj_kernel(dtype):
    suffix, scalar = SCALARS[dtype]
    return symbol(f"fd_gn_traj_{suffix}",
                  [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                  + [scalar, scalar] + [ctypes.c_int] * 3
                  + [scalar, scalar, ctypes.c_void_p])


def _launch(kind, p6p, y, cp, wgt_p, k, hdx, hdy, workspace, extra=()):
    """Check the inputs, then launch the sampled kernel `kind` into a
    fresh output; returns it."""
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
    e = p6p.element_size()
    if not 0 < k < kp or _round_up(k + 1, SAMPLED_LANE_STEP) > kp \
            or (kp * e) % 16 or p6p.data_ptr() % 16 \
            or 6 * n_p * kp >= 2 ** 31:
        raise ValueError(f"gn_sampled kernels: k={k} does not fit the "
                         f"padded blocks (n_p={n_p}, kp={kp}; rows of 16 "
                         f"bytes, k + 1 rounded up to {SAMPLED_LANE_STEP} "
                         f"live lanes)")
    if kind == "step" and kp > MAX_STEP_LANES:
        raise ValueError(f"gn_step kernel: kp={kp} > {MAX_STEP_LANES}")
    geo = kernel_geometry(n_p, k, e, kind == "step")
    if not geo.fits:
        raise ValueError(f"gn_sampled_{kind} kernel: k={k} needs more "
                         f"shared memory than a block has or more live "
                         f"lanes than its tile table numbers ({geo.smem} "
                         f"bytes, {geo.lanes} live lanes)")
    if workspace is None:
        workspace = SampledWorkspace(n_p, kp, k, dtype, device)
    elif workspace.key != (n_p, kp, k, dtype, device):
        raise ValueError(f"workspace made for {workspace.key}, called with "
                         f"{(n_p, kp, k, dtype, device)}")
    out = torch.empty((2, kp) if kind == "step" else (kp, kp), dtype=dtype,
                      device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (p6p.data_ptr(), y.data_ptr(), cp.data_ptr(), wgt_p.data_ptr(),
            workspace.partials.data_ptr(), workspace.counter.data_ptr(),
            out.data_ptr(), n_p, kp, k, float(hdx), float(hdy), *extra,
            stream)
    if device.index == torch.cuda.current_device():
        rc = _kernel(kind, dtype)(*args)
    else:
        with torch.cuda.device(device):
            rc = _kernel(kind, dtype)(*args)
    check_launch(rc, f"gn_sampled_{kind}")
    return out


def gn_system_cuda(p6p, y, cp, wgt_p, k: int, hdx: float, hdy: float, *,
                   workspace: SampledWorkspace | None = None):
    """The weighted sampled system on padded CUDA tensors, in ONE launch.

    p6p: (6, n_p, kp) blocks, float32 or float64, kp a multiple of 16
    bytes and at least round_up(k + 1, 16); y: (k,); cp: (n_p, 2); wgt_p:
    (n_p[, 1]); all contiguous, of one dtype, on one device. `workspace`
    (SampledWorkspace for this shape) is made for the call when None.
    Returns gext (kp, kp) in that dtype, freshly allocated (the clusters'
    partials summed in float64). Launches on the current stream and does
    not synchronise; raises on any input the kernel does not take and on
    a refused launch.
    """
    global SYSTEM_LAUNCHES
    gext = _launch("system", p6p, y, cp, wgt_p, k, hdx, hdy, workspace)
    SYSTEM_LAUNCHES += 1
    return gext


def gn_step_cuda(p6p, y, cp, wgt_p, k: int, hdx: float, hdy: float, *,
                 solve_iters: int = 24,
                 workspace: SampledWorkspace | None = None):
    """One fused Gauss-Newton iteration on padded CUDA tensors, in ONE
    launch: the system of gn_system_cuda, then `solve_iters` masked CG
    steps. Returns (dy (k,), rn 0-dim), both in the blocks' dtype, views
    of a freshly allocated (2, kp) output. Needs kp <= 256 and the CG's
    (k, k) Gram in one block's shared memory."""
    global STEP_LAUNCHES
    if solve_iters < 0:
        raise ValueError(f"gn_step kernel: solve_iters={solve_iters} < 0")
    out = _launch("step", p6p, y, cp, wgt_p, k, hdx, hdy, workspace,
                  (int(solve_iters),))
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
