"""Wrapper of the hand-written full-grid Gauss-Newton system kernel
(csrc/gn_full.cu).

The kernel replaces finitedifference_tpu/ops/pallas_gn_full.py::
_make_full_kernel (B3): one call gives the (kp, kp) float64 Gram
extension of the full-grid LSPG system at y, and with first=True the
step constant cp. It runs in float32 or float64. The plain version of
the same function is ops/gn_full.gn_full_ref.

LAUNCHES counts the kernel's launches in this process (one per call;
each call runs the fused kernel and its float64 reduction on the current
stream), so a run can
show that its main path went through the kernel.
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

LAUNCHES = 0

# the kernel's geometry (csrc/gn_full.cu)
LANE_STEP = 16            # live lanes round up to a multiple
CHUNK_CELLS = (32, 16, 8, 4)   # cells staged per step, largest that fits
TILE = 8                  # a thread's register tile of the Gram is 8x8
MAX_GROUP = 160           # threads of one group of tiles
# by the working type's size: (threads of a CTA, CTAs per SM, the largest
# chunk tried), the fastest of those timed on an H100 at 96 live lanes
# (PERF.md)
TUNING = {4: (192, 2, 16), 8: (96, 3, 8)}
COEFS = 12                # per-cell coefficients kept in shared memory
SHARED_BUDGET = 200 * 1024     # of the 227 KB a block can use


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def live_lanes(k: int) -> int:
    """Lanes 0..k rounded up to the kernel's lane granularity."""
    return _round_up(k + 1, LANE_STEP)


def shared_bytes(chunk: int, lanes: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA: y, the coefficients, two stages
    (rows of the chunk's cells and the cell before, of their south
    neighbours, the mask, slbc or cp) and the rows A."""
    stride = lanes + 16 // itemsize
    stage = 2 * (chunk + 1) * stride + 2 * chunk * stride + 3 * chunk
    return itemsize * (lanes + COEFS * chunk + 2 * stage
                       + 2 * chunk * stride)


class FullGeometry(NamedTuple):
    """How one call is cut: `lanes` live lanes; `n_chunks` chunks of
    `chunk` consecutive padded cells (the last one ragged), chunk c going
    to CTA c mod n_ctas; a CTA has `threads` threads, whole groups of one
    thread per 8x8 tile of the live lanes' upper triangle."""
    lanes: int
    chunk: int
    n_chunks: int
    n_ctas: int
    threads: int

    def cta_chunks(self, cta: int) -> range:
        """The chunks CTA `cta` walks, in order."""
        return range(cta, self.n_chunks, self.n_ctas)

    def chunk_cells(self, c: int, n_pad: int) -> range:
        """The padded cells of chunk c."""
        return range(c * self.chunk, min((c + 1) * self.chunk, n_pad))


def full_geometry(n_pad: int, k: int, itemsize: int,
                  n_sm: int) -> FullGeometry:
    """The kernel's geometry for n_pad cells, k modes, a working type of
    `itemsize` bytes and a card of `n_sm` SMs: one persistent CTA per SM
    (fewer when there are fewer chunks), fixed by the shape alone."""
    lanes = live_lanes(k)
    max_threads, ctas_per_sm, max_chunk = TUNING[itemsize]
    tiles = (lanes // TILE) * (lanes // TILE + 1) // 2
    group = min(_round_up(tiles, 32), MAX_GROUP)
    threads = max(1, max_threads // group) * group
    fits = [c for c in CHUNK_CELLS if c <= max_chunk
            and shared_bytes(c, lanes, itemsize) * ctas_per_sm
            <= SHARED_BUDGET]
    if not fits:
        raise ValueError(f"gn_full kernel: k={k} needs more shared memory "
                         f"than a block has")
    chunk = fits[0]
    n_chunks = -(-n_pad // chunk)
    return FullGeometry(lanes, chunk, n_chunks,
                        min(ctas_per_sm * n_sm, n_chunks), threads)


@functools.cache
def _kernel(dtype):
    suffix, scalar = SCALARS[dtype]
    return symbol(f"fd_gn_full_{suffix}",
                  [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                  + [scalar, scalar] + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])


def gn_full_cuda(vu_p, vv_p, y, aux, dmask, k: int, nxp: int, hdx: float,
                 hdy: float, *, first: bool):
    """The full-grid system on padded CUDA tensors.

    vu_p, vv_p: (n_pad, kp) basis halves, float32 or float64; y: (k,);
    aux: slbc (n_pad[, 1]) when first, else cp (n_pad, 2); dmask
    (n_pad[, 1]); all contiguous, of one dtype, on one device.
    Returns (gext (kp, kp) float64, cp (n_pad, 2) or None). Launches on
    the current stream and does not synchronise; raises on any input the
    kernel does not take and on a refused launch.
    """
    global LAUNCHES
    if not isinstance(vu_p, torch.Tensor) or vu_p.dim() != 2:
        raise ValueError("vu_p: expected an (n_pad, kp) tensor")
    dtype, device = vu_p.dtype, vu_p.device
    if dtype not in SCALARS:
        raise ValueError(f"the gn_full kernel takes float32 or float64, "
                         f"got {dtype}")
    n_pad, kp = vu_p.shape
    check_tensor("vu_p", vu_p, device, dtype, [(n_pad, kp)])
    check_tensor("vv_p", vv_p, device, dtype, [(n_pad, kp)])
    check_tensor("y", y, device, dtype, [(k,)])
    check_tensor("dmask", dmask, device, dtype, [(n_pad,), (n_pad, 1)])
    if first:
        check_tensor("slbc", aux, device, dtype, [(n_pad,), (n_pad, 1)])
    else:
        check_tensor("cp", aux, device, dtype, [(n_pad, 2)])
    if not 0 < k < kp or live_lanes(k) > kp or nxp <= 0 or n_pad % nxp \
            or n_pad % 8:
        raise ValueError(f"gn_full kernel: k={k}, nxp={nxp} do not fit "
                         f"the layout (n_pad={n_pad}, a multiple of 8, "
                         f"kp={kp})")
    if any(x.data_ptr() % 16 for x in (vu_p, vv_p, aux, dmask)):
        raise ValueError("gn_full kernel: inputs must be 16-byte aligned")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    geo = full_geometry(n_pad, k, vu_p.element_size(), n_sm)
    partials = torch.empty((geo.n_ctas, geo.lanes, geo.lanes), dtype=dtype,
                           device=device)
    gext = torch.empty((kp, kp), dtype=torch.float64, device=device)
    cp = torch.empty((n_pad, 2), dtype=dtype, device=device) if first \
        else None
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = _kernel(dtype)(
            vu_p.data_ptr(), vv_p.data_ptr(), y.data_ptr(), aux.data_ptr(),
            dmask.data_ptr(), cp.data_ptr() if first else None,
            partials.data_ptr(), gext.data_ptr(), n_pad, kp, k, geo.lanes,
            nxp, int(first), float(hdx), float(hdy), geo.chunk, geo.n_ctas,
            geo.threads, stream)
    check_launch(rc, "gn_full")
    LAUNCHES += 1
    return gext, cp
