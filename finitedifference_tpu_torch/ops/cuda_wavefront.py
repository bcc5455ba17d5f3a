"""Wrappers of the hand-written wavefront kernels (csrc/wavefront.cu).

solve_skewed_cuda replaces finitedifference_tpu/ops/pallas_wavefront.py::
_make_kernel_reg (B1): the exact triangular solve of the Newton Jacobian
on padded skewed fields (nd_pad, ny_pad). solve_skewed_seg_cuda replaces
pallas_wavefront.py::_make_kernel_seg (B7): the overlapping-segment
approximate solve, one CTA per segment. Both run in float32 or float64
(the TPU kernels were float32 only because Mosaic has no f64). Their
plain versions are ops/skewed.solve_skewed_ref and solve_skewed_seg_ref.

LAUNCHES and SEG_LAUNCHES count the two kernels' launches in this
process, so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from finitedifference_tpu_torch.ops._build import (
    SCALARS,
    check_launch,
    check_tensor,
    symbol,
)

LAUNCHES = 0
SEG_LAUNCHES = 0

# limits of the kernel: one thread per row up to 1024 rows, then at most
# 512 threads of 4 or 8 rows; 8 * ny_pad values of shared memory out of
# the 227 KB a block can use
MAX_NY_PAD = 512 * 8
MAX_SHARED_BYTES = 232448

@functools.cache
def _kernel(dtype, seg: bool = False):
    suffix, scalar = SCALARS[dtype]
    name = f"fd_wavefront_solve_{'seg_' if seg else ''}{suffix}"
    return symbol(name, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                  + [scalar, scalar] + [ctypes.c_int] * (2 * seg)
                  + [ctypes.c_void_p])


def _check(su, sv, sfu, sfv, grid, lay):
    shape = (lay.nd_pad, lay.ny_pad)
    for name, x in (("su", su), ("sv", sv), ("sfu", sfu), ("sfv", sfv)):
        check_tensor(name, x, getattr(su, "device", None),
                     getattr(su, "dtype", None), [shape])
    if su.dtype not in SCALARS:
        raise ValueError(f"the wavefront kernel takes float32 or float64, "
                         f"got {su.dtype}")
    if (lay.nx, lay.ny) != (grid.nx, grid.ny) or lay.ny > lay.ny_pad \
            or lay.nd_pad < lay.ndiag:
        raise ValueError(f"layout {lay} does not fit grid "
                         f"{grid.nx}x{grid.ny}")
    if lay.ny_pad > MAX_NY_PAD or \
            8 * lay.ny_pad * su.element_size() > MAX_SHARED_BYTES:
        raise ValueError(f"ny_pad={lay.ny_pad} exceeds what the wavefront "
                         f"kernel holds in one block for {su.dtype}")


def solve_skewed_cuda(su, sv, sfu, sfv, dt, grid, lay):
    """Exact triangular solve on padded skewed CUDA tensors.

    su, sv (state) and sfu, sfv (right-hand side) are contiguous
    (nd_pad, ny_pad) tensors of one dtype, float32 or float64, on one
    CUDA device. Returns (sdu, sdv) of the same shape, with exact zeros
    off the band. Launches on the current stream and does not
    synchronise; raises on any input the kernel does not take and on a
    refused launch.
    """
    global LAUNCHES
    _check(su, sv, sfu, sfv, grid, lay)
    fn = _kernel(su.dtype)
    sdu = torch.empty_like(su)
    sdv = torch.empty_like(su)
    stream = torch.cuda.current_stream(su.device).cuda_stream
    with torch.cuda.device(su.device):
        rc = fn(su.data_ptr(), sv.data_ptr(), sfu.data_ptr(),
                sfv.data_ptr(), sdu.data_ptr(), sdv.data_ptr(),
                lay.nx, lay.ny, lay.nd_pad, lay.ny_pad,
                float(0.5 * dt / grid.dx), float(0.5 * dt / grid.dy),
                stream)
    check_launch(rc, "wavefront")
    LAUNCHES += 1
    return sdu, sdv


def solve_skewed_seg_cuda(su, sv, sfu, sfv, dt, grid, lay, *, n_seg: int,
                          overlap: int):
    """Overlapping-segment solve on padded skewed CUDA tensors: segment g
    owns diagonals [g*seg_len, (g+1)*seg_len), seg_len = ceil(nd_pad /
    n_seg), and warms up from a zero carry over the `overlap` diagonals
    before them. Inputs and limits as solve_skewed_cuda; one CTA per
    segment. Returns (sdu, sdv) with exact zeros off the band."""
    global SEG_LAUNCHES
    _check(su, sv, sfu, sfv, grid, lay)
    if not 1 <= n_seg <= lay.nd_pad or overlap < 0:
        raise ValueError(f"segmented wavefront kernel: n_seg={n_seg} must "
                         f"be in [1, nd_pad={lay.nd_pad}] and overlap="
                         f"{overlap} >= 0")
    fn = _kernel(su.dtype, seg=True)
    sdu = torch.empty_like(su)
    sdv = torch.empty_like(su)
    stream = torch.cuda.current_stream(su.device).cuda_stream
    with torch.cuda.device(su.device):
        rc = fn(su.data_ptr(), sv.data_ptr(), sfu.data_ptr(),
                sfv.data_ptr(), sdu.data_ptr(), sdv.data_ptr(),
                lay.nx, lay.ny, lay.nd_pad, lay.ny_pad,
                float(0.5 * dt / grid.dx), float(0.5 * dt / grid.dy),
                n_seg, overlap, stream)
    check_launch(rc, "wavefront_seg")
    SEG_LAUNCHES += 1
    return sdu, sdv
