"""Wrapper of the hand-written wavefront kernel (csrc/wavefront.cu).

The kernel replaces finitedifference_tpu/ops/pallas_wavefront.py::
_make_kernel_reg: the exact triangular solve of the Newton Jacobian on
padded skewed fields (nd_pad, ny_pad). It runs in float32 or float64 (the
TPU kernel was float32 only because Mosaic has no f64). The plain version
of the same function is ops/skewed.solve_skewed_ref.

LAUNCHES counts the kernel's launches in this process, so a run can show
that its main path went through the kernel.
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

# limits of the kernel: one thread per row up to 1024 rows, then at most
# 512 threads of 4 or 8 rows; 8 * ny_pad values of shared memory out of
# the 227 KB a block can use
MAX_NY_PAD = 512 * 8
MAX_SHARED_BYTES = 232448

@functools.cache
def _kernel(dtype):
    suffix, scalar = SCALARS[dtype]
    return symbol(f"fd_wavefront_solve_{suffix}",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                  + [scalar, scalar, ctypes.c_void_p])


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
