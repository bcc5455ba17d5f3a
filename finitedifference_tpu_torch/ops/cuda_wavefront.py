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

from finitedifference_tpu_torch.ops._build import load_library

LAUNCHES = 0

# limits of the kernel: one thread per row up to 1024 rows, then at most
# 512 threads of 4 or 8 rows; 8 * ny_pad values of shared memory out of
# the 227 KB a block can use
MAX_NY_PAD = 512 * 8
MAX_SHARED_BYTES = 232448

_SYMBOLS = {torch.float32: ("fd_wavefront_solve_f32", ctypes.c_float),
            torch.float64: ("fd_wavefront_solve_f64", ctypes.c_double)}


@functools.cache
def _kernel(dtype):
    lib = load_library()
    name, scalar = _SYMBOLS[dtype]
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [scalar, scalar, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fd_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.fd_cuda_error_string


def _check(su, sv, sfu, sfv, grid, lay):
    shape = (lay.nd_pad, lay.ny_pad)
    for name, x in (("su", su), ("sv", sv), ("sfu", sfu), ("sfv", sfv)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"{name}: the wavefront kernel takes CUDA "
                             f"tensors, got {getattr(x, 'device', type(x))}")
        if x.device != su.device or x.dtype != su.dtype:
            raise ValueError(f"{name}: all inputs must share one device "
                             f"and dtype ({su.device}, {su.dtype}), got "
                             f"({x.device}, {x.dtype})")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if su.dtype not in _SYMBOLS:
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
    fn, error_string = _kernel(su.dtype)
    sdu = torch.empty_like(su)
    sdv = torch.empty_like(su)
    stream = torch.cuda.current_stream(su.device).cuda_stream
    with torch.cuda.device(su.device):
        rc = fn(su.data_ptr(), sv.data_ptr(), sfu.data_ptr(),
                sfv.data_ptr(), sdu.data_ptr(), sdv.data_ptr(),
                lay.nx, lay.ny, lay.nd_pad, lay.ny_pad,
                float(0.5 * dt / grid.dx), float(0.5 * dt / grid.dy),
                stream)
    if rc != 0:
        raise RuntimeError(f"wavefront kernel launch failed: "
                           f"{error_string(rc).decode()} (cudaError {rc})")
    LAUNCHES += 1
    return sdu, sdv
