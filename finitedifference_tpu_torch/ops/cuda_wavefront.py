"""Wrappers of the hand-written wavefront kernels (csrc/wavefront.cu).

solve_skewed_cuda replaces finitedifference_tpu/ops/pallas_wavefront.py::
_make_kernel_reg (B1): the exact triangular solve of the Newton Jacobian
on padded skewed fields (nd_pad, ny_pad), a chain of warps over one thread
block cluster. solve_unskewed_cuda replaces pallas_wavefront.py::
_make_kernel (B2): the same solve, the same kernel and the same bits, on
the (ny, nx) fields as they are, read and written in place of a skew and
an unskew. solve_skewed_seg_cuda replaces
pallas_wavefront.py::_make_kernel_seg (B7): the overlapping-segment
approximate solve, one CTA of chained warps per segment. All run in
float32 or float64 (the TPU kernels were float32 only because Mosaic has
no f64). Their plain versions are ops/skewed.solve_skewed_ref,
ops/wavefront.solve_jacobian_wavefront_ref and solve_skewed_seg_ref.

LAUNCHES, UNSKEWED_LAUNCHES and SEG_LAUNCHES count the three kernels'
launches in this process, so a run can show that its main path went
through them.
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
UNSKEWED_LAUNCHES = 0
SEG_LAUNCHES = 0

# limits of the kernels. The exact solve: a cluster of 8 CTAs of at most
# 16 warps, one row a lane. The segment solve: one CTA of at most 16 warps
# of 2 rows a lane up to 1024 rows, 12 warps of 4 up to 1536, 16 warps of 8
# up to 4096
MAX_NY_PAD = 32 * 16 * 8


@functools.cache
def _kernel(dtype, seg: bool = False):
    suffix, scalar = SCALARS[dtype]
    name = f"fd_wavefront_solve_{'seg_' if seg else ''}{suffix}"
    return symbol(name, [ctypes.c_void_p] * (6 + seg) + [ctypes.c_int] * 4
                  + [scalar, scalar] + [ctypes.c_int] * (2 * seg)
                  + [ctypes.c_void_p])


@functools.cache
def _unskewed_kernel(dtype):
    suffix, scalar = SCALARS[dtype]
    return symbol(f"fd_wavefront_solve_unskewed_{suffix}",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                  + [scalar, scalar, ctypes.c_void_p])


def _check_fields(names, xs, shape):
    """Raise unless xs are contiguous CUDA tensors of `shape` and of one
    device and one dtype, float32 or float64."""
    first = xs[0]
    for name, x in zip(names, xs):
        check_tensor(name, x, getattr(first, "device", None),
                     getattr(first, "dtype", None), [shape])
    if first.dtype not in SCALARS:
        raise ValueError(f"the wavefront kernel takes float32 or float64, "
                         f"got {first.dtype}")


def _check(su, sv, sfu, sfv, grid, lay):
    _check_fields(("su", "sv", "sfu", "sfv"), (su, sv, sfu, sfv),
                  (lay.nd_pad, lay.ny_pad))
    if (lay.nx, lay.ny) != (grid.nx, grid.ny) or lay.ny > lay.ny_pad \
            or lay.nd_pad < lay.ndiag:
        raise ValueError(f"layout {lay} does not fit grid "
                         f"{grid.nx}x{grid.ny}")
    if lay.ny_pad > MAX_NY_PAD:
        raise ValueError(f"ny_pad={lay.ny_pad} exceeds what the wavefront "
                         f"kernel holds for {su.dtype}")


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


def solve_unskewed_cuda(u, v, fu, fv, dt, grid):
    """Exact triangular solve on the unskewed fields: B1's chain on
    contiguous (ny, nx) CUDA tensors u, v (state) and fu, fv (right-hand
    side) of one dtype, float32 or float64, on one device, in one launch
    with no skew or unskew. Returns (du, dv), contiguous (ny, nx), bit
    for bit what solve_skewed_cuda gives between to_skewed and
    from_skewed. Launches on the current stream and does not synchronise;
    raises on any input the kernel does not take and on a refused
    launch."""
    global UNSKEWED_LAUNCHES
    _check_fields(("u", "v", "fu", "fv"), (u, v, fu, fv),
                  (grid.ny, grid.nx))
    if grid.ny > MAX_NY_PAD:
        raise ValueError(f"ny={grid.ny} exceeds the {MAX_NY_PAD} rows the "
                         f"wavefront kernel holds")
    fn = _unskewed_kernel(u.dtype)
    du = torch.empty_like(u)
    dv = torch.empty_like(u)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        rc = fn(u.data_ptr(), v.data_ptr(), fu.data_ptr(), fv.data_ptr(),
                du.data_ptr(), dv.data_ptr(), grid.nx, grid.ny,
                float(0.5 * dt / grid.dx), float(0.5 * dt / grid.dy),
                stream)
    check_launch(rc, "wavefront_unskewed")
    UNSKEWED_LAUNCHES += 1
    return du, dv


def solve_skewed_seg_cuda(su, sv, sfu, sfv, dt, grid, lay, *, n_seg: int,
                          overlap: int):
    """Overlapping-segment solve on padded skewed CUDA tensors: segment g
    owns diagonals [g*seg_len, (g+1)*seg_len), seg_len = ceil(nd_pad /
    n_seg), and warms up from a zero carry over the `overlap` diagonals
    before them. Inputs and limits as solve_skewed_cuda; the cells'
    reciprocals for the whole field first (one pass over all SMs), then
    one CTA of chained warps per segment. Returns (sdu, sdv) with exact
    zeros off the band."""
    global SEG_LAUNCHES
    _check(su, sv, sfu, sfv, grid, lay)
    if not 1 <= n_seg <= lay.nd_pad or overlap < 0:
        raise ValueError(f"segmented wavefront kernel: n_seg={n_seg} must "
                         f"be in [1, nd_pad={lay.nd_pad}] and overlap="
                         f"{overlap} >= 0")
    fn = _kernel(su.dtype, seg=True)
    sinv = torch.empty_like(su)   # the cells' reciprocals, scratch
    sdu = torch.empty_like(su)
    sdv = torch.empty_like(su)
    stream = torch.cuda.current_stream(su.device).cuda_stream
    with torch.cuda.device(su.device):
        rc = fn(su.data_ptr(), sv.data_ptr(), sfu.data_ptr(),
                sfv.data_ptr(), sinv.data_ptr(), sdu.data_ptr(),
                sdv.data_ptr(),
                lay.nx, lay.ny, lay.nd_pad, lay.ny_pad,
                float(0.5 * dt / grid.dx), float(0.5 * dt / grid.dy),
                n_seg, overlap, stream)
    check_launch(rc, "wavefront_seg")
    SEG_LAUNCHES += 1
    return sdu, sdv
