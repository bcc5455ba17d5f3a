"""Wrappers of the hand-written residual kernels (csrc/skewed_residual.cu).

update_residual_cuda is one update of the skewed FOM's Newton loop: the
state updated, the Crank-Nicolson residual at it, the residual's norm and
the stop test, in one launch. step_constant_cuda is a step's constant and
the norm of the residual at the step's start, in one launch. Neither
replaces a TPU kernel: on the TPU, XLA fused the same expressions under
jit. Their plain versions are ops/skewed.skewed_update_residual_ref and
skewed_step_constant_norm_ref.

RESIDUAL_LAUNCHES and STEP_CONSTANT_LAUNCHES count the two kernels'
launches in this process, so a run can show that its main path went
through them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from finitedifference_tpu_torch.ops._build import (
    SCALARS,
    check_launch,
    check_tensor,
    symbol,
)

RESIDUAL_LAUNCHES = 0
STEP_CONSTANT_LAUNCHES = 0


@functools.cache
def _update_kernel(dtype):
    suffix, scalar = SCALARS[dtype]
    return symbol(f"fd_skewed_update_residual_{suffix}",
                  [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                  + [scalar] * 4 + [ctypes.c_void_p])


@functools.cache
def _step_kernel(dtype):
    suffix, scalar = SCALARS[dtype]
    return symbol(f"fd_skewed_step_constant_{suffix}",
                  [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                  + [scalar] * 3 + [ctypes.c_void_p])


@functools.cache
def _blocks(nd_pad: int, ny_pad: int) -> int:
    return symbol("fd_skewed_residual_blocks",
                  [ctypes.c_int, ctypes.c_int])(nd_pad, ny_pad)


@functools.cache
def _constants(dtype, dx: float, dy: float, dt: float):
    """(1/dx, 1/dy, dt/2) as the eager expressions use them: PyTorch on
    the card divides by a Python scalar as a multiplication by its
    reciprocal, taken in float64 and rounded to the working type
    (csrc/skewed_residual.cu); ctypes rounds dt/2 to it as PyTorch
    rounds a Python scalar factor."""
    np_t = np.float32 if dtype == torch.float32 else np.float64
    return float(np_t(1.0 / dx)), float(np_t(1.0 / dy)), 0.5 * dt


class ResidualWorkspace:
    """Scratch of the residual kernels for fields of one layout on one CUDA
    device: two sums a block of a launch, and the unsigned 32-bit ticket
    that picks the block that finishes the norm (zero between launches: it
    wraps back). Make one per run and pass it to every call: the calls
    then allocate no scratch. A workspace serves ONE stream at a time: two
    launches in flight on two streams would share the ticket."""

    def __init__(self, lay, dtype, device):
        self.partials = torch.empty(2 * _blocks(lay.nd_pad, lay.ny_pad),
                                    dtype=dtype, device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
        self.key = (lay.nd_pad, lay.ny_pad, dtype, self.ticket.device)


def _check(names, xs, lay, grid):
    """Raise unless xs are contiguous (nd_pad, ny_pad) CUDA tensors of one
    device and one dtype, float32 or float64, and lay fits grid."""
    first = xs[0]
    for name, x in zip(names, xs):
        check_tensor(name, x, getattr(first, "device", None),
                     getattr(first, "dtype", None),
                     [(lay.nd_pad, lay.ny_pad)])
    if first.dtype not in SCALARS:
        raise ValueError(f"the residual kernels take float32 or float64, "
                         f"got {first.dtype}")
    if (lay.nx, lay.ny) != (grid.nx, grid.ny) or lay.ny > lay.ny_pad \
            or lay.nd_pad < lay.ndiag:
        raise ValueError(f"layout {lay} does not fit grid "
                         f"{grid.nx}x{grid.ny}")


def _check_workspace(workspace, lay, dtype, device):
    key = (lay.nd_pad, lay.ny_pad, dtype, device)
    if getattr(workspace, "key", None) != key:
        raise ValueError(f"workspace {getattr(workspace, 'key', None)} does "
                         f"not serve {key}")


def update_residual_cuda(u, v, du, dv, cp_u, cp_v, dt, grid, lay, *,
                         init_norm, rn_prev, cutoff, workspace):
    """One Newton update on padded skewed CUDA tensors: u' = u - du,
    v' = v - dv, the residual (ru, rv) at (u', v') from the step constant
    (cp_u, cp_v), rn = its norm and stop = rn / init_norm < cutoff or
    rn > 0.99 rn_prev. du = dv = None updates nothing (u' is u);
    rn_prev = None leaves the stagnation term out.

    The fields are contiguous (nd_pad, ny_pad) tensors of one dtype,
    float32 or float64, on one CUDA device; init_norm and rn_prev 0-d
    tensors of the same; `workspace` a ResidualWorkspace of the fields'
    layout, dtype and device. Returns (u', v', ru, rv, rn, stop), rn a 0-d
    tensor and stop a 0-d bool, all on the device; ru and rv are the
    eager expressions' bits. Launches on the current stream and does not
    synchronise; raises on any input the kernel does not take and on a
    refused launch.
    """
    global RESIDUAL_LAUNCHES
    update = du is not None
    fields = (u, v, du, dv, cp_u, cp_v) if update else (u, v, cp_u, cp_v)
    names = ("u", "v", "du", "dv", "cp_u", "cp_v") if update \
        else ("u", "v", "cp_u", "cp_v")
    _check(names, fields, lay, grid)
    dtype, device = u.dtype, u.device
    scalars = (init_norm,) if rn_prev is None else (init_norm, rn_prev)
    for name, x in zip(("init_norm", "rn_prev"), scalars):
        check_tensor(name, x, device, dtype, [()])
    _check_workspace(workspace, lay, dtype, device)
    ru, rv = torch.empty_like(u), torch.empty_like(u)
    u_out, v_out = (torch.empty_like(u), torch.empty_like(u)) if update \
        else (u, v)
    rn = torch.empty((), dtype=dtype, device=device)
    stop = torch.empty((), dtype=torch.bool, device=device)
    rdx, rdy, half_dt = _constants(dtype, grid.dx, grid.dy, float(dt))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = _update_kernel(dtype)(
            u.data_ptr(), v.data_ptr(),
            du.data_ptr() if update else None,
            dv.data_ptr() if update else None,
            cp_u.data_ptr(), cp_v.data_ptr(),
            u_out.data_ptr() if update else None,
            v_out.data_ptr() if update else None,
            ru.data_ptr(), rv.data_ptr(), workspace.partials.data_ptr(),
            workspace.ticket.data_ptr(), rn.data_ptr(), stop.data_ptr(),
            init_norm.data_ptr(),
            None if rn_prev is None else rn_prev.data_ptr(),
            lay.nx, lay.ny, lay.nd_pad, lay.ny_pad, rdx, rdy, half_dt,
            float(cutoff), stream)
    check_launch(rc, "skewed_update_residual")
    RESIDUAL_LAUNCHES += 1
    return u_out, v_out, ru, rv, rn, stop


def step_constant_cuda(up, vp, dt, grid, lay, src_sk, lbc_sk, *,
                       workspace):
    """A step's constant on padded skewed CUDA tensors: the cp half of the
    residual at the step's start (up, vp) with the source src_sk and the
    inflow term lbc_sk, the residual r0 = r(up, vp) and its norm. Inputs
    as update_residual_cuda's fields. Returns (cp_u, cp_v, r0u, r0v,
    init_norm), the fields the eager expressions' bits and init_norm a
    0-d tensor on the device. Launches on the current stream and does
    not synchronise; raises on any input the kernel does not take and on
    a refused launch."""
    global STEP_CONSTANT_LAUNCHES
    _check(("up", "vp", "src_sk", "lbc_sk"), (up, vp, src_sk, lbc_sk), lay,
           grid)
    dtype, device = up.dtype, up.device
    _check_workspace(workspace, lay, dtype, device)
    out = [torch.empty_like(up) for _ in range(4)]
    norm = torch.empty((), dtype=dtype, device=device)
    rdx, rdy, half_dt = _constants(dtype, grid.dx, grid.dy, float(dt))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = _step_kernel(dtype)(
            up.data_ptr(), vp.data_ptr(), src_sk.data_ptr(),
            lbc_sk.data_ptr(), *(x.data_ptr() for x in out),
            workspace.partials.data_ptr(), workspace.ticket.data_ptr(),
            norm.data_ptr(),
            lay.nx, lay.ny, lay.nd_pad, lay.ny_pad, rdx, rdy, half_dt,
            stream)
    check_launch(rc, "skewed_step_constant")
    STEP_CONSTANT_LAUNCHES += 1
    return (*out, norm)
