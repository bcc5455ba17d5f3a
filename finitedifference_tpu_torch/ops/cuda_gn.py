"""Wrappers of the hand-written sampled-mesh Gauss-Newton kernels
(csrc/gn_sampled.cu).

gn_system_cuda replaces finitedifference_tpu/ops/pallas_gn.py::
_make_kernel (B4): the weighted (kp, kp) Gram extension of the factored
HPROM system on the ECSW mesh. gn_step_cuda replaces
pallas_gn.py::_make_step_kernel (B5): the same system, then a masked CG
on the device, giving (dy, ||W r||) for one fused Gauss-Newton
iteration. Both run in float32 or float64. Their plain versions are
ops/gn.gn_system_ref and ops/gn.gn_step_ref.

SYSTEM_LAUNCHES and STEP_LAUNCHES count the two kernels' launches in
this process (one per call), so a run can show that its main path went
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
from finitedifference_tpu_torch.ops.cuda_gn_full import gram_chunks, live_lanes

SYSTEM_LAUNCHES = 0
STEP_LAUNCHES = 0

# the CG runs one CTA with one thread per lane (csrc/gn_sampled.cu)
MAX_STEP_LANES = 256

@functools.cache
def _kernel(kind: str, dtype):
    suffix, scalar = SCALARS[dtype]
    n_ptr = 8 if kind == "system" else 9
    tail = [ctypes.c_int] * (2 if kind == "system" else 3)
    return symbol(f"fd_gn_sampled_{kind}_{suffix}",
                  [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                  + [scalar, scalar] + tail + [ctypes.c_void_p])


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
