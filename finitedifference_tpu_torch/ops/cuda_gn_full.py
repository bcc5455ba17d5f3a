"""Wrapper of the hand-written full-grid Gauss-Newton system kernel
(csrc/gn_full.cu).

The kernel replaces finitedifference_tpu/ops/pallas_gn_full.py::
_make_full_kernel (B3): one call gives the (kp, kp) float64 Gram
extension of the full-grid LSPG system at y, and with first=True the
step constant cp. It runs in float32 or float64. The plain version of
the same function is ops/gn_full.gn_full_ref.

LAUNCHES counts the kernel's launches in this process (one per call;
each call runs the kernel's passes on the current stream), so a run can
show that its main path went through the kernel.
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

# the kernel's partial-Gram geometry (csrc/gn_common.cuh)
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
def _kernel(dtype):
    suffix, scalar = SCALARS[dtype]
    return symbol(f"fd_gn_full_{suffix}",
                  [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                  + [scalar, scalar, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p])


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
    k1p = live_lanes(k)
    if not 0 < k < kp or k1p > kp or nxp <= 0 or n_pad % nxp \
            or n_pad * k1p >= 2 ** 31:
        raise ValueError(f"gn_full kernel: k={k}, nxp={nxp} do not fit "
                         f"the layout (n_pad={n_pad}, kp={kp})")

    rows = 2 * n_pad
    rpc, n_chunks = gram_chunks(rows)
    s = torch.empty(rows, dtype=dtype, device=device)
    a = torch.empty((rows, k1p), dtype=dtype, device=device)
    partials = torch.empty((n_chunks, k1p, k1p), dtype=dtype, device=device)
    gext = torch.empty((kp, kp), dtype=torch.float64, device=device)
    cp = torch.empty((n_pad, 2), dtype=dtype, device=device) if first \
        else None
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = _kernel(dtype)(
            vu_p.data_ptr(), vv_p.data_ptr(), y.data_ptr(), aux.data_ptr(),
            dmask.data_ptr(), cp.data_ptr() if first else None,
            s.data_ptr(), a.data_ptr(), partials.data_ptr(),
            gext.data_ptr(), n_pad, kp, k, k1p, nxp, int(first),
            float(hdx), float(hdy), rpc, n_chunks, stream)
    check_launch(rc, "gn_full")
    LAUNCHES += 1
    return gext, cp
