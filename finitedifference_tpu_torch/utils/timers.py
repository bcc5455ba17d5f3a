"""Phase timing: the reference's (jac_time, res_time, ls_time) contract
(PyTorch).

Counterpart of finitedifference_tpu/utils/timers.py. The reference
threads wall-clock accumulators through every Gauss-Newton solver
(hypernet2D.py:1879-1929). Here the same per-phase numbers come from
timing the three phase operations standalone (`phase_breakdown`),
without instrumenting the hot path: CUDA events on the card,
`time.perf_counter` on the CPU.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from finitedifference_tpu_torch.device import as_tensor


class Timer:
    """Context-manager wall timer. `sync(result)` registers a tensor: at
    exit the timer waits for the tensor's device (torch.cuda.synchronize
    on the card), so queued kernels count."""

    def __init__(self):
        self.elapsed = 0.0
        self._result = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sync(self, result):
        self._result = result
        return result

    def __exit__(self, *exc):
        r = self._result
        if isinstance(r, torch.Tensor) and r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
        self.elapsed = time.perf_counter() - self._t0
        return False


def _time_fn(fn: Callable, args, reps: int, device: torch.device) -> float:
    """Seconds per call of fn(*args), after one untimed call."""
    fn(*args)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps


def phase_breakdown(grid, basis, w, wp, mu1, mu2, dt, *,
                    weights=None, reps: int = 20) -> Dict[str, float]:
    """Per-GN-iteration phase times {res, jac(J@V), ls} in seconds.

    Mirrors the reference's per-phase printouts (e.g. run_HRNM_ecm.py:246)
    by timing each phase standalone on the basis's device (the CUDA
    device for an array that is not a tensor): the full-grid residual,
    the J@V stencil product and the QR least-squares solve (weighted by
    `weights` when given).
    """
    from finitedifference_tpu_torch.ops.stencil import (
        burgers_residual_flat,
        jacobian_times_basis,
    )
    from finitedifference_tpu_torch.solvers import lstsq_qr

    basis = as_tensor(basis)
    device = basis.device
    w = torch.as_tensor(w, device=device)
    wp = torch.as_tensor(wp, device=device)

    def res_fn(a, b):
        return burgers_residual_flat(a, b, mu1, mu2, dt, grid)

    def jv_fn(a):
        return jacobian_times_basis(a, basis, dt, grid)

    f = res_fn(w, wp)
    jv = jv_fn(w)
    if weights is not None:
        wgt = torch.as_tensor(weights, device=device).to(jv.dtype)

        def ls_fn(a, b):
            return lstsq_qr(wgt[:, None] * a, -wgt * b)
    else:
        def ls_fn(a, b):
            return lstsq_qr(a, -b)

    return {
        "res_time": _time_fn(res_fn, (w, wp), reps, device),
        "jac_time": _time_fn(jv_fn, (w,), reps, device),
        "ls_time": _time_fn(ls_fn, (jv, f), reps, device),
    }
