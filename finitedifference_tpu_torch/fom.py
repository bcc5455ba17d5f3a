"""Full-order model (HDM) time steppers (PyTorch).

Counterpart of finitedifference_tpu/fom.py: the implicit Crank-Nicolson
trajectory with a Newton solve per step (reference stopping rule:
relative residual < 1e-12, at most 100 iterations), whose linear solve
is the exact wavefront forward substitution (ops/wavefront.py,
ops/skewed.py), and the explicit forward-Euler stepper.

The time and Newton loops are Python loops. Each Newton iteration reads
one boolean back from the device to decide whether to stop. The device
of the initial state decides where everything runs (an initial state
that is not a tensor goes to the CUDA device, device.py): on the CPU the
linear solve is the plain diagonal loop, on a CUDA device it is the
hand-written wavefront kernel (ops/cuda_wavefront.py) and, in the skewed
engine, the residual and its norm are one hand-written kernel
(ops/cuda_skewed.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops import skewed as sk
from finitedifference_tpu_torch.ops.stencil import (
    burgers_residual_flat,
    ddx_upwind,
    ddy_upwind,
    inflow_bc_term,
    source_term,
)
from finitedifference_tpu_torch.ops.wavefront import (
    solve_jacobian_flat,
    solve_jacobian_sweeps,
)
from finitedifference_tpu_torch.utils import profiling


class NewtonResult(NamedTuple):
    w: torch.Tensor           # solution state (2n,)
    num_its: int              # Newton iterations taken
    resnorm: torch.Tensor     # final residual norm
    init_norm: torch.Tensor   # residual norm at the initial guess


def _default_cutoff(dtype) -> float:
    # 1e-12 is the reference value; it is unreachable in f32, where it
    # would burn max_its every step
    return 1e-12 if dtype == torch.float64 else 1e-6


def newton_step(wp, mu1, mu2, dt, grid: Grid2D, *,
                max_its: int = 100, relnorm_cutoff: float | None = None,
                linear_solver: str = "wavefront",
                num_sweeps: int | None = None) -> NewtonResult:
    """One implicit CN step: solve r(w; wp) = 0 by Newton-Raphson.

    Stopping logic mirrors the reference newton_raphson: check
    ||r||/||r(x0)|| < cutoff *before* each update and break without
    updating once converged; also stop, without updating, once the
    residual stagnates (it > 0 and rn > 0.99 * previous rn). The default
    cutoff is dtype-aware: 1e-12 in f64, 1e-6 in f32. num_its counts the
    iterations that updated w.
    """
    if linear_solver not in ("wavefront", "sweeps"):
        raise ValueError(f"unknown linear_solver: {linear_solver}")
    if relnorm_cutoff is None:
        relnorm_cutoff = _default_cutoff(wp.dtype)
    src = source_term(grid, mu2, dt, dtype=wp.dtype, device=wp.device)
    lbc = inflow_bc_term(grid, mu1, dt, dtype=wp.dtype, device=wp.device)

    def res(w):
        return burgers_residual_flat(w, wp, mu1, mu2, dt, grid, src, lbc)

    def solve(w, f):
        if linear_solver == "wavefront":
            return solve_jacobian_flat(w, f, dt, grid)
        u, v = grid.split_fields(w)
        fu, fv = grid.split_fields(f)
        du, dv = solve_jacobian_sweeps(u, v, fu, fv, dt, grid,
                                       num_sweeps=num_sweeps)
        return grid.merge_fields(du, dv)

    init_norm = torch.linalg.vector_norm(res(wp))
    w, it, done, rn, prev_rn = wp, 0, False, init_norm, None
    while not done and it < max_its:
        f = res(w)
        rn = torch.linalg.vector_norm(f)
        stop = rn / init_norm < relnorm_cutoff
        if it > 0:
            # stagnation escape: once Newton hits its roundoff floor the
            # residual stops improving; stop instead of burning max_its
            stop = stop | (rn > 0.99 * prev_rn)
        done = bool(stop)
        if not done:
            w = w - solve(w, f)
        it += 1
        prev_rn = rn
    # `it` counts loop entries; the converged entry does not update w
    return NewtonResult(w=w, num_its=it - int(done), resnorm=rn,
                        init_norm=init_norm)


class FOMResult(NamedTuple):
    snaps: torch.Tensor          # (2n, num_steps+1), columns = time
    total_newton_its: int
    # worst final relative residual over all steps (rn/||r(x0)||): above
    # the Newton cutoff means some step exited on stagnation or max_its
    # without converging
    max_final_relnorm: torch.Tensor | None = None


def inviscid_burgers_implicit2d(grid: Grid2D, w0, dt, num_steps, mu1, mu2,
                                *, max_its: int = 100,
                                relnorm_cutoff: float | None = None,
                                linear_solver: str = "wavefront",
                                num_sweeps: int | None = None,
                                snaps_dtype=None) -> FOMResult:
    """Implicit FOM trajectory: `num_steps` CN steps from w0.

    Returns all num_steps+1 snapshots, column-major in time, the
    reference's layout. `snaps_dtype` stores the trajectory in a narrower
    dtype (e.g. f32) while solving in w0's dtype.
    """
    w0 = as_tensor(w0)
    snaps = torch.empty((num_steps + 1, w0.numel()),
                        dtype=snaps_dtype or w0.dtype, device=w0.device)
    snaps[0] = w0
    wp, total_its = w0, 0
    worst = torch.zeros((), dtype=w0.dtype, device=w0.device)
    for i in range(num_steps):
        out = newton_step(wp, mu1, mu2, dt, grid, max_its=max_its,
                          relnorm_cutoff=relnorm_cutoff,
                          linear_solver=linear_solver,
                          num_sweeps=num_sweeps)
        worst = torch.maximum(worst, out.resnorm / out.init_norm)
        total_its += out.num_its
        wp = out.w
        snaps[i + 1] = wp
    return FOMResult(snaps=snaps.T, total_newton_its=total_its,
                     max_final_relnorm=worst)


def inviscid_burgers_implicit2d_skewed(
        grid: Grid2D, w0, dt, num_steps, mu1, mu2, *,
        max_its: int = 100, relnorm_cutoff: float | None = None,
        solve_dtype=None, snaps_dtype=None, block: int = 128,
        extrapolate_guess: bool = False, seg: int = 0,
        seg_overlap: int = 64) -> FOMResult:
    """Fast implicit FOM: the whole integration in skewed coordinates.

    The triangular solve consumes the skewed state directly, with no
    per-iteration skew gathers. On a CUDA device every Newton iteration
    launches the wavefront kernel once and the residual kernel
    (ops/cuda_skewed: the update, the residual, its norm and the stop
    test) once, and every step the residual kernel's step constant once;
    on the CPU it runs the plain diagonal loop and the plain expressions.

    `solve_dtype` is the dtype of the linear solves; None means the
    state's dtype, on every device. `solve_dtype=torch.float32` with an
    f64 state gives mixed-precision inexact Newton: f64 residuals and
    updates, f32 solves. That is the configuration the JAX package
    benchmarks: its Pallas path always solves in f32 and ignores
    solve_dtype. `block` only sets the padding of the diagonal axis.

    `seg > 0` solves with the overlapping-segment approximation instead
    (ops/skewed.solve_skewed_seg: `seg` segments, each warmed up over
    `seg_overlap` diagonals; on a CUDA device one kernel launch per
    Newton iteration, one CTA per segment). Its truncation error
    ~rho^seg_overlap makes Newton inexact; the stopping rules absorb it.

    Semantics match inviscid_burgers_implicit2d (same stopping rules);
    returns unskewed snapshots.

    extrapolate_guess=True starts Newton from the linear predictor
    2 w_n - w_{n-1}, masked to the band, instead of the reference's w_n.
    The converged solution is unchanged (init_norm and the cutoff stay
    defined at the step-start state), but the predictor's O(dt^2) initial
    residual saves about one Newton iteration per step.

    While a recording is on (utils/profiling) the call is the span
    `fom.trajectory`, each step's constant `fom.step_constant`, each
    update's `fom.solve`, `fom.residual` (the update, the residual, its
    norm and the stop test) and `fom.sync` (the stop decision's
    read-back, counted in `fom.host_syncs`). On a CUDA device
    ops/skewed.skewed_update_residual counts the residual kernel's
    launches for the updates (and for the extrapolated guesses) in
    `fom.fused_residuals`.
    """
    with profiling.span("fom.trajectory"):
        w0 = as_tensor(w0)
        dtype, device = w0.dtype, w0.device
        if relnorm_cutoff is None:
            relnorm_cutoff = _default_cutoff(dtype)
        sd = snaps_dtype or dtype

        lay = sk.make_layout(grid, block=block)
        valid = sk.valid_mask(lay, dtype, device)
        src_sk = sk.skewed_source(lay, grid, mu2, dt, dtype, device)
        lbc_sk = sk.skewed_inflow_bc(lay, grid, mu1, dt, dtype, device)

        u0, v0 = grid.split_fields(w0)
        su0 = sk.to_skewed(u0, lay)
        sv0 = sk.to_skewed(v0, lay)

        def solve(u, v, ru, rv):
            sdt = solve_dtype or dtype
            args = (u.to(sdt), v.to(sdt), ru.to(sdt), rv.to(sdt), dt, grid,
                    lay)
            if seg > 0:
                du, dv = sk.solve_skewed_seg(*args, n_seg=seg,
                                             overlap=seg_overlap)
            else:
                du, dv = sk.solve_skewed(*args)
            return du.to(dtype), dv.to(dtype)

        def read_back(stop):
            # the loop's only host sync
            with profiling.span("fom.sync"):
                profiling.count("fom.host_syncs")
                return bool(stop)

        # on a CUDA device each step constant and each update is one launch
        # of the residual kernel, which also takes the norm and the stop test
        ws = sk.residual_workspace(lay, dtype, device)

        def residual(u, v, du, dv, cp_u, cp_v, init_norm, rn_prev):
            return sk.skewed_update_residual(
                u, v, du, dv, cp_u, cp_v, dt, grid, lay, valid,
                init_norm=init_norm, rn_prev=rn_prev, cutoff=relnorm_cutoff,
                workspace=ws)

        def newton(up, vp, ug, vg):
            # one pass computes the step's CN constant cp AND the init
            # residual r0 = r(up, vp); the body solves first, THEN
            # updates the state and evaluates the residual there, so every
            # evaluated state, stopping decision and iteration count is
            # the reference's
            with profiling.span("fom.step_constant"):
                cp_u, cp_v, r0u, r0v, init_norm = \
                    sk.skewed_step_constant_norm(up, vp, dt, grid, lay,
                                                 src_sk, lbc_sk, valid,
                                                 workspace=ws)
            if extrapolate_guess:
                _, _, ru, rv, rn, stop = residual(ug, vg, None, None, cp_u,
                                                  cp_v, init_norm, None)
                done = read_back(stop)
            else:
                ru, rv, rn = r0u, r0v, init_norm
                done = False   # rn/init == 1 is never < cutoff
            u, v, it = ug, vg, 0
            while not done and it < max_its:
                with profiling.span("fom.solve"):
                    du, dv = solve(u, v, ru, rv)
                with profiling.span("fom.residual"):
                    u, v, ru, rv, rn, stop = residual(u, v, du, dv, cp_u,
                                                      cp_v, init_norm, rn)
                done = read_back(stop)
                it += 1
            return u, v, it, rn / init_norm

        us = torch.empty((num_steps + 1, lay.nd_pad, lay.ny_pad),
                         dtype=sd, device=device)
        vs = torch.empty_like(us)
        us[0], vs[0] = su0, sv0
        up, vp, um, vm = su0, sv0, su0, sv0
        total_its = 0
        worst = torch.zeros((), dtype=dtype, device=device)
        for i in range(num_steps):
            if extrapolate_guess:
                ug = valid * (2.0 * up - um)
                vg = valid * (2.0 * vp - vm)
            else:
                ug, vg = up, vp
            u, v, nits, rel = newton(up, vp, ug, vg)
            total_its += nits
            worst = torch.maximum(worst, rel)
            um, vm, up, vp = up, vp, u, v
            us[i + 1], vs[i + 1] = u, v

        # unskew the whole trajectory in one gather
        u_t = sk.from_skewed(us, lay).reshape(num_steps + 1, -1)
        v_t = sk.from_skewed(vs, lay).reshape(num_steps + 1, -1)
        snaps = torch.cat((u_t, v_t), dim=1).T
        return FOMResult(snaps=snaps, total_newton_its=total_its,
                         max_final_relnorm=worst)


def inviscid_burgers_explicit2d(grid: Grid2D, w0, dt, num_steps, mu1, mu2):
    """Forward-Euler explicit stepper; the full trajectory
    (2n, num_steps+1)."""
    w0 = as_tensor(w0)
    # built with dt=1 so they are the *rates*; scaled by dt below
    src = source_term(grid, mu2, 1.0, dtype=w0.dtype, device=w0.device)
    lbc = inflow_bc_term(grid, mu1, 1.0, dtype=w0.dtype, device=w0.device)

    traj = torch.empty((num_steps + 1, w0.numel()), dtype=w0.dtype,
                       device=w0.device)
    traj[0] = w0
    wp = w0
    for i in range(num_steps):
        up, vp = grid.split_fields(wp)
        fu = 0.5 * up * up
        fv = 0.5 * vp * vp
        fuv = 0.5 * up * vp
        u = up - dt * (ddx_upwind(fu, grid.dx) - lbc) + dt * src \
            - dt * ddy_upwind(fuv, grid.dy)
        v = vp - dt * ddy_upwind(fv, grid.dy) \
            - dt * ddx_upwind(fuv, grid.dx)
        wp = grid.merge_fields(u, v)
        traj[i + 1] = wp
    return traj.T
