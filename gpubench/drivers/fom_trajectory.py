"""Driver of the implicit FOM cells: each request is one trajectory of
`num_steps` Crank-Nicolson steps from w0 at one mu point, through the
port's fom.inviscid_burgers_implicit2d_skewed (the solve of the traffic
file's `solver`: exact, or segmented when `seg` > 0). The snapshots stay
on the device, stored in the configuration's `snaps_dtype`; only their
sum is read back.

The check runs the plain reference (reference/burgers.py) over the
sampled trajectory's mu in float64 and compares every stored snapshot
with it, evaluates the Crank-Nicolson residual of every stored step, and
compares the Newton updates of the whole trajectory.
"""

from __future__ import annotations

import math

import torch

from gpubench.reference import burgers

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _grid(cfg):
    from finitedifference_tpu_torch.grid import Grid2D

    x0, x1, y0, y1 = cfg["domain"]
    n = cfg["num_cells"]
    return Grid2D(nx=n, ny=n, x_low=x0, x_up=x1, y_low=y0, y_up=y1)


def setup(ctx):
    from finitedifference_tpu_torch import fom

    cfg, solver = ctx.cfg, ctx.traffic["solver"]
    grid = _grid(cfg)
    state = dict(
        cfg=cfg, grid=grid, entry=fom.inviscid_burgers_implicit2d_skewed,
        w0=torch.full((grid.state_dim,), cfg["w0"],
                      dtype=DTYPES[cfg["state_dtype"]], device=ctx.device),
        kwargs=dict(max_its=cfg["newton_max_its"],
                    relnorm_cutoff=cfg["newton_cutoff"],
                    snaps_dtype=DTYPES[cfg["snaps_dtype"]],
                    block=solver["diag_block"], seg=solver["seg"],
                    seg_overlap=solver["seg_overlap"]))
    # the library builds or loads, and every kernel of a step runs once
    mid = [(0.5 * sum(cfg["mu1_range"]), 0.5 * sum(cfg["mu2_range"]))]
    serve(state, mid, num_steps=5)
    return state


def serve(state, request, num_steps=None):
    """One trajectory; returns (record, snapshots)."""
    cfg = state["cfg"]
    steps = cfg["num_steps"] if num_steps is None else num_steps
    (mu1, mu2), = request
    res = state["entry"](state["grid"], state["w0"], cfg["dt"], steps, mu1,
                         mu2, **state["kwargs"])
    total = float(res.snaps.sum(dtype=torch.float64))
    rec = {"fom_steps": steps, "newton_its": int(res.total_newton_its),
           "failed": not math.isfinite(total)}
    return rec, res.snaps


def release(state):
    return {"nx": state["grid"].nx, "ny": state["grid"].ny,
            "state_dtype": state["cfg"]["state_dtype"]}


def step_residual(prob, request, snaps):
    """The largest relative Crank-Nicolson residual of a step of the
    stored trajectory, ||r(w_i; w_i-1)|| / ||r(w_i-1; w_i-1)||, evaluated
    by the reference in float64: how far each stored step is from the
    step that the Newton cutoff defines."""
    n, f64 = prob.n_cells, torch.float64
    force = burgers.forcing(prob, request, f64, snaps.device)

    def norm(u, v, up, vp):
        ru, rv = burgers.residual(u, v, up, vp, force, prob)
        return torch.sqrt((ru * ru).sum() + (rv * rv).sum())

    worst = torch.zeros((), dtype=f64, device=snaps.device)
    prev = None
    for i in range(snaps.shape[1]):
        w = snaps[:, i].to(f64)
        cur = (w[:n].reshape(1, prob.ny, prob.nx),
               w[n:].reshape(1, prob.ny, prob.nx))
        if prev is not None:
            worst = torch.maximum(worst, norm(*cur, *prev)
                                  / norm(*prev, *prev))
        prev = cur
    return float(worst)


def compare(ctx, request, rec, snaps, dtype=torch.float64):
    """{state_err, step_res, newton_gap} of one trajectory against the
    reference in `dtype`: the largest relative 2-norm error of a stored
    snapshot, the largest relative residual of a stored step
    (`step_residual`), and |its - its_ref| / its_ref."""
    cfg, solver = ctx.cfg, ctx.traffic["solver"]
    prob = burgers.problem_from_config(cfg)
    n = prob.n_cells
    worst = [0.0]

    def on_step(i, u, v):
        want = torch.cat((u.reshape(-1), v.reshape(-1))).to(torch.float64)
        got = snaps[:, i].to(torch.float64)
        err = torch.linalg.vector_norm(got - want) \
            / torch.linalg.vector_norm(want)
        worst[0] = max(worst[0], float(err))
        assert got.shape[0] == 2 * n

    its, = burgers.newton_trajectory(
        prob, request, cfg["num_steps"], dtype=dtype, device=snaps.device,
        cutoff=cfg["newton_cutoff"], max_its=cfg["newton_max_its"],
        n_seg=solver["seg"], overlap=solver["seg_overlap"],
        diag_block=solver["diag_block"], on_step=on_step)
    return {"state_err": worst[0],
            "step_res": step_residual(prob, request, snaps),
            "newton_gap": abs(rec["newton_its"] - its) / its}


def check(ctx, kept):
    """The worst reading of each number that the traffic file limits."""
    readings = [compare(ctx, *k) for k in kept]
    return [(name, max(r[name] for r in readings), float(lim))
            for name, lim in ctx.traffic["limits"].items()]


def serve_control(ctx, state, request, kind):
    """A control in the program's place: `program_f32` is the program on
    its float32 path (a float32 state, so float32 residuals and solves);
    `program_f32_solves` the program with only its float32 solves switched
    on under the float64 state (a reading beside the controls, PERF.md);
    `reference_f32` the plain reference in float32, its snapshots stored
    as the program stores them."""
    cfg = state["cfg"]
    if kind in ("program_f32", "program_f32_solves"):
        kw = dict(state["kwargs"], solve_dtype=torch.float32)
        w0 = state["w0"]
        if kind == "program_f32":
            w0 = w0.to(torch.float32)
        res = state["entry"](state["grid"], w0, cfg["dt"], cfg["num_steps"],
                             *request[0], **kw)
        return {"newton_its": int(res.total_newton_its)}, res.snaps
    if kind == "reference_f32":
        prob = burgers.problem_from_config(cfg)
        solver = state["kwargs"]
        snaps = torch.empty((2 * prob.n_cells, cfg["num_steps"] + 1),
                            dtype=DTYPES[cfg["snaps_dtype"]],
                            device=state["w0"].device)

        def keep(i, u, v):
            snaps[:, i] = torch.cat((u.reshape(-1), v.reshape(-1)))

        its, = burgers.newton_trajectory(
            prob, request, cfg["num_steps"], dtype=torch.float32,
            device=snaps.device, cutoff=cfg["newton_cutoff"],
            max_its=cfg["newton_max_its"], n_seg=solver["seg"],
            overlap=solver["seg_overlap"], diag_block=solver["block"],
            on_step=keep)
        return {"newton_its": its}, snaps
    raise ValueError(f"unknown control {kind!r}")
