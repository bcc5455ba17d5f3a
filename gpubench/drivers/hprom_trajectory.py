"""Driver of the whole-trajectory HPROM cells: each request is a batch of
mu points, whose whole reduced trajectories run in one call of the port's
rom_factored.traj_hprom_batch (one launch of its trajectory kernel on the
card), with the configuration's Gauss-Newton settings.

The offline model (POD basis and ECSW weights) is an input: the
benchmark's own plain code makes it from the configuration
(reference/offline.py) and caches it in the checkout. The port derives
its sampled mesh and padded blocks from it in set-up; the reference
derives its own.

The check runs the plain reference (reference/hprom.py) over each
sampled batch and compares every point's reduced trajectory (`red_err`).
The Gauss-Newton updates (`gn_gap`) are read beside it; the traffic file
limits only what a control can fail.
"""

from __future__ import annotations

import math
import time

import torch

from gpubench.reference import burgers, hprom, offline

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _model(ctx):
    """The offline model, built or loaded; its seconds go to
    `ctx.inputs_s`, not to the program's set-up."""
    t0 = time.perf_counter()
    d = offline.cache_dir(ctx.bench.cache_root, ctx.cfg["name"],
                          ctx.cfg_path)
    model = offline.load_or_build(ctx.cfg, d, ctx.device)
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()
    ctx.inputs_s += time.perf_counter() - t0
    return model


def setup(ctx, dtype=None):
    from finitedifference_tpu_torch import rom_factored as rf
    from finitedifference_tpu_torch.grid import Grid2D
    from finitedifference_tpu_torch.rom import prepare_hprom

    cfg = ctx.cfg
    dtype = dtype or DTYPES[cfg["state_dtype"]]
    basis, weights = _model(ctx)
    ctx.model = (basis, weights)
    x0, x1, y0, y1 = cfg["domain"]
    n = cfg["num_cells"]
    grid = Grid2D(nx=n, ny=n, x_low=x0, x_up=x1, y_low=y0, y_up=y1)
    mesh, sw, ba = prepare_hprom(grid, weights, basis)
    blocks = rf.precompute_factored_blocks(mesh, ba.to(dtype))
    p6p, wgt_p = rf.precompute_pallas_system(blocks, sw.to(dtype),
                                             dtype=dtype)
    w0 = torch.full((grid.state_dim,), cfg["w0"], dtype=dtype,
                    device=basis.device)
    gn = cfg["gauss_newton"]
    state = dict(cfg=cfg, grid=grid, mesh=mesh, p6p=p6p, wgt_p=wgt_p,
                 y0=basis.to(dtype).T @ w0, entry=rf.traj_hprom_batch,
                 kwargs=dict(unroll_its=gn["unroll_its"],
                             solve_iters=gn["solve_iters"],
                             relnorm_cutoff=gn["relnorm_cutoff"],
                             min_delta=gn["min_delta"]),
                 dtype=dtype)
    # the library builds or loads, and the batch's shape runs once
    from gpubench import traffic

    serve(state, next(traffic.requests(cfg, ctx.traffic, 0)))
    return state


def serve(state, request):
    """One batch of whole trajectories; returns (record, (red, its))."""
    cfg = state["cfg"]
    red, its = state["entry"](state["grid"], state["mesh"], state["p6p"],
                              state["wgt_p"], state["y0"], cfg["dt"],
                              cfg["num_steps"], request, **state["kwargs"])
    total, n_its = torch.stack((red.sum(dtype=torch.float64),
                                its.sum().to(torch.float64))).tolist()
    rec = {"rom_point_steps": len(request) * cfg["num_steps"],
           "points": len(request), "steps": cfg["num_steps"],
           "gn_its": int(n_its), "failed": not math.isfinite(total)}
    return rec, (red, its)


def release(state):
    gn = state["cfg"]["gauss_newton"]
    return {"weighted_cells": int(torch.count_nonzero(state["wgt_p"])),
            "modes": int(state["y0"].shape[0]),
            "dtype": str(state["dtype"]).replace("torch.", ""),
            "unroll_its": gn["unroll_its"], "solve_iters": gn["solve_iters"]}


def compare(ctx, request, rec, answer, dtype=torch.float64):
    """{red_err, gn_gap} of one batch against the reference in `dtype`:
    the largest relative 2-norm error of a point's reduced trajectory,
    and sum |its - its_ref| / sum its_ref."""
    red, its = answer
    cfg = ctx.cfg
    gn = cfg["gauss_newton"]
    basis, weights = ctx.model
    prob = burgers.problem_from_config(cfg)
    want, want_its = hprom.hprom_trajectories(
        prob, basis, weights, request, cfg["num_steps"],
        unroll_its=gn["unroll_its"], solve_iters=gn["solve_iters"],
        cutoff=gn["relnorm_cutoff"], min_delta=gn["min_delta"], dtype=dtype)
    want = want.to(torch.float64)
    diff = torch.linalg.vector_norm((red.to(torch.float64) - want)
                                    .flatten(1), dim=1)
    err = float((diff / torch.linalg.vector_norm(want.flatten(1),
                                                 dim=1)).max())
    its = its.to(want_its.device)
    gap = float((its - want_its).abs().sum()) / float(want_its.sum())
    return {"red_err": err, "gn_gap": gap}


def check(ctx, kept):
    """The worst reading of each number that the traffic file limits."""
    readings = [compare(ctx, *k) for k in kept]
    return [(name, max(r[name] for r in readings), float(lim))
            for name, lim in ctx.traffic["limits"].items()]


def serve_control(ctx, state, request, kind):
    """A control in the program's place: `program_f32` is the program on
    float32 blocks (its own float32 path), `reference_f32` the plain
    reference in float32."""
    if kind == "program_f32":
        if "f32" not in state:
            p6p, wgt_p = (x.to(torch.float32) for x in (state["p6p"],
                                                       state["wgt_p"]))
            state["f32"] = (p6p, wgt_p, state["y0"].to(torch.float32))
        p6p, wgt_p, y0 = state["f32"]
        cfg = state["cfg"]
        red, its = state["entry"](state["grid"], state["mesh"], p6p, wgt_p,
                                  y0, cfg["dt"], cfg["num_steps"], request,
                                  **state["kwargs"])
        return {}, (red, its)
    if kind == "reference_f32":
        cfg = ctx.cfg
        gn = cfg["gauss_newton"]
        basis, weights = ctx.model
        red, its = hprom.hprom_trajectories(
            burgers.problem_from_config(cfg), basis, weights, request,
            cfg["num_steps"], unroll_its=gn["unroll_its"],
            solve_iters=gn["solve_iters"], cutoff=gn["relnorm_cutoff"],
            min_delta=gn["min_delta"], dtype=torch.float32)
        return {}, (red, its)
    raise ValueError(f"unknown control {kind!r}")
