"""Driver of the full-grid LSPG PROM cells: each request is one trajectory
of `num_steps` steps at one mu point through the port's
rom_factored.pallas_prom (the full-grid system kernel on the card, one
launch a Gauss-Newton system), with the configuration's Gauss-Newton
settings. With `unroll_its` > 0 the trajectory reads the device back once,
at its end; only the reduced coordinates' sum is read besides.

The POD basis is an input: the benchmark's own plain code makes it from
the configuration (reference/pod_offline.py) and caches it in the
checkout. The port pads it in set-up.

The check runs the plain reference (reference/prom.py: the source's
Gauss-Newton LSPG, lstsq and no masking) in float64 at the sampled mu and
compares the reduced trajectory (`red_err`) and the Gauss-Newton updates
(`gn_gap`).
"""

from __future__ import annotations

import math
import time

import torch

from gpubench.reference import burgers, offline, pod_offline, prom

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _basis(ctx):
    """The POD basis (2n, k) float64, built or loaded; its seconds go to
    `ctx.inputs_s`, not to the program's set-up."""
    t0 = time.perf_counter()
    d = offline.cache_dir(ctx.bench.cache_root, ctx.cfg["name"],
                          ctx.cfg_path)
    basis = pod_offline.load_or_build(ctx.cfg, d, ctx.device)
    if torch.device(ctx.device).type == "cuda":
        # the offline build's snapshots leave the allocator's cache
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ctx.inputs_s += time.perf_counter() - t0
    return basis


def _grid(cfg):
    from finitedifference_tpu_torch.grid import Grid2D

    x0, x1, y0, y1 = cfg["domain"]
    n = cfg["num_cells"]
    return Grid2D(nx=n, ny=n, x_low=x0, x_up=x1, y_low=y0, y_up=y1)


def _padded(grid, cfg, basis, dtype):
    """(vu_p, vv_p, dmask, tile_rows, y0) of the program in `dtype`."""
    from finitedifference_tpu_torch.rom_factored import precompute_prom_pallas

    vu_p, vv_p, dmask, tr = precompute_prom_pallas(grid, basis, dtype=dtype)
    w0 = torch.full((basis.shape[0],), cfg["w0"], dtype=basis.dtype,
                    device=basis.device)
    return vu_p, vv_p, dmask, tr, (basis.T @ w0).to(dtype)


def setup(ctx):
    from finitedifference_tpu_torch import rom_factored as rf

    cfg = ctx.cfg
    basis = _basis(ctx)
    ctx.basis, ctx.references = basis, {}
    grid = _grid(cfg)
    gn = cfg["gauss_newton"]
    state = dict(cfg=cfg, grid=grid, entry=rf.pallas_prom,
                 model=_padded(grid, cfg, basis, DTYPES[cfg["state_dtype"]]),
                 kwargs=dict(max_its=gn["max_its"],
                             relnorm_cutoff=gn["relnorm_cutoff"],
                             min_delta=gn["min_delta"],
                             unroll_its=gn["unroll_its"],
                             ls_method=gn["ls_method"]))
    # the library builds or loads, and every call of a step runs once
    mid = [(0.5 * sum(cfg["mu1_range"]), 0.5 * sum(cfg["mu2_range"]))]
    serve(state, mid, num_steps=3)
    return state


def _run(state, request, model, num_steps=None, **kw):
    cfg = state["cfg"]
    steps = cfg["num_steps"] if num_steps is None else num_steps
    (mu1, mu2), = request
    vu_p, vv_p, dmask, tr, y0 = model
    return steps, state["entry"](state["grid"], vu_p, vv_p, dmask, y0,
                                 cfg["dt"], steps, mu1, mu2, tile_rows=tr,
                                 **dict(state["kwargs"], **kw))


def _record(steps, res, unroll_its):
    """The request failed where its sum is not finite, or where a masked
    step took all `unroll_its` updates: its last update went unchecked,
    and the source's rules may have wanted more. A program that does not
    report the most updates a step took (ROMResult.max_step_its) is held
    to the sum alone."""
    total = float(res.red_coords.sum(dtype=torch.float64))
    most = getattr(res, "max_step_its", None)
    capped = unroll_its > 0 and most is not None and most >= unroll_its
    return {"rom_point_steps": steps, "points": 1, "steps": steps,
            "gn_its": int(res.total_gn_its), "gn_systems": res.gn_evals,
            "failed": capped or not math.isfinite(total)}


def serve(state, request, num_steps=None):
    """One trajectory; returns (record, (red, its))."""
    steps, res = _run(state, request, state["model"], num_steps)
    return (_record(steps, res, state["kwargs"]["unroll_its"]),
            (res.red_coords, res.total_gn_its))


def release(state):
    grid, (vu_p, _, _, _, y0) = state["grid"], state["model"]
    return {"nx": grid.nx, "ny": grid.ny, "modes": int(y0.shape[0]),
            "dtype": str(vu_p.dtype).replace("torch.", ""),
            "unroll_its": state["kwargs"]["unroll_its"]}


def _reference(ctx, request, dtype=torch.float64):
    """The reference's (red, its) at the request's mu, computed once per
    request and dtype in this process."""
    memo = ctx.references
    key = (tuple(request[0]), dtype)
    if key not in memo:
        cfg = ctx.cfg
        gn = cfg["gauss_newton"]
        memo[key] = prom.lspg_trajectory(
            burgers.problem_from_config(cfg), ctx.basis, request[0],
            cfg["num_steps"], max_its=gn["max_its"],
            cutoff=gn["relnorm_cutoff"], min_delta=gn["min_delta"],
            w0=cfg["w0"], dtype=dtype)
    return memo[key]


def compare(ctx, request, rec, answer, dtype=torch.float64):
    """{red_err, gn_gap, ref_step_its} of one trajectory against the
    reference in `dtype`: the largest relative 2-norm error of a step's
    reduced coordinates, |its - its_ref| / its_ref over the trajectory,
    and the most updates a step of the reference took (the masked
    program agrees with it while that is below `unroll_its`)."""
    red, its = answer
    want, want_its = _reference(ctx, request, dtype)
    want = want.to(torch.float64)
    diff = torch.linalg.vector_norm(red.to(want.device, torch.float64)
                                    - want, dim=0)
    err = float((diff / torch.linalg.vector_norm(want, dim=0)).max())
    ref_its = int(want_its.sum())
    return {"red_err": err, "gn_gap": abs(int(its) - ref_its) / ref_its,
            "ref_step_its": int(want_its.max())}


def check(ctx, kept):
    """The worst reading of each number that the traffic file limits."""
    readings = [compare(ctx, *k) for k in kept]
    return [(name, max(r[name] for r in readings), float(lim))
            for name, lim in ctx.traffic["limits"].items()]


def serve_control(ctx, state, request, kind):
    """A control in the program's place: `program_bf16_basis` the program
    on the basis rounded through bfloat16 (a lower precision than the
    configuration states), `program_one_update` the program with one
    Gauss-Newton update a step (unroll_its 1), `program_f64` the program
    in float64 (a reading beside the controls), `reference_f32` the plain
    reference in float32."""
    if kind == "reference_f32":
        red, its = _reference(ctx, request, torch.float32)
        return {}, (red, its.sum())
    unroll_its = state["kwargs"]["unroll_its"]
    if kind == "program_one_update":
        unroll_its = 1
        steps, res = _run(state, request, state["model"],
                          unroll_its=unroll_its)
    elif kind in ("program_bf16_basis", "program_f64"):
        if kind not in state:
            basis, dtype = ctx.basis, torch.float64
            if kind == "program_bf16_basis":
                basis = basis.to(torch.bfloat16).to(torch.float64)
                dtype = DTYPES[ctx.cfg["state_dtype"]]
            state[kind] = _padded(state["grid"], ctx.cfg, basis, dtype)
        steps, res = _run(state, request, state[kind])
    else:
        raise ValueError(f"unknown control {kind!r}")
    return (_record(steps, res, unroll_its),
            (res.red_coords, res.total_gn_its))
