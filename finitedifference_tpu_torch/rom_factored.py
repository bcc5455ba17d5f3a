"""Factored-block ECSW HPROM and the kernel engines (PyTorch).

Counterpart of finitedifference_tpu/rom_factored.py. The upwind stencil
at a sampled cell touches three positions (self, west, south) of u and
v, so the online Gauss-Newton iteration factors through SIX precomputed
basis blocks B_p (n_s, k):

    scalars   u_s, u_w, u_so, v_s, v_w, v_so = (stacked B) @ y
    residual  r(y) = elementwise in the 6 scalars + a per-step constant
    J V       = sum_p diag(c_p(scalars)) B_p
    Gram, rhs, |r|^2 = [W J V | W r]^T [W J V | W r]

The per-step constant (the previous state's half of the Crank-Nicolson
flux) is elementwise in the previous step's scalars.

Engines, each with the stopping rules of rom.ecsw_hprom / rom.lspg_prom
(reference gauss_newton_ECSW_2D / gauss_newton_LSPG):
- factored_hprom: the factored system in plain tensor ops;
- pallas_hprom:   the system as ONE kernel call per Gauss-Newton
                  iteration (ops/gn.py: csrc/gn_sampled.cu on a CUDA
                  device), with ls_method "normal", "cg" or "fused"
                  (the CG folded into the kernel call);
- pallas_prom:    the FULL-grid LSPG PROM with the streaming system
                  (ops/gn_full.py: csrc/gn_full.cu on a CUDA device);
- pallas_traj_hprom: the whole HPROM trajectory, every step and
                  iteration, in ONE kernel launch (ops/gn.trajectory_hprom:
                  csrc/gn_traj.cu on a CUDA device), batched over μ by
                  parallel/sweep.sweep_hprom.
The names keep the JAX package's. The dynamic Gauss-Newton loop reads
one boolean back per iteration; `unroll_its > 0` runs that many masked
iterations per step instead, with no read-back until the end of the
trajectory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.gn import (
    gn_step,
    gn_system,
    pad_factored_inputs,
    sampled_workspace,
    trajectory_hprom,
)
from finitedifference_tpu_torch.ops.gn_full import (
    _round_up,
    gn_full_first,
    gn_full_system,
    pad_basis_full,
    row_mask,
)
from finitedifference_tpu_torch.ops.sampled import (
    SampledMesh,
    sampled_inflow_bc,
    sampled_source,
)
from finitedifference_tpu_torch.ops.stencil import inflow_bc_term, source_term
from finitedifference_tpu_torch.rom import ROMResult
from finitedifference_tpu_torch.solvers import cg_normal
from finitedifference_tpu_torch.utils import profiling

CG_ITERS = 24


class FactoredBlocks(NamedTuple):
    """Precomputed stencil-position basis blocks.

    p6: (6, n_s, k): V rows at [u_self, u_west, u_south, v_self, v_west,
        v_south]; west/south rows are zero where the sample sits on the
        domain boundary (the zero-ghost stencil).
    """
    p6: torch.Tensor


def precompute_factored_blocks(mesh: SampledMesh,
                               basis_aug) -> FactoredBlocks:
    """Gather the six (n_s, k) stencil-position blocks once per mesh."""
    basis_aug = as_tensor(basis_aug)
    n_z = mesh.n_aug
    bu, bv = basis_aug[:n_z, :], basis_aug[n_z:, :]

    def blocks(b):
        b_west = torch.where(mesh.has_west[:, None], b[mesh.pos_west, :],
                             0.0)
        b_south = torch.where(mesh.has_south[:, None],
                              b[mesh.pos_south, :], 0.0)
        return b[mesh.pos_self, :], b_west, b_south

    return FactoredBlocks(p6=torch.stack(blocks(bu) + blocks(bv)))


def _cholesky_solve(g, b):
    """g x = b by Cholesky, without a host sync (a non-SPD g gives
    non-finite x instead of raising, as the JAX package's cho_solve)."""
    chol, _ = torch.linalg.cholesky_ex(g)
    return torch.cholesky_solve(b[:, None], chol)[:, 0]


def _reduced_solver(ls_method: str):
    if ls_method == "normal":
        return _cholesky_solve
    if ls_method in ("cg", "fused"):
        return lambda g, b: cg_normal(g, b, CG_ITERS)
    raise ValueError(f"unknown ls_method {ls_method!r}; use 'normal', "
                     f"'cg' or 'fused'")


def _gauss_newton(y, init_norm, system, *, it0, unrolled, n_iters,
                  max_its, relnorm_cutoff, min_delta):
    """Gauss-Newton iterations of one time step from y.

    system(y) -> (dy, rn): the update and the residual norm at y. The
    stopping check comes before the update (the reference's break):
    rn / init_norm < relnorm_cutoff, or, once `it` > 0, the stagnation
    |rn_prev - rn| / rn_prev < min_delta. `it` starts at it0 and counts
    the updates.

    unrolled: exactly n_iters evaluations; those past the stop leave y
    frozen; no read-back (it is returned as a 0-dim tensor). Else: a
    Python loop until the stop or max_its, one read-back per evaluation.
    Returns (y, it, evaluations).

    While a recording is on (utils/profiling) the stop test and the
    update of each evaluation are the span `rom.gn_update`, and in the
    Python loop each read-back is the span `rom.gn_sync` and one
    `rom.gn_host_syncs`.
    """
    if unrolled:
        it = torch.full((), it0, dtype=torch.int64, device=y.device)
        done = torch.zeros((), dtype=torch.bool, device=y.device)
        rn_prev = init_norm
        for _ in range(n_iters):
            dy, rn = system(y)
            with profiling.span("rom.gn_update"):
                conv = rn / init_norm < relnorm_cutoff
                stag = (it > 0) & (torch.abs(rn_prev - rn) / rn_prev
                                   < min_delta)
                stop = conv | stag | done
                y = torch.where(stop, y, (y.to(dy.dtype) + dy).to(y.dtype))
                it = it + (~stop).to(it.dtype)
                rn_prev = torch.where(done, rn_prev, rn)
                done = stop
        return y, it, n_iters
    it, done, rn_prev, evals = it0, False, init_norm, 0
    while not done and it < max_its:
        dy, rn = system(y)
        evals += 1
        with profiling.span("rom.gn_update"):
            stop = rn / init_norm < relnorm_cutoff
            if it > 0:
                stop = stop | (torch.abs(rn_prev - rn) / rn_prev
                               < min_delta)
            with profiling.span("rom.gn_sync"):
                profiling.count("rom.gn_host_syncs")
                done = bool(stop)
            if not done:
                y = (y.to(dy.dtype) + dy).to(y.dtype)
                it += 1
            rn_prev = rn
    return y, it, evals


class _HalfFlux:
    """The factored residual pieces at the sampled cells."""

    def __init__(self, hdx, hdy, src_lbc):
        self.qdx, self.qdy = 0.5 * hdx, 0.5 * hdy
        self.src_lbc = src_lbc

    def half_flux(self, s):
        """Half the CN flux terms (the current OR previous half of
        0.5 (f(w) + f(wp))), elementwise in the 6 scalars."""
        u_s, u_w, u_so, v_s, v_w, v_so = s
        fuv_s = u_s * v_s
        ru = self.qdx * (u_s * u_s - u_w * u_w) \
            + self.qdy * (fuv_s - u_so * v_so)
        rv = self.qdy * (v_s * v_s - v_so * v_so) \
            + self.qdx * (fuv_s - u_w * v_w)
        return ru, rv

    def step_const(self, sp):
        """-u_p + (previous half of the flux) - src - lbc, and -v_p + ..."""
        ru_f, rv_f = self.half_flux(sp)
        return -sp[0] + ru_f - self.src_lbc, -sp[3] + rv_f

    def residual(self, s, cp_u, cp_v):
        ru_f, rv_f = self.half_flux(s)
        return s[0] + ru_f + cp_u, s[3] + rv_f + cp_v


def _time_loop(y0, num_steps, step, scalars=None):
    """Shared trajectory loop: step(yp, sp) -> (y, its, evals), where sp
    = scalars(yp) when the engine carries the previous step's scalars.
    ROMResult.max_step_its is the most updates any one step took: with
    unroll_its > 0, a step at unroll_its took its last update unchecked."""
    def carried(y):
        return None if scalars is None else scalars(y)

    ys = torch.empty((num_steps + 1, y0.shape[0]), dtype=y0.dtype,
                     device=y0.device)
    ys[0] = y0
    yp, sp, step_its, evals = y0, carried(y0), [], 0
    for i in range(num_steps):
        y, it, ev = step(yp, sp)
        ys[i + 1] = y
        step_its.append(it)
        evals += ev
        yp, sp = y, carried(y)
    if step_its and torch.is_tensor(step_its[0]):
        # the masked loop's counts stay on the device until here: one
        # read-back of the sum and the largest
        per_step = torch.stack(step_its)
        its, most = torch.stack([per_step.sum(), per_step.max()]).tolist()
    else:
        its, most = sum(step_its), max(step_its, default=0)
    return ROMResult(red_coords=ys.T, total_gn_its=int(its),
                     gn_evals=evals, max_step_its=int(most))


def factored_hprom(grid: Grid2D, mesh, sample_weights, y0,
                   blocks: FactoredBlocks, dt, num_steps, mu1, mu2, *,
                   max_its: int = 20, relnorm_cutoff: float = 1e-5,
                   min_delta: float = 0.1, unroll_its: int = 0,
                   ls_method: str = "normal", group=None) -> ROMResult:
    """HPROM time loop on the factored stencil blocks, in plain tensor
    ops, in y0's dtype.

    unroll_its > 0 runs that many masked Gauss-Newton iterations per
    step; iterations past the stopping rules freeze y, so the trajectory
    is the dynamic loop's whenever it would have stopped within the
    budget.

    group: the counterpart of the JAX package's `axis_name`. A process
    group (parallel/mesh.Mesh.group) over whose ranks the sampled cells
    are sharded: every Gram extension and the square of every initial
    norm is summed over the ranks (parallel/mesh.group_psum, the same bits
    on every rank), y stays the same on every rank and each rank solves
    the small reduced system itself. See
    parallel/sweep.sharded_factored_hprom.
    """
    y0 = as_tensor(y0)
    dtype, device = y0.dtype, y0.device
    p6 = blocks.p6.to(dtype=dtype, device=device)
    _, n_s, k = p6.shape
    p_flat = p6.reshape(6 * n_s, k)
    hdx = 0.5 * dt / grid.dx
    hdy = 0.5 * dt / grid.dy
    qdx, qdy = 0.5 * hdx, 0.5 * hdy
    src_lbc = sampled_source(mesh, grid, mu2, dt, dtype) \
        + sampled_inflow_bc(mesh, grid, mu1, dt, dtype)
    fl = _HalfFlux(hdx, hdy, src_lbc)
    wgt = torch.as_tensor(sample_weights, device=device).to(dtype)
    if ls_method == "fused":
        raise ValueError("ls_method='fused' needs the kernel engine "
                         "(pallas_hprom)")
    solve_ls = _reduced_solver(ls_method)
    if group is None:
        def psum(x):
            return x
    else:
        # imported here: parallel/ imports this module
        from finitedifference_tpu_torch.parallel.mesh import group_psum

        def psum(x):
            return group_psum(x, group)

    def scalars(y):
        return (p_flat @ y).reshape(6, n_s)

    def gn_system_plain(s, ru, rv):
        """Weighted [J V | r] and its Gram extension."""
        u_s, u_w, u_so, v_s, v_w, v_so = s
        zero = torch.zeros_like(u_s)
        cu = torch.stack([1.0 + hdx * u_s + qdy * v_s, -hdx * u_w,
                          -qdy * v_so, qdy * u_s, zero, -qdy * u_so])
        cv = torch.stack([qdx * v_s, -qdx * v_w, zero,
                          1.0 + hdy * v_s + qdx * u_s, -qdx * u_w,
                          -hdy * v_so])
        ju = torch.einsum("pn,pnk->nk", cu * wgt, p6)
        jv = torch.einsum("pn,pnk->nk", cv * wgt, p6)
        a = torch.cat((torch.cat((ju, (wgt * ru)[:, None]), dim=1),
                       torch.cat((jv, (wgt * rv)[:, None]), dim=1)), dim=0)
        return psum(a.T @ a)

    def step(yp, sp):
        cp_u, cp_v = fl.step_const(sp)
        ru0, rv0 = fl.residual(sp, cp_u, cp_v)
        init_norm = torch.sqrt(psum(torch.sum((wgt * ru0) ** 2)
                                    + torch.sum((wgt * rv0) ** 2)))

        def system(y):
            s = scalars(y)
            gext = gn_system_plain(s, *fl.residual(s, cp_u, cp_v))
            return solve_ls(gext[:k, :k], -gext[:k, k]), \
                torch.sqrt(gext[k, k])

        return _gauss_newton(yp, init_norm, system, it0=0,
                             unrolled=unroll_its > 0, n_iters=unroll_its,
                             max_its=max_its, relnorm_cutoff=relnorm_cutoff,
                             min_delta=min_delta)

    return _time_loop(y0, num_steps, step, scalars)


def precompute_pallas_system(blocks: FactoredBlocks, sample_weights,
                             tile: int = 256, dtype=torch.float32):
    """Padded (p6p, wgt_p) for pallas_hprom (ops/gn.pad_factored_inputs),
    float32 as in the JAX package unless `dtype` says otherwise."""
    return pad_factored_inputs(blocks.p6, sample_weights, tile=tile,
                               dtype=dtype)


def pallas_hprom(grid: Grid2D, mesh, p6p, wgt_p, y0, dt, num_steps,
                 mu1, mu2, *, max_its: int = 20,
                 relnorm_cutoff: float = 1e-5, min_delta: float = 0.1,
                 unroll_its: int = 0, ls_method: str = "normal",
                 tile: int = 256) -> ROMResult:
    """factored_hprom with the whole Gauss-Newton system in ONE kernel
    call per iteration (ops/gn.gn_system; csrc/gn_sampled.cu on a CUDA
    device), in p6p's dtype.

    ls_method "normal" (Cholesky) or "cg" solve the reduced system after
    the call; "fused" folds the CG into the call (ops/gn.gn_step), so an
    iteration is one kernel call and no other work. `tile` is the padding
    tile of p6p (the plain version's partial-Gram tiles). The run makes
    one kernel workspace and passes it to every call, so no call
    allocates scratch; each call's outputs are new tensors (the loop
    keeps the previous call's rn).
    ROMResult.gn_evals counts the kernel calls.
    """
    dtype, device = p6p.dtype, p6p.device
    y0 = torch.as_tensor(y0, device=device).to(dtype)
    n_p, kp = p6p.shape[1], p6p.shape[2]
    n_s = mesh.n_sample
    k = y0.shape[0]
    p_flat = p6p.reshape(6 * n_p, kp)
    hdx = float(0.5 * dt / grid.dx)
    hdy = float(0.5 * dt / grid.dy)
    pad = (0, n_p - n_s)
    src_lbc = F.pad(sampled_source(mesh, grid, mu2, dt, dtype)
                    + sampled_inflow_bc(mesh, grid, mu1, dt, dtype), pad)
    fl = _HalfFlux(hdx, hdy, src_lbc)
    wgt = wgt_p[:, 0]
    solve_ls = _reduced_solver(ls_method)
    ws = sampled_workspace(p6p, k)

    def scalars(y):
        y_pad = torch.zeros(kp, dtype=dtype, device=device)
        y_pad[:k] = y
        return (p_flat @ y_pad).reshape(6, n_p)

    def step(yp, sp):
        cp_u, cp_v = fl.step_const(sp)
        cp = torch.stack((cp_u, cp_v), dim=1)
        ru0, rv0 = fl.residual(sp, cp_u, cp_v)
        init_norm = torch.sqrt(torch.sum((wgt * ru0) ** 2)
                               + torch.sum((wgt * rv0) ** 2))

        def system(y):
            if ls_method == "fused":
                return gn_step(p6p, y, cp, wgt_p, k, hdx, hdy, tile=tile,
                               solve_iters=CG_ITERS, workspace=ws)
            gext = gn_system(p6p, y, cp, wgt_p, k, hdx, hdy, tile=tile,
                             workspace=ws)
            return solve_ls(gext[:k, :k], -gext[:k, k]), \
                torch.sqrt(gext[k, k])

        return _gauss_newton(yp, init_norm, system, it0=0,
                             unrolled=unroll_its > 0, n_iters=unroll_its,
                             max_its=max_its, relnorm_cutoff=relnorm_cutoff,
                             min_delta=min_delta)

    return _time_loop(y0, num_steps, step, scalars)


def precompute_prom_pallas(grid: Grid2D, basis, tile_rows=None,
                           dtype=torch.float32):
    """Padded (vu_p, vv_p, dmask, tile_rows) for pallas_prom
    (ops/gn_full.pad_basis_full + row_mask), float32 as in the JAX
    package unless `dtype` says otherwise."""
    vu_p, vv_p, tr = pad_basis_full(basis, grid, tile_rows, dtype=dtype)
    return vu_p, vv_p, row_mask(grid, tr, dtype, vu_p.device), tr


def pallas_prom(grid: Grid2D, vu_p, vv_p, dmask, y0, dt, num_steps,
                mu1, mu2, *, max_its: int = 20,
                relnorm_cutoff: float = 1e-5, min_delta: float = 0.1,
                unroll_its: int = 0, ls_method: str = "normal",
                tile_rows: int = 4, ls_dtype=None) -> ROMResult:
    """FULL-grid LSPG PROM with the streaming Gauss-Newton system
    (ops/gn_full.py; csrc/gn_full.cu on a CUDA device), in vu_p's dtype.

    Per Gauss-Newton iteration: ONE system call (the scalars, residual,
    J V rows and the (k+1, k+1) Gram extension from one pass over the
    padded basis, reduced in float64) and the small reduced solve in
    `ls_dtype` (default: vu_p's dtype). The first iteration of each step
    also derives the step constant, so a step costs exactly its
    iterations' calls plus the stopping check. Same math and stopping
    rules as rom.lspg_prom; the first update of a step is always taken.
    unroll_its > 0 runs that many calls per step in all (the first
    included), masked. ROMResult.gn_evals counts the kernel calls.

    While a recording is on (utils/profiling) the call is the span
    `rom.prom_trajectory`, each system call `rom.prom_system`, each
    reduced solve (and a step's first update) `rom.prom_solve`, beside
    _gauss_newton's spans and ops/gn_full's `rom.gn_full_systems`.
    """
    with profiling.span("rom.prom_trajectory"):
        dtype, device = vu_p.dtype, vu_p.device
        y0 = torch.as_tensor(y0, device=device).to(dtype)
        k = y0.shape[0]
        n_pad = vu_p.shape[0]
        nxp = _round_up(grid.nx + 1, 8)      # dead-cell row layout
        ny_pad = n_pad // nxp
        tile = tile_rows * nxp
        sdt = dtype if ls_dtype is None else ls_dtype
        hdx = float(0.5 * dt / grid.dx)
        hdy = float(0.5 * dt / grid.dy)
        slbc = torch.zeros((ny_pad, nxp), dtype=dtype, device=device)
        slbc[: grid.ny, : grid.nx] = \
            source_term(grid, mu2, dt, dtype, device) \
            + inflow_bc_term(grid, mu1, dt, dtype, device)
        slbc = slbc.reshape(n_pad, 1)
        if ls_method == "fused":
            raise ValueError("pallas_prom takes ls_method 'normal' or "
                             "'cg'")
        solve_ls = _reduced_solver(ls_method)

        def solve(gext):
            return solve_ls(gext[:k, :k], -gext[:k, k])

        def step(yp, _sp):
            with profiling.span("rom.prom_system"):
                gext0, cp = gn_full_first(vu_p, vv_p, yp, slbc, dmask, k,
                                          nxp, tile, hdx, hdy)
            with profiling.span("rom.prom_solve"):
                gext0 = gext0.to(sdt)
                init_norm = torch.sqrt(gext0[k, k])
                dy0 = solve(gext0)
                y1 = (yp.to(dy0.dtype) + dy0).to(dtype)

            def system(y):
                with profiling.span("rom.prom_system"):
                    gext = gn_full_system(vu_p, vv_p, y, cp, dmask, k, nxp,
                                          tile, hdx, hdy)
                with profiling.span("rom.prom_solve"):
                    gext = gext.to(sdt)
                    return solve(gext), torch.sqrt(gext[k, k])

            y, it, ev = _gauss_newton(
                y1, init_norm, system, it0=1, unrolled=unroll_its > 0,
                n_iters=unroll_its - 1, max_its=max_its,
                relnorm_cutoff=relnorm_cutoff, min_delta=min_delta)
            return y, it, ev + 1

        return _time_loop(y0, num_steps, step)


def traj_source(grid: Grid2D, mesh, dt, mu1, mu2, n_p: int, dtype):
    """The padded source + inflow term (n_p, 1) of one μ point: the only
    input of the trajectory engine that depends on μ."""
    src_lbc = sampled_source(mesh, grid, mu2, dt, dtype) \
        + sampled_inflow_bc(mesh, grid, mu1, dt, dtype)
    return F.pad(src_lbc, (0, n_p - mesh.n_sample))[:, None]


def traj_hprom_batch(grid: Grid2D, mesh, p6p, wgt_p, y0, dt, num_steps,
                     mus, **kwargs):
    """pallas_traj_hprom for every (mu1, mu2) row of `mus` in ONE launch:
    returns (reduced coords (B, k, num_steps+1), GN updates (B,)).

    While a recording is on (utils/profiling) the call is the span
    `rom.traj_batch`, the per-point inputs `rom.traj_inputs`, and the
    Gauss-Newton systems the engine built are added to `rom.gn_systems`.
    """
    with profiling.span("rom.traj_batch"):
        with profiling.span("rom.traj_inputs"):
            y0 = torch.as_tensor(y0, device=p6p.device).to(p6p.dtype)
            n_p = p6p.shape[1]
            slbc = torch.stack([traj_source(grid, mesh, dt, mu1, mu2, n_p,
                                            p6p.dtype) for mu1, mu2 in mus])
            y0b = y0.expand(len(slbc), -1).contiguous()
        out = trajectory_hprom(p6p, y0b, slbc, wgt_p, y0.shape[0],
                               float(0.5 * dt / grid.dx),
                               float(0.5 * dt / grid.dy), int(num_steps),
                               **kwargs)
        # the systems the kernel built, left on the device
        profiling.count("rom.gn_systems", out.evals)
        red = torch.cat((y0b[:, None], out.ys), dim=1).transpose(1, 2)
        return red, out.its


def pallas_traj_hprom(grid: Grid2D, mesh, p6p, wgt_p, y0, dt, num_steps,
                      mu1, mu2, *, unroll_its: int = 3,
                      solve_iters: int = 24, relnorm_cutoff: float = 1e-5,
                      min_delta: float = 0.1) -> ROMResult:
    """The whole HPROM time integration in ONE kernel launch, in p6p's
    dtype: `unroll_its` masked Gauss-Newton iterations per step (the
    stopping rules of factored_hprom's unrolled loop) with a
    `solve_iters`-step CG, all inside csrc/gn_traj.cu on a CUDA device
    (ops/gn.trajectory_hprom). ROMResult.gn_evals counts the launches: 1.
    """
    red, its = traj_hprom_batch(
        grid, mesh, p6p, wgt_p, y0, dt, num_steps, [(mu1, mu2)],
        unroll_its=unroll_its, solve_iters=solve_iters,
        relnorm_cutoff=relnorm_cutoff, min_delta=min_delta)
    return ROMResult(red_coords=red[0], total_gn_its=int(its[0]),
                     gn_evals=1)
