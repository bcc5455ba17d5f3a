"""Spatial domain decomposition: grid rows sharded over the ranks of a
mesh axis, with a halo exchange (PyTorch).

Counterpart of finitedifference_tpu/parallel/spatial.py, which answers
the reference's scaling wall (the fine 750^2 FOM ran out of memory on one
node) by sharding the state: fields (ny, nx) split along y across the
"sp" axis. The upwind stencil needs one south halo row, exchanged once
per residual evaluation (parallel/mesh.shift_south); x-direction
stencils are local.

Each function runs on every rank of the mesh (parallel/mesh.spawn), takes
the global arrays the JAX function takes, works on this rank's rows and
returns the global result, gathered in rank order. Stopping decisions
come from norms summed over the ranks (mesh.psum), the same bits on
every rank, so every rank makes the same collectives in the same order.

- make_sharded_residual: the CN residual with a south halo;
- sharded_fom_step: one implicit CN step whose linear solve is
  block-Jacobi forward sweeps (ops/wavefront.solve_jacobian_sweeps), a
  halo exchange a sweep;
- sharded_skewed_fom: the whole trajectory on the skewed layout, the
  grid-row axis of the skewed plane sharded, the exact wavefront
  recurrence with one (2, 1) halo exchange of its (du, dv) carry a
  diagonal;
- sharded_sweep_fom_step: a (dp, sp) mesh, the μ batch over dp and the
  rows over sp.
"""

from __future__ import annotations

import torch

from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops import skewed as sk
from finitedifference_tpu_torch.ops.stencil import shift_west
from finitedifference_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    psum,
    shift_south,
)


def _rows(n_rows: int, mesh: Mesh, axis: str) -> slice:
    """This rank's block of `n_rows` rows (n_rows divisible by the axis
    size, as shard_map requires)."""
    n = mesh.size(axis)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows not divisible by {axis}={n}")
    b = n_rows // n
    i = mesh.rank(axis)
    return slice(i * b, (i + 1) * b)


def _local(x, mesh: Mesh, axis: str, dim: int = -2):
    """This rank's rows of a global array, on the mesh's device."""
    x = as_tensor(x, device=mesh.device)
    block = _rows(x.shape[dim], mesh, axis)
    return x.narrow(dim, block.start, block.stop - block.start)


def _sharded_residual_local(u, v, up, vp, src, lbc, dt, dx, dy, mesh,
                            axis):
    """CN residual on one rank's rows (ny_loc, nx), with the halo of the
    two y-differenced fluxes in one exchange."""
    half_dt = 0.5 * dt
    fu = 0.5 * (u * u + up * up)
    fv = 0.5 * (v * v + vp * vp)
    fuv = 0.5 * (u * v + up * vp)
    s_fuv, s_fv = shift_south(torch.stack((fuv, fv)), mesh, axis, dim=-2)

    def ddx(f):
        return (f - shift_west(f)) / dx

    ru = u - up + half_dt * (ddx(fu) + (fuv - s_fuv) / dy) - src - lbc
    rv = v - vp + half_dt * ((fv - s_fv) / dy + ddx(fuv))
    return ru, rv


def _solve_sweeps_local(u, v, fu_rhs, fv_rhs, dt, dx, dy, num_sweeps, mesh,
                        axis):
    """Block-Jacobi triangular sweeps with a cross-rank south halo."""
    k = 0.5 * dt
    kx, ky = k / dx, k / dy
    b11 = 1.0 + kx * u + 0.5 * ky * v
    b12 = 0.5 * ky * u
    b21 = 0.5 * kx * v
    b22 = 1.0 + ky * v + 0.5 * kx * u
    det = b11 * b22 - b12 * b21
    u_w, v_w = shift_west(u), shift_west(v)
    u_s, v_s = shift_south(torch.stack((u, v)), mesh, axis, dim=-2)

    def binv(ru, rv):
        return (b22 * ru - b12 * rv) / det, (b11 * rv - b21 * ru) / det

    du, dv = binv(fu_rhs, fv_rhs)
    for _ in range(num_sweeps):
        du_w, dv_w = shift_west(du), shift_west(dv)
        du_s, dv_s = shift_south(torch.stack((du, dv)), mesh, axis, dim=-2)
        rhs_u = fu_rhs + kx * u_w * du_w \
            + 0.5 * ky * (v_s * du_s + u_s * dv_s)
        rhs_v = fv_rhs + 0.5 * kx * (v_w * du_w + u_w * dv_w) \
            + ky * v_s * dv_s
        du, dv = binv(rhs_u, rhs_v)
    return du, dv


def _skewed_solve_local(u, v, ru, rv, live, kx, ky, ndiag, shift_r):
    """Exact wavefront substitution on this rank's rows of the skewed
    plane (nd_pad, ny_loc): diagonal d reads diagonal d-1 at row r (west)
    and r-1 (south, the rank below's last row for the first: one exchange
    of the (du, dv) carry a diagonal). The diagonals from ndiag on lie off
    the band and stay zero.

    JAX's recurrence, operation for operation, with the products of state
    values taken for every diagonal at once and the u and v rows of each
    diagonal's chain stacked, so a diagonal is ~20 small kernels:
        rhs_u = ru + (kx u_w) du_w + (ky / 2) (v_s du_s + u_s dv_s)
        rhs_v = rv + (kx / 2) (v_w du_w + u_w dv_w) + (ky v_s) dv_s
        du = (b22 rhs_u - b12 rhs_v) / det, dv = (b11 rhs_v - b21 rhs_u) / det
    (w: the west neighbour, diagonal d-1 at row r; s: the south one).
    """
    b11 = 1.0 + kx * u + 0.5 * ky * v
    b12 = 0.5 * ky * u
    b21 = 0.5 * kx * v
    b22 = 1.0 + ky * v + 0.5 * kx * u
    det = b11 * b22 - b12 * b21
    bm = torch.stack((b22, b11))             # times (rhs_u, rhs_v)
    bn = torch.stack((b12, b21))             # times (rhs_v, rhs_u)
    uv_w = sk.shift_prev_diag(torch.stack((u, v)))
    uv_s = shift_r(uv_w)
    u_w, v_w = uv_w
    u_s, v_s = uv_s
    # the state factor of each product, in the order of z below
    x = torch.stack((v_s, v_w, u_s, u_w, kx * u_w, ky * v_s))
    rr = torch.stack((ru, rv))
    half = torch.tensor([[0.5 * ky], [0.5 * kx]], dtype=u.dtype,
                        device=u.device)
    out = torch.zeros_like(rr)
    d_w = torch.zeros_like(rr[:, 0])         # (du, dv) of diagonal d-1
    for d in range(ndiag):
        d_s = shift_r(d_w)
        z = x[:, d] * torch.stack((d_s[0], d_w[0], d_s[1], d_w[1], d_w[0],
                                   d_s[1]))
        c = half * (z[0:2] + z[2:4])         # (ky/2)(..), (kx/2)(..)
        rhs = (rr[:, d] + torch.stack((z[4], c[1]))) \
            + torch.stack((c[0], z[5]))
        d_w = torch.where(live[d], (bm[:, d] * rhs - bn[:, d] * rhs.flip(0))
                          / det[d], 0.0)
        out[:, d] = d_w
    return out[0], out[1]


def make_sharded_residual(mesh: Mesh, grid: Grid2D, dt,
                          axis_name: str = "sp"):
    """f(u, v, up, vp, src, lbc) -> (ru, rv): the CN residual of global
    (ny, nx) fields, each rank computing its rows."""
    def f(u, v, up, vp, src, lbc):
        loc = [_local(a, mesh, axis_name) for a in (u, v, up, vp, src, lbc)]
        ru, rv = _sharded_residual_local(*loc, dt, grid.dx, grid.dy, mesh,
                                         axis_name)
        return (all_gather(ru, mesh, axis_name, dim=-2),
                all_gather(rv, mesh, axis_name, dim=-2))

    return f


def _local_newton_step(up, vp, src, lbc, dt, dx, dy, num_sweeps, max_its,
                       relnorm_cutoff, mesh, axis):
    """One implicit CN Newton step on this rank's rows (collectives over
    `axis` for the halos and the global residual norm).

    The JAX loop's rules: stop before the update once rn / init_norm <
    cutoff, or, once it > 0, rn > 0.99 * the previous rn; at most max_its
    evaluations. A stopping iteration makes no solve here (JAX solves and
    discards it), the same on every rank."""
    def res(u, v):
        return _sharded_residual_local(u, v, up, vp, src, lbc, dt, dx, dy,
                                       mesh, axis)

    def global_norm(ru, rv):
        ss = torch.sum(ru * ru) + torch.sum(rv * rv)
        return torch.sqrt(psum(ss, mesh, axis))

    init_norm = global_norm(*res(up, vp))
    u, v, it = up, vp, 0
    done, prev = bool(torch.isnan(init_norm)), None
    while not done and it < max_its:
        ru, rv = res(u, v)
        rn = global_norm(ru, rv)
        stop = rn / init_norm < relnorm_cutoff
        if it > 0:
            stop = stop | (rn > 0.99 * prev)
        done = bool(stop)
        if not done:
            du, dv = _solve_sweeps_local(u, v, ru, rv, dt, dx, dy,
                                         num_sweeps, mesh, axis)
            u, v = u - du, v - dv
        it += 1
        prev = rn
    return u, v


def sharded_fom_step(mesh: Mesh, grid: Grid2D, dt, *,
                     axis_name: str = "sp", num_sweeps: int = 64,
                     max_its: int = 50, relnorm_cutoff: float = 1e-12):
    """step(u_p, v_p, src, lbc) -> (u, v): one implicit CN Newton solve
    of global (ny, nx) fields over row-sharded ranks, where every residual
    evaluation and every triangular sweep exchanges one halo row. src and
    lbc are the per-(mu, dt) fields (ops/stencil.source_term,
    inflow_bc_term)."""
    def step(up, vp, src, lbc):
        loc = [_local(a, mesh, axis_name) for a in (up, vp, src, lbc)]
        u, v = _local_newton_step(*loc, dt, grid.dx, grid.dy, num_sweeps,
                                  max_its, relnorm_cutoff, mesh, axis_name)
        return (all_gather(u, mesh, axis_name, dim=-2),
                all_gather(v, mesh, axis_name, dim=-2))

    return step


def sharded_skewed_fom(mesh: Mesh, grid: Grid2D, w0, dt, num_steps,
                       mu1, mu2, *, axis_name: str = "sp",
                       max_its: int = 100,
                       relnorm_cutoff: float | None = None,
                       snaps_dtype=None):
    """The whole implicit FOM trajectory on the skewed (anti-diagonal)
    layout, sharded along the grid-row axis of the skewed plane.

    Skewed fields are (nd_pad, ny_pad): axis 0 the anti-diagonal d, axis
    1 the grid row r, sharded over `axis_name` (ny_pad divisible by the
    axis size). The upwind stencil reads S[d-1, r] (local) and S[d-1,
    r-1] (a one-column halo: both y-differenced fluxes in one exchange a
    residual). The exact wavefront substitution runs over the diagonals
    with the carry (du, dv) of the previous diagonal, its r-1 shift one
    exchange of a (2, 1) halo a diagonal, after one exchange of the
    state's column a solve (JAX exchanges a packed (4, 1) carry of u, v,
    du, dv a diagonal; the values are the same). The band ends at
    diagonal ny + nx - 2; the padded diagonals after it are zero.

    The single-card skewed engine's Newton rules (no `it > 0` in the
    stagnation test), residual norms summed over the ranks; the cutoff
    defaults to 1e-12 in float64 and 1e-6 in float32. Returns (snaps
    (2n, num_steps+1), total_newton_its), on every rank.
    """
    w0 = as_tensor(w0, device=mesh.device)
    dtype, device = w0.dtype, w0.device
    if relnorm_cutoff is None:
        relnorm_cutoff = 1e-12 if dtype == torch.float64 else 1e-6
    sd = snaps_dtype or dtype
    num = mesh.size(axis_name)
    lay = sk.make_layout(grid)
    if lay.ny_pad % num:
        raise ValueError(f"ny_pad={lay.ny_pad} not divisible by "
                         f"{axis_name}={num}")

    def local(x):
        return _local(x, mesh, axis_name, dim=-1)

    vmask = local(sk.valid_mask(lay, dtype, device))
    live = vmask > 0
    src = local(sk.skewed_source(lay, grid, mu2, dt, dtype, device))
    lbc = local(sk.skewed_inflow_bc(lay, grid, mu1, dt, dtype, device))
    u0, v0 = grid.split_fields(w0)
    su0 = local(sk.to_skewed(u0, lay))
    sv0 = local(sk.to_skewed(v0, lay))

    kx = 0.5 * dt / grid.dx
    ky = 0.5 * dt / grid.dy
    half_dt = 0.5 * dt

    def shift_r(x):
        """S[..., r] -> S[..., r-1] across ranks (zero ghost at r=0)."""
        return shift_south(x, mesh, axis_name, dim=-1)

    def res_half(u, v):
        """Current-state half of the CN residual (ops/skewed._half_flux
        with a halo on r)."""
        fu = 0.5 * u * u
        fv = 0.5 * v * v
        fuv = 0.5 * u * v
        s_fuv, s_fv = shift_r(sk.shift_prev_diag(torch.stack((fuv, fv))))

        def ddx(f):
            return (f - sk.shift_prev_diag(f)) / grid.dx

        au = u + half_dt * (ddx(fu) + (fuv - s_fuv) / grid.dy)
        av = v + half_dt * ((fv - s_fv) / grid.dy + ddx(fuv))
        return au, av

    def norm2(ru, rv):
        ss = torch.sum(ru * ru) + torch.sum(rv * rv)
        return torch.sqrt(psum(ss, mesh, axis_name))

    def newton(up, vp):
        au, av = res_half(up, vp)
        cp_u = (au - 2.0 * up - src - lbc) * vmask
        cp_v = (av - 2.0 * vp) * vmask
        ru = au * vmask + cp_u
        rv = av * vmask + cp_v
        init_norm = rn = norm2(ru, rv)
        u, v, it = up, vp, 0
        done = bool(torch.isnan(init_norm))
        while not done and it < max_its:
            du, dv = _skewed_solve_local(u, v, ru, rv, live, kx, ky,
                                         lay.ndiag, shift_r)
            u = u - du
            v = v - dv
            au, av = res_half(u, v)
            ru = au * vmask + cp_u
            rv = av * vmask + cp_v
            rn_prev, rn = rn, norm2(ru, rv)
            done = bool((rn / init_norm < relnorm_cutoff)
                        | (rn > 0.99 * rn_prev))
            it += 1
        return u, v, it

    us = torch.empty((num_steps + 1,) + su0.shape, dtype=sd, device=device)
    vs = torch.empty_like(us)
    us[0], vs[0] = su0, sv0
    up, vp, its = su0, sv0, 0
    for i in range(num_steps):
        up, vp, nits = newton(up, vp)
        its += nits
        us[i + 1], vs[i + 1] = up, vp

    us = all_gather(us, mesh, axis_name, dim=-1)
    vs = all_gather(vs, mesh, axis_name, dim=-1)
    u_t = sk.from_skewed(us, lay).reshape(num_steps + 1, -1)
    v_t = sk.from_skewed(vs, lay).reshape(num_steps + 1, -1)
    return torch.cat((u_t, v_t), dim=1).T, its


def sharded_sweep_fom_step(mesh: Mesh, grid: Grid2D, dt, *,
                           dp_axis: str = "dp", sp_axis: str = "sp",
                           num_sweeps: int = 32, max_its: int = 50,
                           relnorm_cutoff: float = 1e-10):
    """step(up, vp, src, lbc) -> (u, v): the implicit CN step of global
    (B, ny, nx) fields, the batch over `dp_axis` (no communication) and
    the rows over `sp_axis` (halo exchanges). Each rank runs its block of
    the batch point by point, each point a Newton step of its own inside
    the sp group (JAX's vmap masks each point's loop the same way)."""
    def step(up, vp, src, lbc):
        loc = [_local(_local(a, mesh, dp_axis, dim=0), mesh, sp_axis)
               for a in (up, vp, src, lbc)]
        outs = [_local_newton_step(*point, dt, grid.dx, grid.dy, num_sweeps,
                                   max_its, relnorm_cutoff, mesh, sp_axis)
                for point in zip(*loc)]
        u = torch.stack([o[0] for o in outs])
        v = torch.stack([o[1] for o in outs])

        def gather(x):
            return all_gather(all_gather(x, mesh, sp_axis, dim=-2), mesh,
                              dp_axis, dim=0)

        return gather(u), gather(v)

    return step
