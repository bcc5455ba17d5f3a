"""Matrix-free upwind stencils for the 2D inviscid Burgers HDM (PyTorch).

Counterpart of finitedifference_tpu/ops/stencil.py. The reference's sparse
first-order upwind operators are pure shifts:

    (D_x f)[r, c] = (f[r, c] - f[r, c-1]) / dx,   f[r, -1] := 0
    (D_y f)[r, c] = (f[r, c] - f[r-1, c]) / dy,   f[-1, c] := 0

All functions operate on fields shaped (..., ny, nx) with x as the
fastest (last) axis, matching the reference's x-major flattening.

Crank-Nicolson residual:

    ru = u - up + 0.5*dt*Dx(Fu + Fpu) + 0.5*dt*Dy(Fuv + Fpuv) - src - lbc
    rv = v - vp + 0.5*dt*Dy(Fv + Fpv) + 0.5*dt*Dx(Fuv + Fpuv)

with fluxes Fu = 0.5 u^2, Fv = 0.5 v^2, Fuv = 0.5 u v, source
src = dt * 0.02 * exp(mu2 * xc) and inflow BC lbc[:, 0] = 0.5*dt*mu1^2/dx.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from finitedifference_tpu_torch.device import resolve_device
from finitedifference_tpu_torch.grid import Grid2D, default_float


# --------------------------------------------------------------------------
# primitive shifts / differences
# --------------------------------------------------------------------------

def shift_west(f: torch.Tensor) -> torch.Tensor:
    """f[..., r, c] -> f[..., r, c-1], zero at the x=0 column."""
    return F.pad(f, (1, 0))[..., :-1]


def shift_south(f: torch.Tensor) -> torch.Tensor:
    """f[..., r, c] -> f[..., r-1, c], zero at the y=0 row."""
    return F.pad(f, (0, 0, 1, 0))[..., :-1, :]


def ddx_upwind(f: torch.Tensor, dx) -> torch.Tensor:
    """First-order upwind x-difference with zero ghost at x<0."""
    return (f - shift_west(f)) / dx


def ddy_upwind(f: torch.Tensor, dy) -> torch.Tensor:
    """First-order upwind y-difference with zero ghost at y<0."""
    return (f - shift_south(f)) / dy


# --------------------------------------------------------------------------
# constant per-(mu, dt) terms
# --------------------------------------------------------------------------

def _dtype_device(mu, dtype, device):
    """dtype/device of a per-mu constant: explicit arguments first, then
    those of `mu` when it is a tensor, else torch's default dtype and the
    CUDA device."""
    if isinstance(mu, torch.Tensor):
        dtype = dtype or (mu.dtype if mu.is_floating_point()
                          else default_float())
        device = device if device is not None else mu.device
    return dtype or default_float(), \
        resolve_device(device)


def source_term(grid: Grid2D, mu2, dt, dtype=None,
                device=None) -> torch.Tensor:
    """dt * 0.02 * exp(mu2 * xc), tiled over rows -> (ny, nx)."""
    dtype, device = _dtype_device(mu2, dtype, device)
    xc = grid.xc(dtype=dtype, device=device)
    mu2 = torch.as_tensor(mu2, dtype=dtype, device=device)
    row = torch.as_tensor(dt, dtype=dtype, device=device) * 0.02 \
        * torch.exp(mu2 * xc)
    return row[None, :].expand(grid.ny, grid.nx)


def inflow_bc_term(grid: Grid2D, mu1, dt, dtype=None,
                   device=None) -> torch.Tensor:
    """Inflow Dirichlet BC: lbc[:, 0] = 0.5*dt*mu1^2/dx, else 0 -> (ny, nx)."""
    dtype, device = _dtype_device(mu1, dtype, device)
    mu1 = torch.as_tensor(mu1, dtype=dtype, device=device)
    col = torch.zeros((grid.ny, grid.nx), dtype=dtype, device=device)
    col[:, 0] = 0.5 * torch.as_tensor(dt, dtype=dtype, device=device) \
        * mu1 * mu1 / grid.dx
    return col


# --------------------------------------------------------------------------
# residual
# --------------------------------------------------------------------------

def burgers_residual(u, v, up, vp, mu1, mu2, dt, grid: Grid2D,
                     src=None, lbc=None):
    """Crank-Nicolson residual on (..., ny, nx) fields -> (ru, rv).

    `src`/`lbc` may be precomputed (they depend only on (mu, dt, grid)).
    """
    if src is None:
        src = source_term(grid, mu2, dt, dtype=u.dtype, device=u.device)
    if lbc is None:
        lbc = inflow_bc_term(grid, mu1, dt, dtype=u.dtype, device=u.device)

    half_dt = 0.5 * dt
    fu = 0.5 * (u * u + up * up)        # Fu + Fpu
    fv = 0.5 * (v * v + vp * vp)        # Fv + Fpv
    fuv = 0.5 * (u * v + up * vp)       # Fuv + Fpuv

    dxfu = ddx_upwind(fu, grid.dx)
    dyfuv = ddy_upwind(fuv, grid.dy)
    dyfv = ddy_upwind(fv, grid.dy)
    dxfuv = ddx_upwind(fuv, grid.dx)

    ru = u - up + half_dt * (dxfu + dyfuv) - src - lbc
    rv = v - vp + half_dt * (dyfv + dxfuv)
    return ru, rv


def burgers_residual_flat(w, wp, mu1, mu2, dt, grid: Grid2D,
                          src=None, lbc=None):
    """Flat-state wrapper: (..., 2*n) -> (..., 2*n)."""
    u, v = grid.split_fields(w)
    up, vp = grid.split_fields(wp)
    ru, rv = burgers_residual(u, v, up, vp, mu1, mu2, dt, grid, src, lbc)
    return grid.merge_fields(ru, rv)


# --------------------------------------------------------------------------
# exact Jacobian as an operator
# --------------------------------------------------------------------------

def apply_jacobian(u, v, du, dv, dt, grid: Grid2D):
    """Exact Jacobian-vector product of the CN residual at state (u, v):

        Ju = du + 0.5*dt*Dx(u*du) + 0.25*dt*Dy(v*du + u*dv)
        Jv = dv + 0.5*dt*Dy(v*dv) + 0.25*dt*Dx(v*du + u*dv)

    (u, v) are (ny, nx); (du, dv) may carry leading batch axes
    (..., ny, nx), e.g. a whole basis at once.
    """
    half_dt = 0.5 * dt
    quarter_dt = 0.25 * dt
    cross = v * du + u * dv
    ju = du + half_dt * ddx_upwind(u * du, grid.dx) \
        + quarter_dt * ddy_upwind(cross, grid.dy)
    jv = dv + half_dt * ddy_upwind(v * dv, grid.dy) \
        + quarter_dt * ddx_upwind(cross, grid.dx)
    return ju, jv


def apply_jacobian_flat(w, dw, dt, grid: Grid2D):
    """Flat wrapper of apply_jacobian: (2n,), (..., 2n) -> (..., 2n)."""
    u, v = grid.split_fields(w)
    du, dv = grid.split_fields(dw)
    ju, jv = apply_jacobian(u, v, du, dv, dt, grid)
    return grid.merge_fields(ju, jv)


def jacobian_times_basis(w, basis, dt, grid: Grid2D):
    """J(w) @ V for a dense basis V of shape (2n, k) -> (2n, k), as one
    batched stencil over the k columns."""
    n = grid.n_cells
    k = basis.shape[1]
    cols = basis.T  # (k, 2n)
    du = cols[:, :n].reshape(k, grid.ny, grid.nx)
    dv = cols[:, n:].reshape(k, grid.ny, grid.nx)
    u, v = grid.split_fields(w)
    ju, jv = apply_jacobian(u, v, du, dv, dt, grid)
    out = torch.cat((ju.reshape(k, n), jv.reshape(k, n)), dim=1)  # (k, 2n)
    return out.T
