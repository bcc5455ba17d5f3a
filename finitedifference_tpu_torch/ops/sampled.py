"""Sampled-mesh (hyper-reduced) stencil operators (PyTorch).

Counterpart of finitedifference_tpu/ops/sampled.py. The reference
restricts its sparse operators to ECSW-selected rows and an "augmented"
column set: each sampled cell plus its west and south neighbours, the
upwind stencil's support (hypernet2D.py:2446-2668). Here the restriction
is a set of precomputed gather maps, int64 tensors on the state's device:
for each sampled cell, the positions of itself and of its west and south
neighbours inside the augmented array.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from finitedifference_tpu_torch.device import resolve_device
from finitedifference_tpu_torch.grid import Grid2D


class SampledMesh(NamedTuple):
    """Gather maps of a hyper-reduced mesh (tensors on one device)."""
    sample_cells: torch.Tensor  # (n_s,) int64, sorted cell indices
    aug_cells: torch.Tensor     # (n_z,) int64, sorted augmented cells
    pos_self: torch.Tensor      # (n_s,) index of each sample in aug_cells
    pos_west: torch.Tensor      # (n_s,) index of west neighbour (0 if none)
    pos_south: torch.Tensor     # (n_s,) index of south neighbour (0 if none)
    has_west: torch.Tensor      # (n_s,) bool, False on the x=0 column
    has_south: torch.Tensor     # (n_s,) bool, False on the y=0 row
    col_x: torch.Tensor         # (n_s,) x-column of each sample
    is_left: torch.Tensor       # (n_s,) bool, sample on the inflow column

    @property
    def n_sample(self) -> int:
        return self.sample_cells.shape[0]

    @property
    def n_aug(self) -> int:
        return self.aug_cells.shape[0]


def generate_augmented_mesh(grid: Grid2D, sample_inds) -> np.ndarray:
    """Sampled cells plus their in-bounds west/south neighbours, sorted
    (reference generate_augmented_mesh, hypernet2D.py:2446)."""
    sample_inds = np.asarray(sample_inds)
    r, c = np.unravel_index(sample_inds, (grid.ny, grid.nx))
    aug = set(sample_inds.tolist())
    aug.update(((r - 1) * grid.nx + c)[r - 1 >= 0].tolist())   # south
    aug.update((r * grid.nx + (c - 1))[c - 1 >= 0].tolist())   # west
    return np.sort(np.fromiter(aug, dtype=np.int64))


def build_sampled_mesh(grid: Grid2D, sample_inds,
                       device=None) -> SampledMesh:
    """Gather maps for `sample_inds` (cell indices; sorted here), on
    `device` (default: the CUDA device)."""
    device = resolve_device(device)
    sample_inds = np.sort(np.asarray(sample_inds))
    aug = generate_augmented_mesh(grid, sample_inds)
    lookup = {int(cell): i for i, cell in enumerate(aug)}

    r, c = np.unravel_index(sample_inds, (grid.ny, grid.nx))
    pos_self = np.array([lookup[int(i)] for i in sample_inds],
                        dtype=np.int64)
    has_west = c - 1 >= 0
    has_south = r - 1 >= 0
    west_cells = r * grid.nx + np.maximum(c - 1, 0)
    south_cells = np.maximum(r - 1, 0) * grid.nx + c
    pos_west = np.array([lookup.get(int(i), 0) for i in west_cells],
                        dtype=np.int64)
    pos_south = np.array([lookup.get(int(i), 0) for i in south_cells],
                         dtype=np.int64)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return SampledMesh(
        sample_cells=t(sample_inds),
        aug_cells=t(aug),
        pos_self=t(pos_self),
        pos_west=t(pos_west),
        pos_south=t(pos_south),
        has_west=t(has_west, torch.bool),
        has_south=t(has_south, torch.bool),
        col_x=t(c),
        is_left=t(c == 0, torch.bool),
    )


def augmented_state_indices(mesh: SampledMesh, n_cells: int) -> torch.Tensor:
    """Indices into a flat state (2n,) selecting augmented u then v rows
    (the reference's `idx = [augmented; n + augmented]`)."""
    aug = mesh.aug_cells
    return torch.cat((aug, n_cells + aug))


def _gather_stencil(f_aug, mesh: SampledMesh, axis: str):
    """Upwind difference f_self - f_neighbour of an augmented-array field
    at the sample cells, with a zero ghost outside the domain."""
    f_self = f_aug[..., mesh.pos_self]
    if axis == "x":
        f_nb = torch.where(mesh.has_west, f_aug[..., mesh.pos_west], 0.0)
    else:
        f_nb = torch.where(mesh.has_south, f_aug[..., mesh.pos_south], 0.0)
    return f_self - f_nb


def sampled_source(mesh: SampledMesh, grid: Grid2D, mu2, dt, dtype):
    xc = grid.xc(dtype=dtype, device=mesh.col_x.device)[mesh.col_x]
    mu2 = torch.as_tensor(mu2, dtype=dtype, device=xc.device)
    return torch.as_tensor(dt, dtype=dtype, device=xc.device) * 0.02 \
        * torch.exp(mu2 * xc)


def sampled_inflow_bc(mesh: SampledMesh, grid: Grid2D, mu1, dt, dtype):
    device = mesh.is_left.device
    mu1 = torch.as_tensor(mu1, dtype=dtype, device=device)
    val = 0.5 * torch.as_tensor(dt, dtype=dtype, device=device) * mu1 \
        * mu1 / grid.dx
    return torch.where(mesh.is_left, val,
                       torch.zeros((), dtype=dtype, device=device))


def sampled_residual(w_aug, wp_aug, mu1, mu2, dt, grid: Grid2D,
                     mesh: SampledMesh, src=None, lbc=None):
    """CN residual at the sampled cells.

    w_aug, wp_aug: (2*n_z,) states on the augmented mesh (u rows then v).
    Returns (2*n_s,): the full residual gathered at `sample_cells`.
    """
    n_z = mesh.n_aug
    u, v = w_aug[:n_z], w_aug[n_z:]
    up, vp = wp_aug[:n_z], wp_aug[n_z:]
    if src is None:
        src = sampled_source(mesh, grid, mu2, dt, u.dtype)
    if lbc is None:
        lbc = sampled_inflow_bc(mesh, grid, mu1, dt, u.dtype)

    fu = 0.5 * (u * u + up * up)
    fv = 0.5 * (v * v + vp * vp)
    fuv = 0.5 * (u * v + up * vp)

    half_dt = 0.5 * dt
    du_t = u[mesh.pos_self] - up[mesh.pos_self]
    dv_t = v[mesh.pos_self] - vp[mesh.pos_self]
    ru = du_t + half_dt * (_gather_stencil(fu, mesh, "x") / grid.dx
                           + _gather_stencil(fuv, mesh, "y") / grid.dy) \
        - src - lbc
    rv = dv_t + half_dt * (_gather_stencil(fv, mesh, "y") / grid.dy
                           + _gather_stencil(fuv, mesh, "x") / grid.dx)
    return torch.cat((ru, rv))


def sampled_jacobian_times_basis(w_aug, basis_aug, dt, grid: Grid2D,
                                 mesh: SampledMesh):
    """(J restricted to sample rows x augmented cols) @ basis_aug.

    basis_aug: (2*n_z, k), the basis gathered at augmented rows.
    Returns (2*n_s, k): ops.stencil.apply_jacobian restricted by gathers.
    """
    n_z = mesh.n_aug
    u, v = w_aug[:n_z], w_aug[n_z:]
    bu = basis_aug[:n_z, :]
    bv = basis_aug[n_z:, :]

    half_dt = 0.5 * dt
    quarter_dt = 0.25 * dt
    uu = u[:, None] * bu
    vv = v[:, None] * bv
    cross = v[:, None] * bu + u[:, None] * bv

    def gx(f):
        f_nb = torch.where(mesh.has_west[:, None], f[mesh.pos_west, :], 0.0)
        return (f[mesh.pos_self, :] - f_nb) / grid.dx

    def gy(f):
        f_nb = torch.where(mesh.has_south[:, None], f[mesh.pos_south, :],
                           0.0)
        return (f[mesh.pos_self, :] - f_nb) / grid.dy

    ju = bu[mesh.pos_self, :] + half_dt * gx(uu) + quarter_dt * gy(cross)
    jv = bv[mesh.pos_self, :] + half_dt * gy(vv) + quarter_dt * gx(cross)
    return torch.cat((ju, jv), dim=0)
