"""Uniform 2D finite-difference grid (PyTorch).

Counterpart of finitedifference_tpu/grid.py. The grid object carries only
sizes, spacings and cell centers; differencing is done by shift-and-
subtract stencils in ops/stencil.py.

State-vector convention (identical to the reference): a scalar field on
the grid is an (ny, nx) tensor with row index r = y-cell, column index
c = x-cell, flattened x-fastest (C order). The full state is
w = cat(u.ravel(), v.ravel()) of size 2*nx*ny.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from finitedifference_tpu_torch.device import resolve_device


def default_float() -> torch.dtype:
    """torch's default floating dtype (float32 unless changed)."""
    return torch.get_default_dtype()


@dataclasses.dataclass(frozen=True)
class Grid2D:
    nx: int
    ny: int
    x_low: float = 0.0
    x_up: float = 100.0
    y_low: float = 0.0
    y_up: float = 100.0

    @property
    def dx(self) -> float:
        return (self.x_up - self.x_low) / self.nx

    @property
    def dy(self) -> float:
        return (self.y_up - self.y_low) / self.ny

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    @property
    def state_dim(self) -> int:
        return 2 * self.n_cells

    def xc(self, dtype=None, device=None) -> torch.Tensor:
        """Cell-center x coordinates, shape (nx,), on `device` (default:
        the CUDA device)."""
        edges = torch.linspace(self.x_low, self.x_up, self.nx + 1,
                               dtype=dtype or default_float(),
                               device=resolve_device(device))
        return 0.5 * (edges[1:] + edges[:-1])

    def yc(self, dtype=None, device=None) -> torch.Tensor:
        edges = torch.linspace(self.y_low, self.y_up, self.ny + 1,
                               dtype=dtype or default_float(),
                               device=resolve_device(device))
        return 0.5 * (edges[1:] + edges[:-1])

    def grid_points(self):
        """(grid_x, grid_y) edge arrays, the reference's make_2d_grid
        output."""
        gx = np.linspace(self.x_low, self.x_up, self.nx + 1)
        gy = np.linspace(self.y_low, self.y_up, self.ny + 1)
        return gx, gy

    def initial_state(self, dtype=None, device=None) -> torch.Tensor:
        """w0 = 1 everywhere, flat (2*nx*ny,), on `device` (default: the
        CUDA device)."""
        return torch.ones(self.state_dim, dtype=dtype or default_float(),
                          device=resolve_device(device))

    # --- layout helpers -------------------------------------------------
    def split_fields(self, w: torch.Tensor):
        """Flat state (..., 2*n) -> (u, v) each (..., ny, nx)."""
        n = self.n_cells
        u = w[..., :n].reshape(*w.shape[:-1], self.ny, self.nx)
        v = w[..., n:].reshape(*w.shape[:-1], self.ny, self.nx)
        return u, v

    def merge_fields(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """(u, v) each (..., ny, nx) -> flat state (..., 2*n)."""
        lead = u.shape[:-2]
        return torch.cat((u.reshape(*lead, -1), v.reshape(*lead, -1)),
                         dim=-1)


def make_2d_grid(
    x_low: float,
    x_up: float,
    y_low: float,
    y_up: float,
    num_cells_x: int,
    num_cells_y: int,
) -> Grid2D:
    return Grid2D(
        nx=num_cells_x, ny=num_cells_y,
        x_low=x_low, x_up=x_up, y_low=y_low, y_up=y_up,
    )


def grid_from_config(cfg) -> Grid2D:
    return make_2d_grid(
        cfg.x_low, cfg.x_up, cfg.y_low, cfg.y_up,
        cfg.num_cells_x, cfg.num_cells_y,
    )
