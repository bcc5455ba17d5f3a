"""Carrying state across from the JAX package, without importing jax.

Grids and layouts are read attribute by attribute from any object that
has the fields, arrays go through numpy. The FOM has no learned weights.
"""

from __future__ import annotations

import numpy as np
import torch

from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.skewed import SkewedLayout


def grid_from_jax(g) -> Grid2D:
    """A Grid2D with the fields of `g` (e.g. finitedifference_tpu's)."""
    return Grid2D(nx=int(g.nx), ny=int(g.ny),
                  x_low=float(g.x_low), x_up=float(g.x_up),
                  y_low=float(g.y_low), y_up=float(g.y_up))


def layout_from_jax(lay) -> SkewedLayout:
    """A SkewedLayout with the fields of `lay`."""
    return SkewedLayout(nx=int(lay.nx), ny=int(lay.ny),
                        nd_pad=int(lay.nd_pad), ny_pad=int(lay.ny_pad))


def to_torch(a, device=None, dtype=None) -> torch.Tensor:
    """A copy of an array (numpy, or anything np.asarray takes) as a
    tensor."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x if x is None else np.asarray(x)


def result_to_numpy(res):
    """A FOMResult or NewtonResult with every field as a numpy array."""
    return type(res)(*(_to_numpy(x) for x in res))
