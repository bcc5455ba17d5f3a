"""The entry step of the port: one implicit Crank-Nicolson Newton step of
the 250x250 2D Burgers HDM (the reference coarse workbench's hot path,
hypernet2D.py:72-131).

Counterpart of __graft_entry__.py's entry(): entry() returns
(step, example_args), step(w, mu1, mu2) being fom.newton_step(...,
max_its=20).w, the example a float32 uniform state at μ = (4.75, 0.02),
on the card unless `device` asks for the CPU. On the card each Newton
iteration's linear solve is one launch of the wavefront kernel on the
(ny, nx) fields behind ops/wavefront.solve_jacobian_wavefront
(csrc/wavefront.cu, B2; counter cuda_wavefront.UNSKEWED_LAUNCHES).
"""

from __future__ import annotations

import torch

from finitedifference_tpu_torch.config import BurgersConfig
from finitedifference_tpu_torch.device import resolve_device
from finitedifference_tpu_torch.fom import newton_step
from finitedifference_tpu_torch.grid import grid_from_config


def entry(device=None):
    """(step, example_args) of the 250x250 Newton step (module
    docstring)."""
    cfg = BurgersConfig()              # 250x250, dt=0.05
    grid = grid_from_config(cfg)
    device = resolve_device(device)

    def step(w, mu1, mu2):
        return newton_step(w, mu1, mu2, cfg.dt, grid, max_its=20).w

    w0 = grid.initial_state(dtype=torch.float32, device=device)
    example_args = (w0,
                    torch.tensor(4.75, dtype=torch.float32, device=device),
                    torch.tensor(0.02, dtype=torch.float32, device=device))
    return step, example_args
