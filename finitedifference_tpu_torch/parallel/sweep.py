"""Parameter sweeps over (mu1, mu2) on one card (PyTorch).

Counterpart of finitedifference_tpu/parallel/sweep.py, which vmaps the
jitted stepper over the μ batch and can shard the batch over a device
mesh. Here:
- sweep_hprom(engine="pallas_traj") runs every μ point in ONE launch of
  the whole-trajectory kernel (csrc/gn_traj.cu, one thread block
  cluster per point): μ enters only through the per-cell source and
  inflow term;
- the other engines run one trajectory per μ point in turn. That gives
  vmap's results: vmap masks each point's while-loop, so every point
  takes its own Newton or Gauss-Newton iterations.
Each returns the JAX package's shapes: (B, 2n, T+1) or (B, k, T+1). The
port runs on one card, so the `mesh=` sharding is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.fom import (
    inviscid_burgers_implicit2d,
    inviscid_burgers_implicit2d_skewed,
)
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.rom import ecsw_hprom, lspg_prom
from finitedifference_tpu_torch.rom_factored import (
    factored_hprom,
    precompute_factored_blocks,
    precompute_pallas_system,
    traj_hprom_batch,
)


def _points(mus) -> list[tuple[float, float]]:
    """The (mu1, mu2) rows of a (B, 2) array or tensor, as floats."""
    if isinstance(mus, torch.Tensor):
        mus = mus.detach().cpu().numpy()
    mus = np.asarray(mus, dtype=np.float64)
    if mus.ndim != 2 or mus.shape[1] != 2:
        raise ValueError(f"mus: expected a (B, 2) array, got shape "
                         f"{mus.shape}")
    return [(float(a), float(b)) for a, b in mus]


def sweep_fom(grid: Grid2D, w0, dt, num_steps, mus, *,
              engine: str = "standard", snaps_dtype=None, **kwargs):
    """FOM trajectories for a (B, 2) array of (mu1, mu2): snaps (B, 2n,
    num_steps+1). engine="skewed" is the skewed-coordinate solver (kwargs
    such as solve_dtype or seg= go to it)."""
    if engine not in ("standard", "skewed"):
        raise ValueError(f"unknown engine {engine!r}; use 'standard' or "
                         f"'skewed'")
    run = inviscid_burgers_implicit2d_skewed if engine == "skewed" \
        else inviscid_burgers_implicit2d
    w0 = as_tensor(w0)
    return torch.stack([run(grid, w0, dt, num_steps, mu1, mu2,
                            snaps_dtype=snaps_dtype, **kwargs).snaps
                        for mu1, mu2 in _points(mus)])


def sweep_lspg(grid: Grid2D, w0, dt, num_steps, mus, basis, **kwargs):
    """LSPG PROM sweep: reduced coordinates (B, k, num_steps+1)."""
    basis = as_tensor(basis)
    return torch.stack([lspg_prom(grid, w0, dt, num_steps, mu1, mu2, basis,
                                  **kwargs).red_coords
                        for mu1, mu2 in _points(mus)])


def sweep_hprom(grid: Grid2D, smesh, sample_weights, y0, basis_aug, dt,
                num_steps, mus, *, engine: str = "generic", **kwargs):
    """ECSW HPROM sweep: reduced coordinates (B, k, num_steps+1).

    engine "generic" is rom.ecsw_hprom, "factored" the stencil-block
    engine (blocks gathered once), "pallas_traj" the whole-trajectory
    kernel: the padded float32 blocks are built once and all B points run
    in one launch (unroll_its, solve_iters, relnorm_cutoff and min_delta
    apply; ls_method does not and is dropped, as in the JAX package).
    """
    points = _points(mus)
    if engine == "pallas_traj":
        blocks = precompute_factored_blocks(smesh, basis_aug)
        p6p, wgt_p = precompute_pallas_system(blocks, sample_weights)
        kw = {k: v for k, v in kwargs.items() if k != "ls_method"}
        return traj_hprom_batch(grid, smesh, p6p, wgt_p, y0, dt, num_steps,
                                points, **kw)[0]
    if engine == "factored":
        blocks = precompute_factored_blocks(smesh, basis_aug)
        return torch.stack([factored_hprom(
            grid, smesh, sample_weights, y0, blocks, dt, num_steps, mu1,
            mu2, **kwargs).red_coords for mu1, mu2 in points])
    if engine == "generic":
        return torch.stack([ecsw_hprom(
            grid, smesh, sample_weights, y0, basis_aug, dt, num_steps, mu1,
            mu2, **kwargs).red_coords for mu1, mu2 in points])
    raise ValueError(f"unknown engine {engine!r}; use 'generic', "
                     f"'factored' or 'pallas_traj'")


def pad_to_multiple(mus, multiple: int):
    """Pad the batch with copies of the last row to a multiple of
    `multiple`. Returns (padded, original_count)."""
    mus = np.asarray(mus)
    b = mus.shape[0]
    rem = (-b) % multiple
    if rem:
        mus = np.vstack([mus, np.repeat(mus[-1:], rem, axis=0)])
    return mus, b
