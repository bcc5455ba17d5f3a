"""Parameter sweeps over (mu1, mu2), on one card or over a mesh of ranks
(PyTorch).

Counterpart of finitedifference_tpu/parallel/sweep.py, which vmaps the
jitted stepper over the μ batch and can shard the batch over a device
mesh. Here:
- sweep_hprom(engine="pallas_traj") runs every μ point in ONE launch of
  the whole-trajectory kernel (csrc/gn_traj.cu, one thread block
  cluster per point): μ enters only through the per-cell source and
  inflow term;
- the other engines and sweep_manifold run one trajectory per μ point
  in turn. That gives vmap's results: vmap masks each point's
  while-loop, so every point takes its own Newton or Gauss-Newton
  iterations.
Each returns the JAX package's shapes: (B, 2n, T+1) or (B, k, T+1).

With `mesh=` (parallel/mesh.Mesh, e.g. make_sweep_mesh(), every rank
calling the sweep) the batch, padded to a multiple of the "dp" axis by
pad_to_multiple, is cut into contiguous blocks: each rank runs its own
block as above (so a rank's pallas_traj block is one launch of its own)
and the blocks are gathered in rank order, the whole batch on every rank.
sharded_factored_hprom shards ONE HPROM solve along the sampled cells
instead, a Gram extension summed over the ranks each Gauss-Newton
iteration.
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
from finitedifference_tpu_torch.ops.sampled import SampledMesh
from finitedifference_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    make_mesh,
    world_size,
)
from finitedifference_tpu_torch.rom import (
    ROMResult,
    ecsw_hprom,
    lspg_prom,
    manifold_rom,
)
from finitedifference_tpu_torch.rom_factored import (
    FactoredBlocks,
    factored_hprom,
    precompute_factored_blocks,
    precompute_pallas_system,
    traj_hprom_batch,
)

BATCH_AXIS = "dp"    # the mesh axis the μ batch is sharded over


def make_sweep_mesh(axis_name: str = "dp") -> Mesh:
    """A 1-D mesh of every rank of the world, named `axis_name` (every
    rank calls it)."""
    return make_mesh((world_size(),), (axis_name,))


def _points(mus) -> list[tuple[float, float]]:
    """The (mu1, mu2) rows of a (B, 2) array or tensor, as floats."""
    if isinstance(mus, torch.Tensor):
        mus = mus.detach().cpu().numpy()
    mus = np.asarray(mus, dtype=np.float64)
    if mus.ndim != 2 or mus.shape[1] != 2:
        raise ValueError(f"mus: expected a (B, 2) array, got shape "
                         f"{mus.shape}")
    return [(float(a), float(b)) for a, b in mus]


def _block(points, mesh: Mesh | None):
    """This rank's contiguous block of the batch (all of it without a
    mesh)."""
    if mesh is None:
        return points
    n = mesh.size(BATCH_AXIS)
    if len(points) % n:
        raise ValueError(f"{len(points)} points not divisible by "
                         f"{BATCH_AXIS}={n}: pad them with "
                         f"pad_to_multiple")
    b = len(points) // n
    i = mesh.rank(BATCH_AXIS)
    return points[i * b:(i + 1) * b]


def _gather(out, mesh: Mesh | None):
    """The ranks' blocks of results, in rank order."""
    return out if mesh is None else all_gather(out, mesh, BATCH_AXIS)


def sweep_fom(grid: Grid2D, w0, dt, num_steps, mus, *,
              mesh: Mesh | None = None, engine: str = "standard",
              snaps_dtype=None, **kwargs):
    """FOM trajectories for a (B, 2) array of (mu1, mu2): snaps (B, 2n,
    num_steps+1). engine="skewed" is the skewed-coordinate solver (kwargs
    such as solve_dtype or seg= go to it). `mesh` shards the batch
    (module docstring)."""
    if engine not in ("standard", "skewed"):
        raise ValueError(f"unknown engine {engine!r}; use 'standard' or "
                         f"'skewed'")
    run = inviscid_burgers_implicit2d_skewed if engine == "skewed" \
        else inviscid_burgers_implicit2d
    w0 = as_tensor(w0)
    return _gather(torch.stack([
        run(grid, w0, dt, num_steps, mu1, mu2, snaps_dtype=snaps_dtype,
            **kwargs).snaps
        for mu1, mu2 in _block(_points(mus), mesh)]), mesh)


def sweep_lspg(grid: Grid2D, w0, dt, num_steps, mus, basis, *,
               mesh: Mesh | None = None, **kwargs):
    """LSPG PROM sweep: reduced coordinates (B, k, num_steps+1)."""
    basis = as_tensor(basis)
    return _gather(torch.stack([
        lspg_prom(grid, w0, dt, num_steps, mu1, mu2, basis,
                  **kwargs).red_coords
        for mu1, mu2 in _block(_points(mus), mesh)]), mesh)


def sweep_hprom(grid: Grid2D, smesh, sample_weights, y0, basis_aug, dt,
                num_steps, mus, *, mesh: Mesh | None = None,
                engine: str = "generic", **kwargs):
    """ECSW HPROM sweep: reduced coordinates (B, k, num_steps+1).

    engine "generic" is rom.ecsw_hprom, "factored" the stencil-block
    engine (blocks gathered once), "pallas_traj" the whole-trajectory
    kernel: the padded float32 blocks are built once and all B points (a
    rank's block, with `mesh`) run in one launch (unroll_its, solve_iters,
    relnorm_cutoff and min_delta apply; ls_method does not and is
    dropped, as in the JAX package). `smesh` is the sampled mesh, `mesh`
    the ranks (module docstring).
    """
    points = _block(_points(mus), mesh)
    if engine == "pallas_traj":
        blocks = precompute_factored_blocks(smesh, basis_aug)
        p6p, wgt_p = precompute_pallas_system(blocks, sample_weights)
        kw = {k: v for k, v in kwargs.items() if k != "ls_method"}
        return _gather(traj_hprom_batch(grid, smesh, p6p, wgt_p, y0, dt,
                                        num_steps, points, **kw)[0], mesh)
    if engine == "factored":
        blocks = precompute_factored_blocks(smesh, basis_aug)
        return _gather(torch.stack([factored_hprom(
            grid, smesh, sample_weights, y0, blocks, dt, num_steps, mu1,
            mu2, **kwargs).red_coords for mu1, mu2 in points]), mesh)
    if engine == "generic":
        return _gather(torch.stack([ecsw_hprom(
            grid, smesh, sample_weights, y0, basis_aug, dt, num_steps, mu1,
            mu2, **kwargs).red_coords for mu1, mu2 in points]), mesh)
    raise ValueError(f"unknown engine {engine!r}; use 'generic', "
                     f"'factored' or 'pallas_traj'")


def sweep_manifold(grid: Grid2D, y0, decode, dec_jac, dt, num_steps, mus,
                   *, mesh: Mesh | None = None, smesh=None,
                   sample_weights=None, **kwargs):
    """Nonlinear-manifold ROM sweep (RNM / POD-RBF / POD-GP), full or
    hyper-reduced: one rom.manifold_rom per μ point in turn, reduced
    coordinates (B, k, num_steps+1). smesh and sample_weights are the
    sampled mesh and its ECSW weights (decode/dec_jac then act on the
    augmented sampled rows); `mesh` shards the batch; kwargs go to
    manifold_rom."""
    y0 = as_tensor(y0)
    return _gather(torch.stack([manifold_rom(
        grid, y0, decode, dec_jac, dt, num_steps, mu1, mu2, mesh=smesh,
        sample_weights=sample_weights, **kwargs).red_coords
        for mu1, mu2 in _block(_points(mus), mesh)]), mesh)


def sharded_factored_hprom(grid: Grid2D, smesh, sample_weights, y0,
                           basis_aug, dt, num_steps, mu1, mu2, *,
                           mesh: Mesh, axis_name: str = "sp",
                           **kwargs) -> ROMResult:
    """ONE HPROM solve sharded along the SAMPLED-CELL axis: each rank
    holds a contiguous slice of the factored stencil blocks and weights
    and forms its partial [W JV | W r]^T [W JV | W r]; the Gram extension
    is summed over the ranks each Gauss-Newton iteration
    (rom_factored.factored_hprom's `group`). y0 and the small reduced
    solve are the same on every rank. The cells are padded to a multiple
    of the axis size with zero weights and zero blocks, which add nothing.
    kwargs go to factored_hprom; returns its ROMResult on every rank.
    """
    n = mesh.size(axis_name)
    blocks = precompute_factored_blocks(smesh, basis_aug)
    p6 = blocks.p6
    n_s = p6.shape[1]
    pad = (-n_s) % n
    part = (n_s + pad) // n
    cut = slice(mesh.rank(axis_name) * part,
                (mesh.rank(axis_name) + 1) * part)

    def local(x, value=0):
        x = torch.as_tensor(x, device=p6.device)
        fill = torch.full((pad,) + tuple(x.shape[1:]), value,
                          dtype=x.dtype, device=x.device)
        return torch.cat((x, fill))[cut]

    sm = SampledMesh(
        sample_cells=local(smesh.sample_cells),
        aug_cells=smesh.aug_cells,
        pos_self=local(smesh.pos_self),
        pos_west=local(smesh.pos_west),
        pos_south=local(smesh.pos_south),
        has_west=local(smesh.has_west, False),
        has_south=local(smesh.has_south, False),
        col_x=local(smesh.col_x),
        is_left=local(smesh.is_left, False),
    )
    p6_l = local(p6.transpose(0, 1)).transpose(0, 1)
    return factored_hprom(grid, sm, local(sample_weights), y0,
                          FactoredBlocks(p6=p6_l), dt, num_steps, mu1, mu2,
                          group=mesh.group(axis_name), **kwargs)


def pad_to_multiple(mus, multiple: int):
    """Pad the batch with copies of the last row to a multiple of
    `multiple`. Returns (padded, original_count)."""
    mus = np.asarray(mus)
    b = mus.shape[0]
    rem = (-b) % multiple
    if rem:
        mus = np.vstack([mus, np.repeat(mus[-1:], rem, axis=0)])
    return mus, b
