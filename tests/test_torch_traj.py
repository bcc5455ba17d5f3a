"""The whole-trajectory HPROM engine (B6) against the JAX package on the
CPU.

The port's plain version (ops/gn.trajectory_hprom_ref: what a CPU tensor
runs) is held against JAX's Pallas trajectory kernel in interpret mode on
the same padded inputs, and pallas_traj_hprom against JAX's and against
the port's factored_hprom with the same unrolled Gauss-Newton and CG.
Tolerances: f32 trajectories rel 1e-5 at kp 128 (both sum the same f32
products in another order; the JAX package's own bound) and 1e-4 at kp
256 (k = 150: the JAX test's bound against the generic engine); equal
Gauss-Newton counts.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from finitedifference_tpu import rom_factored as jrf
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import pallas_gn as jgn
from finitedifference_tpu.ops import sampled as jsm
from finitedifference_tpu.rom import prepare_hprom as jprepare
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch import rom_factored as trf
from finitedifference_tpu_torch.ops import cuda_gn
from finitedifference_tpu_torch.ops import gn as tgn
from tests.test_rom import DT, MU
from tests.test_torch_gn import (  # noqa: F401 (mesh_problem: a fixture)
    TILE,
    mesh_problem,
    padded_pair,
    rel,
)

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

F32 = torch.float32


def jax_slbc(jg, jmesh, n_p, mu):
    """The padded source + inflow column of JAX's pallas_traj_hprom."""
    s = jsm.sampled_source(jmesh, jg, mu[1], DT, jnp.float32) \
        + jsm.sampled_inflow_bc(jmesh, jg, mu[0], DT, jnp.float32)
    return np.pad(np.asarray(s), (0, n_p - jmesh.n_sample))[:, None]


def kernel_pair(jg, jmesh, jp6p, jwgt, y0, k, steps, **kw):
    """JAX's Pallas trajectory kernel (interpret) and the port's plain
    version on the same inputs."""
    n_p = jp6p.shape[1]
    slbc = jax_slbc(jg, jmesh, n_p, MU)
    hdx, hdy = 0.5 * DT / jg.dx, 0.5 * DT / jg.dy
    want = jgn.trajectory_hprom_pallas(
        jp6p, jnp.asarray(y0), jnp.asarray(slbc), jwgt, k, hdx, hdy, steps,
        interpret=True, **kw)
    got = tgn.trajectory_hprom(to_torch(jp6p), to_torch(y0),
                               to_torch(slbc), to_torch(jwgt), k, hdx, hdy,
                               steps, **kw)
    return want, got


def test_traj_ref_matches_pallas_kernel(mesh_problem):
    p = mesh_problem
    jp6p, jwgt, tp6p, twgt = padded_pair(p)
    k = p["basis"].shape[1]
    y0 = np.asarray(p["y0"], np.float32)
    before = cuda_gn.TRAJ_LAUNCHES
    (jys, jits), got = kernel_pair(p["jg"], p["jmesh"], jp6p, jwgt, y0, k,
                                   12, unroll_its=3)
    assert cuda_gn.TRAJ_LAUNCHES == before
    assert got.ys.shape == (12, k) and got.ys.dtype == F32
    assert rel(got.ys.numpy(), jys) <= 1e-5
    assert int(got.its) == int(jits)
    assert int(got.its) <= int(got.evals) <= 3 * 12


def test_traj_ref_k150_two_lane_tiles():
    """k = 150 pads the mode axis to kp = 256 (the 150-mode campaign):
    the grid, mesh and basis of tests/test_pallas_gn.py's k = 150 case."""
    grid = JGrid2D(nx=24, ny=24, x_up=100.0, y_up=100.0)
    k, steps = 150, 6
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.normal(size=(grid.state_dim, k)))
    weights = np.zeros(grid.n_cells)
    chosen = rng.choice(grid.n_cells, size=220, replace=False)
    weights[chosen] = 1.0 + rng.uniform(size=220)
    jmesh, jsw, jba = jprepare(grid, weights, q)
    jb = jrf.precompute_factored_blocks(jmesh, jnp.asarray(jba, jnp.float32))
    jp6p, jwgt = jrf.precompute_pallas_system(jb, jsw.astype(jnp.float32),
                                              tile=TILE)
    assert jp6p.shape[2] == 256
    y0 = (q.T @ np.ones(grid.state_dim)).astype(np.float32)
    (jys, jits), got = kernel_pair(grid, jmesh, jp6p, jwgt, y0, k, steps,
                                   unroll_its=3)
    assert rel(got.ys.numpy(), jys) <= 1e-4
    assert int(got.its) == int(jits)


def test_pallas_traj_hprom_matches_jax_and_factored(mesh_problem):
    """The engine against JAX's pallas_traj_hprom (interpret) and the
    port's own factored_hprom with 3 unrolled iterations and CG."""
    p = mesh_problem
    steps = 12
    jp6p, jwgt, tp6p, twgt = padded_pair(p)
    y0 = np.asarray(p["y0"], np.float32)
    want = jrf.pallas_traj_hprom(p["jg"], p["jmesh"], jp6p, jwgt,
                                 jnp.asarray(y0), DT, steps, MU[0], MU[1],
                                 unroll_its=3, interpret=True)
    got = trf.pallas_traj_hprom(p["tg"], p["tmesh"], tp6p, twgt,
                                to_torch(y0), DT, steps, MU[0], MU[1],
                                unroll_its=3)
    tb = trf.precompute_factored_blocks(p["tmesh"], p["tba"].to(F32))
    own = trf.factored_hprom(p["tg"], p["tmesh"], p["tsw"].to(F32),
                             to_torch(y0), tb, DT, steps, MU[0], MU[1],
                             unroll_its=3, ls_method="cg")
    assert got.red_coords.shape == (y0.shape[0], steps + 1)
    assert got.gn_evals == 1
    assert rel(got.red_coords.numpy(), want.red_coords) < 1e-5
    assert rel(got.red_coords.numpy(), own.red_coords.numpy()) < 1e-5
    assert got.total_gn_its == int(want.total_gn_its) == own.total_gn_its


def test_traj_batch_equals_single_points(mesh_problem):
    """Two μ points in one batched call give each point's own run."""
    p = mesh_problem
    _, _, tp6p, twgt = padded_pair(p)
    y0 = to_torch(np.asarray(p["y0"], np.float32))
    mus = [(4.5, 0.018), (5.0, 0.025)]
    red, its = trf.traj_hprom_batch(p["tg"], p["tmesh"], tp6p, twgt, y0, DT,
                                    8, mus, unroll_its=3)
    assert red.shape == (2, y0.shape[0], 9)
    for i, (mu1, mu2) in enumerate(mus):
        one = trf.pallas_traj_hprom(p["tg"], p["tmesh"], tp6p, twgt, y0,
                                    DT, 8, mu1, mu2, unroll_its=3)
        np.testing.assert_allclose(red[i].numpy(), one.red_coords.numpy(),
                                   rtol=1e-6, atol=1e-8)
        assert int(its[i]) == one.total_gn_its


def test_traj_engine_f64_matches_factored(mesh_problem):
    """In f64 the engine is factored_hprom(unroll_its=3, ls_method="cg")
    within 1e-10, equal counts."""
    p = mesh_problem
    steps = 12
    _, _, tp6p, twgt = padded_pair(p, dtype=torch.float64)
    got = trf.pallas_traj_hprom(p["tg"], p["tmesh"], tp6p, twgt,
                                to_torch(p["y0"]), DT, steps, MU[0], MU[1])
    tb = trf.precompute_factored_blocks(p["tmesh"], p["tba"])
    own = trf.factored_hprom(p["tg"], p["tmesh"], p["tsw"],
                             to_torch(p["y0"]), tb, DT, steps, MU[0], MU[1],
                             unroll_its=3, ls_method="cg")
    assert got.red_coords.dtype == torch.float64
    assert rel(got.red_coords.numpy(), own.red_coords.numpy()) < 1e-10
    assert got.total_gn_its == own.total_gn_its


def test_traj_source_from_jax_mesh(mesh_problem):
    """A JAX mesh carried across builds the same μ input column."""
    p = mesh_problem
    n_p = 48
    t = trf.traj_source(p["tg"], convert.mesh_from_jax(p["jmesh"], "cpu"),
                        DT, MU[0], MU[1], n_p, F32)
    np.testing.assert_allclose(t.numpy(), jax_slbc(p["jg"], p["jmesh"],
                                                   n_p, MU), rtol=1e-6)
