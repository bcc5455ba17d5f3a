"""The sampled-mesh Gauss-Newton system (B4), the fused step (B5) and the
factored HPROM engines against the JAX package on the CPU.

The port's plain versions (ops/gn.gn_system_ref, gn_step_ref: what a CPU
tensor runs) are held against JAX's Pallas kernels in interpret mode on
the same padded inputs with tile = 8 (several tiles); the engines
factored_hprom and pallas_hprom (normal, cg, fused) against their JAX
twins with equal Gauss-Newton counts. Tolerances: f32 Grams rtol 2e-4 /
atol 3e-4, f32 trajectories rtol 5e-4 / atol 5e-6, f64 1e-12 relative.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu import rom_factored as jrf
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import pallas_gn as jgn
from finitedifference_tpu.rom import ecsw_hprom as jecsw
from finitedifference_tpu.rom import prepare_hprom as jprepare
from finitedifference_tpu_torch import rom_factored as trf
from finitedifference_tpu_torch.convert import (
    blocks_from_jax,
    grid_from_jax,
    mesh_from_jax,
)
from finitedifference_tpu_torch.ops import gn as tgn
from finitedifference_tpu_torch.rom import ecsw_hprom as tecsw
from finitedifference_tpu_torch.rom import prepare_hprom as tprepare
from tests.test_rom import DT, MU, setup_problem
from finitedifference_tpu_torch import convert

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

F32, F64 = torch.float32, torch.float64
TILE = 8


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) \
        / np.linalg.norm(np.asarray(b))


@pytest.fixture(scope="module")
def mesh_problem():
    grid, _, _, w0, basis = setup_problem(num_steps=12)
    rng = np.random.default_rng(7)
    weights = np.zeros(grid.n_cells)
    chosen = rng.choice(grid.n_cells, size=40, replace=False)
    weights[chosen] = 1.0 + rng.uniform(size=40)
    jmesh, jsw, jba = jprepare(grid, weights, basis)
    tg = grid_from_jax(grid)
    tmesh, tsw, tba = tprepare(tg, weights, to_torch(basis))
    return dict(jg=grid, tg=tg, basis=basis, y0=basis.T @ w0,
                jmesh=jmesh, jsw=jsw, jba=jba, tmesh=tmesh, tsw=tsw,
                tba=tba)


def padded_pair(p, dtype=F32):
    jb = jrf.precompute_factored_blocks(p["jmesh"],
                                        jnp.asarray(p["jba"], jnp.float32))
    jp6p, jwgt = jrf.precompute_pallas_system(jb, p["jsw"].astype(
        jnp.float32), tile=TILE)
    tb = trf.precompute_factored_blocks(p["tmesh"], p["tba"])
    tp6p, twgt = trf.precompute_pallas_system(tb, p["tsw"], tile=TILE,
                                              dtype=dtype)
    return jp6p, jwgt, tp6p, twgt


def test_blocks_and_padding_match_jax(mesh_problem):
    p = mesh_problem
    jb = jrf.precompute_factored_blocks(p["jmesh"], jnp.asarray(p["jba"]))
    tb = trf.precompute_factored_blocks(p["tmesh"], p["tba"])
    np.testing.assert_array_equal(tb.p6.numpy(), np.asarray(jb.p6))
    np.testing.assert_array_equal(blocks_from_jax(jb, device="cpu").p6.numpy(),
                                  tb.p6.numpy())
    jp6p, jwgt, tp6p, twgt = padded_pair(p)
    assert tp6p.shape[1] // TILE >= 5       # several tiles
    np.testing.assert_array_equal(tp6p.numpy(), np.asarray(jp6p))
    np.testing.assert_array_equal(twgt.numpy(), np.asarray(jwgt))


def system_inputs(p, n_p, kp, seed):
    k = p["basis"].shape[1]
    rng = np.random.default_rng(seed)
    y = (np.asarray(p["y0"], np.float32)
         + 0.01 * rng.normal(size=k).astype(np.float32))
    cp = (0.01 * rng.normal(size=(n_p, 2))).astype(np.float32)
    hdx = 0.5 * DT / p["jg"].dx
    hdy = 0.5 * DT / p["jg"].dy
    return k, y, cp, hdx, hdy


def test_gn_system_ref_matches_pallas_kernel(mesh_problem):
    p = mesh_problem
    jp6p, jwgt, tp6p, twgt = padded_pair(p)
    k, y, cp, hdx, hdy = system_inputs(p, tp6p.shape[1], tp6p.shape[2], 3)
    want = jgn.gn_system_pallas(jp6p, jnp.asarray(y), jnp.asarray(cp), jwgt,
                                k, hdx, hdy, tile=TILE, interpret=True)
    got = tgn.gn_system(tp6p, to_torch(y), to_torch(cp), twgt, k, hdx, hdy,
                        tile=TILE)
    assert got.dtype == F32 and got.shape == (128, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=3e-4)
    np.testing.assert_allclose(float(got[k, k]), float(want[k, k]),
                               rtol=1e-4)


def test_gn_step_ref_matches_pallas_kernel(mesh_problem):
    """The fused step: dy at CG accuracy and ||W r|| against JAX's
    in-VMEM CG epilogue."""
    p = mesh_problem
    jp6p, jwgt, tp6p, twgt = padded_pair(p)
    k, y, cp, hdx, hdy = system_inputs(p, tp6p.shape[1], tp6p.shape[2], 5)
    jdy, jrn = jgn.gn_step_pallas(jp6p, jnp.asarray(y), jnp.asarray(cp),
                                  jwgt, k, hdx, hdy, tile=TILE,
                                  interpret=True)
    tdy, trn = tgn.gn_step(tp6p, to_torch(y), to_torch(cp), twgt, k, hdx,
                           hdy, tile=TILE)
    assert tdy.shape == (k,) and trn.dim() == 0
    np.testing.assert_allclose(float(trn), float(jrn), rtol=1e-5)
    scale = np.abs(np.asarray(jdy)).max()
    np.testing.assert_allclose(tdy.numpy(), np.asarray(jdy), rtol=1e-3,
                               atol=1e-4 * scale)


def test_gn_system_f64_matches_sampled_ops(mesh_problem):
    """In f64 the system equals the brute-force normal equations from the
    port's sampled residual and J V (no JAX kernel runs f64)."""
    from finitedifference_tpu_torch.ops.sampled import (
        sampled_jacobian_times_basis,
        sampled_residual,
    )
    p = mesh_problem
    _, _, tp6p, twgt = padded_pair(p, dtype=F64)
    k = p["basis"].shape[1]
    n_s, n_p = p["tmesh"].n_sample, tp6p.shape[1]
    tg, mesh, ba = p["tg"], p["tmesh"], p["tba"]
    rng = np.random.default_rng(11)
    yp = to_torch(p["y0"])
    y = yp + 0.01 * to_torch(rng.normal(size=k))
    w, wp = ba @ y, ba @ yp
    # cp from the previous state: r(w; wp) = current half + cp
    r_wp = sampled_residual(wp, wp, MU[0], MU[1], DT, tg, mesh)
    r_w = sampled_residual(w, wp, MU[0], MU[1], DT, tg, mesh)
    s6 = (tp6p[:, :n_s, :k] @ y)                       # (6, n_s)
    hdx, hdy = 0.5 * DT / tg.dx, 0.5 * DT / tg.dy
    fl = trf._HalfFlux(hdx, hdy, 0.0)
    cu, cv = fl.residual(s6, 0.0, 0.0)
    cp = torch.zeros((n_p, 2), dtype=F64)
    cp[:n_s, 0] = r_w[:n_s] - cu
    cp[:n_s, 1] = r_w[n_s:] - cv
    jv = sampled_jacobian_times_basis(w, ba, DT, tg, mesh)
    w2 = torch.cat((p["tsw"], p["tsw"]))
    a = torch.cat((w2[:, None] * jv, (w2 * r_w)[:, None]), dim=1)
    ref = a.T @ a
    got = tgn.gn_system(tp6p, y, cp, twgt, k, hdx, hdy, tile=TILE)
    assert got.dtype == F64
    assert rel(got[:k + 1, :k + 1].numpy(), ref.numpy()) < 1e-12
    assert torch.all(got[k + 1:] == 0)
    assert r_wp.shape == r_w.shape


@pytest.mark.parametrize("kw", [
    dict(ls_method="normal"),
    dict(ls_method="cg"),
    dict(ls_method="normal", unroll_its=3),
    dict(ls_method="cg", unroll_its=3),
], ids=["normal", "cg", "unroll3", "unroll3_cg"])
def test_factored_hprom_matches_jax(mesh_problem, kw):
    """The plain factored engine in f64: JAX's factored_hprom within
    1e-12 relative, equal counts."""
    p = mesh_problem
    steps = 12
    jb = jrf.precompute_factored_blocks(p["jmesh"], jnp.asarray(p["jba"]))
    want = jrf.factored_hprom(p["jg"], p["jmesh"], p["jsw"],
                              jnp.asarray(p["y0"]), jb, DT, steps, MU[0],
                              MU[1], **kw)
    tb = trf.precompute_factored_blocks(p["tmesh"], p["tba"])
    got = trf.factored_hprom(p["tg"], p["tmesh"], p["tsw"],
                             to_torch(p["y0"]), tb, DT, steps, MU[0], MU[1],
                             **kw)
    assert rel(got.red_coords.numpy(), want.red_coords) < 1e-12
    assert got.total_gn_its == int(want.total_gn_its)


@pytest.mark.parametrize("kw", [
    dict(ls_method="normal"),
    dict(ls_method="cg", unroll_its=3),
    dict(ls_method="fused", unroll_its=3),
    dict(ls_method="fused"),
], ids=["normal", "unroll3_cg", "unroll3_fused", "fused"])
def test_pallas_hprom_matches_jax(mesh_problem, kw):
    """The kernel engine at f32 against JAX's pallas_hprom(interpret):
    trajectory within rtol 5e-4 / atol 5e-6 and equal counts."""
    p = mesh_problem
    steps = 12
    jp6p, jwgt, tp6p, twgt = padded_pair(p)
    y0 = np.asarray(p["y0"], np.float32)
    want = jrf.pallas_hprom(p["jg"], p["jmesh"], jp6p, jwgt,
                            jnp.asarray(y0), DT, steps, MU[0], MU[1],
                            tile=TILE, interpret=True, **kw)
    got = trf.pallas_hprom(p["tg"], p["tmesh"], tp6p, twgt, to_torch(y0),
                           DT, steps, MU[0], MU[1], tile=TILE, **kw)
    assert got.red_coords.dtype == F32
    np.testing.assert_allclose(got.red_coords.numpy(),
                               np.asarray(want.red_coords), rtol=5e-4,
                               atol=5e-6)
    assert got.total_gn_its == int(want.total_gn_its)
    if "unroll_its" in kw:
        assert got.gn_evals == kw["unroll_its"] * steps
    else:
        assert got.total_gn_its <= got.gn_evals <= got.total_gn_its + steps


def test_pallas_hprom_f64_matches_generic(mesh_problem):
    """In f64 the kernel engine is the generic ecsw_hprom with normal
    equations: within 1e-12, equal counts (JAX's f64 ecsw_hprom too)."""
    p = mesh_problem
    steps = 12
    _, _, tp6p, twgt = padded_pair(p, dtype=F64)
    got = trf.pallas_hprom(p["tg"], p["tmesh"], tp6p, twgt,
                           to_torch(p["y0"]), DT, steps, MU[0], MU[1],
                           tile=TILE)
    want = jecsw(p["jg"], p["jmesh"], p["jsw"], jnp.asarray(p["y0"]),
                 jnp.asarray(p["jba"]), DT, steps, MU[0], MU[1],
                 ls_method="normal")
    own = tecsw(p["tg"], p["tmesh"], p["tsw"], to_torch(p["y0"]), p["tba"],
                DT, steps, MU[0], MU[1], ls_method="normal")
    assert rel(got.red_coords.numpy(), want.red_coords) < 1e-12
    assert got.total_gn_its == int(want.total_gn_its) == own.total_gn_its


def test_mesh_from_jax_round_trip(mesh_problem):
    """A JAX SampledMesh carried across equals the port's own build."""
    p = mesh_problem
    m = mesh_from_jax(p["jmesh"], device="cpu")
    for f in m._fields:
        a, b = getattr(m, f), getattr(p["tmesh"], f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert m.n_sample == p["jmesh"].n_sample and m.n_aug == p["jmesh"].n_aug


def test_system_k150_two_lane_tiles():
    """k = 150 pads the mode axis to kp = 256 (the 150-mode fine
    campaign): the plain system against the JAX kernel."""
    grid = JGrid2D(nx=16, ny=16, x_up=100.0, y_up=100.0)
    k = 150
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.normal(size=(grid.state_dim, k)))
    weights = np.zeros(grid.n_cells)
    chosen = rng.choice(grid.n_cells, size=120, replace=False)
    weights[chosen] = 1.0 + rng.uniform(size=120)
    jmesh, jsw, jba = jprepare(grid, weights, q)
    jb = jrf.precompute_factored_blocks(jmesh, jnp.asarray(jba, jnp.float32))
    jp6p, jwgt = jrf.precompute_pallas_system(jb, jsw.astype(jnp.float32),
                                              tile=TILE)
    tp6p, twgt = to_torch(jp6p), to_torch(jwgt)
    assert tp6p.shape[2] == 256
    y = (q.T @ np.ones(grid.state_dim)).astype(np.float32)
    cp = (0.01 * rng.normal(size=(tp6p.shape[1], 2))).astype(np.float32)
    hdx, hdy = 0.5 * DT / grid.dx, 0.5 * DT / grid.dy
    want = jgn.gn_system_pallas(jp6p, jnp.asarray(y), jnp.asarray(cp), jwgt,
                                k, hdx, hdy, tile=TILE, interpret=True)
    got = tgn.gn_system(tp6p, to_torch(y), to_torch(cp), twgt, k, hdx, hdy,
                        tile=TILE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=3e-4)
