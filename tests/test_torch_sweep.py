"""The μ sweeps (parallel/sweep.py) against the JAX package on the CPU.

The grids and problems of tests/test_parallel.py and tests/test_skewed.py
go through JAX's vmapped sweeps (no device mesh) and the port's. The
tolerances are those of the JAX tests: FOM rtol 1e-12 (f64), LSPG 1e-11,
generic HPROM 1e-11, factored HPROM 1e-8 (against the generic engine with
normal equations). The whole-trajectory engine in f32: rtol 1e-6 / atol
1e-8 against the port's per-point runs (tests/test_pallas_gn.py's bound
between JAX's vmapped and per-point kernel), and 1e-5 relative over the
trajectory against JAX's Pallas kernel in interpret mode: the two sum
the same f32 products in another order, so entries near zero differ at
~1e-6 absolute (tests/test_torch_traj.py's bound).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from finitedifference_tpu.ecsw import (
    compute_ecsw_weights,
    ecsw_training_matrix,
)
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.parallel import sweep as jsw
from finitedifference_tpu.pod import pod
from finitedifference_tpu.rom import prepare_hprom as jprepare
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch import fom as tfom
from finitedifference_tpu_torch import rom_factored as trf
from finitedifference_tpu_torch.convert import grid_from_jax
from finitedifference_tpu_torch.ops import cuda_gn, cuda_wavefront
from finitedifference_tpu_torch.parallel import sweep as tsw
from finitedifference_tpu_torch.rom import prepare_hprom as tprepare

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

DT = 0.05
F32 = torch.float32


def grids(nx, ny):
    jg = JGrid2D(nx=nx, ny=ny, x_up=100.0, y_up=100.0)
    return jg, grid_from_jax(jg)


@pytest.mark.parametrize("engine,kw", [
    ("standard", {}),
    ("skewed", dict(use_pallas=False)),
], ids=["standard", "skewed"])
def test_sweep_fom_matches_jax(engine, kw):
    jg, tg = grids(8, 8)
    w0 = np.ones(jg.state_dim)
    mus = np.array([[4.25, 0.015], [5.5, 0.03], [4.75, 0.02]])
    want = jsw.sweep_fom(jg, jnp.asarray(w0), DT, 5, mus, engine=engine,
                         **kw)
    got = tsw.sweep_fom(tg, to_torch(w0), DT, 5, mus, engine=engine)
    assert got.shape == (3, jg.state_dim, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)


def test_sweep_fom_seg_reaches_the_segment_solve():
    """engine="skewed" passes seg= on: each point equals its own seg run,
    within 1e-5 of the exact chain; the CPU launches no kernel."""
    jg, tg = grids(8, 8)
    w0 = torch.ones(jg.state_dim, dtype=torch.float64)
    mus = torch.tensor([[4.4, 0.017], [5.1, 0.027]])
    kw = dict(seg=3, seg_overlap=4, block=8, solve_dtype=F32)
    got = tsw.sweep_fom(tg, w0, DT, 4, mus, engine="skewed", **kw)
    exact = tsw.sweep_fom(tg, w0, DT, 4, mus)
    for i, (mu1, mu2) in enumerate(mus.tolist()):
        one = tfom.inviscid_burgers_implicit2d_skewed(tg, w0, DT, 4, mu1,
                                                      mu2, **kw)
        assert torch.equal(got[i], one.snaps)
    err = torch.linalg.norm(got - exact) / torch.linalg.norm(exact)
    assert float(err) < 1e-5
    assert cuda_wavefront.SEG_LAUNCHES == cuda_wavefront.LAUNCHES == 0


def test_sweep_lspg_matches_jax():
    jg, tg = grids(8, 8)
    ops, xc = oracle.make_problem(nx=8, ny=8)
    w0 = np.ones(jg.state_dim)
    s = oracle.implicit_trajectory(w0, [4.25, 0.0225], DT, 10, ops, xc)
    basis = np.asarray(pod(s, num_modes=6, method="svd")[0])
    mus = np.array([[4.5, 0.02], [5.0, 0.028]])
    want = jsw.sweep_lspg(jg, jnp.asarray(w0), DT, 5, mus, basis)
    got = tsw.sweep_lspg(tg, to_torch(w0), DT, 5, mus, to_torch(basis))
    assert got.shape == (2, 6, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11,
                               atol=1e-12)


def test_sweep_manifold_matches_jax():
    """tests/test_parallel.py's manifold sweep: the linear decoder through
    sweep_manifold against JAX's sweep_manifold and, point by point,
    lspg_prom, to 1e-10 (the JAX test's bound)."""
    from finitedifference_tpu.closures.common import (
        manifold_decoder as jdecoder,
    )
    from finitedifference_tpu.rom import lspg_prom as jlspg
    from finitedifference_tpu_torch.closures.common import manifold_decoder

    jg, tg = grids(8, 8)
    ops, xc = oracle.make_problem(nx=8, ny=8)
    w0 = np.ones(jg.state_dim)
    s = oracle.implicit_trajectory(w0, [4.25, 0.0225], DT, 10, ops, xc)
    basis = np.asarray(pod(s, num_modes=5, method="svd")[0])
    mus = np.array([[4.5, 0.02], [5.0, 0.028]])
    y0 = basis.T @ w0
    want = jsw.sweep_manifold(jg, jnp.asarray(y0),
                              *jdecoder(basis, None, None), DT, 6, mus)
    got = tsw.sweep_manifold(tg, to_torch(y0),
                             *manifold_decoder(to_torch(basis), None, None),
                             DT, 6, mus)
    assert got.shape == (2, 5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-11)
    for i in range(2):
        lone = jlspg(jg, jnp.asarray(w0), DT, 6, mus[i, 0], mus[i, 1],
                     jnp.asarray(basis)).red_coords
        np.testing.assert_allclose(got[i].numpy(), np.asarray(lone),
                                   rtol=1e-10, atol=1e-11)


@pytest.fixture(scope="module")
def hprom_problem():
    """tests/test_parallel.py's 10x8 HPROM: a 6-mode basis and NNLS
    weights from the oracle trajectory at (4.25, 0.0225)."""
    jg, tg = grids(10, 8)
    ops, xc = oracle.make_problem(nx=10, ny=8)
    w0 = np.ones(jg.state_dim)
    s = oracle.implicit_trajectory(w0, [4.25, 0.0225], DT, 15, ops, xc)
    basis = np.asarray(pod(s, num_modes=6, method="svd")[0])
    c = np.asarray(ecsw_training_matrix(
        jg, jnp.asarray(s[:, 1:15:3]), jnp.asarray(s[:, 0:14:3]),
        jnp.asarray(basis), 4.25, 0.0225, DT))
    weights = compute_ecsw_weights(c, jg, bc_w=5.0, method="nnls",
                                   rel_err_thresh=1e-4)
    jmesh, jsw_, jba = jprepare(jg, weights, basis)
    tmesh, tsw_, tba = tprepare(tg, weights, to_torch(basis))
    mus = np.array([[4.5, 0.02], [5.0, 0.028], [5.19, 0.026]])
    return dict(jg=jg, tg=tg, y0=basis.T @ w0, jmesh=jmesh, jsw=jsw_,
                jba=jba, tmesh=tmesh, tsw=tsw_, tba=tba, mus=mus)


@pytest.mark.parametrize("engine,kw,tol", [
    ("generic", {}, 1e-11),
    ("generic", dict(ls_method="normal"), 1e-11),
    ("factored", dict(ls_method="normal"), 1e-8),
], ids=["generic", "generic_normal", "factored"])
def test_sweep_hprom_matches_jax(hprom_problem, engine, kw, tol):
    """Each engine against JAX's sweep of the same engine, and the
    factored engine against the generic one (as tests/test_parallel.py)."""
    p = hprom_problem
    want = jsw.sweep_hprom(p["jg"], p["jmesh"], p["jsw"],
                           jnp.asarray(p["y0"]), p["jba"], DT, 8, p["mus"],
                           engine=engine, **kw)
    got = tsw.sweep_hprom(p["tg"], p["tmesh"], p["tsw"], to_torch(p["y0"]),
                          p["tba"], DT, 8, p["mus"], engine=engine, **kw)
    assert got.shape == (3, 6, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol / 10)
    if engine == "factored":
        ref = tsw.sweep_hprom(p["tg"], p["tmesh"], p["tsw"],
                              to_torch(p["y0"]), p["tba"], DT, 8, p["mus"],
                              ls_method="normal")
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-8,
                                   atol=1e-10)


def test_sweep_manifold_hyper_reduced_matches_jax(hprom_problem):
    """sweep_manifold on the sampled mesh (smesh and sample_weights passed
    through) with the linear decoder on the augmented sampled rows,
    against JAX's, to 1e-10."""
    from finitedifference_tpu.closures.common import (
        manifold_decoder as jdecoder,
    )
    from finitedifference_tpu_torch.closures.common import manifold_decoder

    p = hprom_problem
    want = jsw.sweep_manifold(p["jg"], jnp.asarray(p["y0"]),
                              *jdecoder(p["jba"], None, None), DT, 6,
                              p["mus"], smesh=p["jmesh"],
                              sample_weights=p["jsw"])
    got = tsw.sweep_manifold(p["tg"], to_torch(p["y0"]),
                             *manifold_decoder(p["tba"], None, None), DT, 6,
                             p["mus"], smesh=p["tmesh"],
                             sample_weights=p["tsw"])
    assert got.shape == (3, 6, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-11)


def test_sweep_pallas_traj_matches_jax_and_points():
    """Two μ points through the whole-trajectory engine: JAX's vmapped
    Pallas kernel (interpret) and the port's per-point runs (the mesh of
    tests/test_pallas_gn.py's trajectory sweep)."""
    from tests.test_rom import setup_problem

    jg, _, _, w0, basis = setup_problem(num_steps=12)
    tg = grid_from_jax(jg)
    rng = np.random.default_rng(7)
    weights = np.zeros(jg.n_cells)
    chosen = rng.choice(jg.n_cells, size=40, replace=False)
    weights[chosen] = 1.0 + rng.uniform(size=40)
    jmesh, jsw_, jba = jprepare(jg, weights, basis)
    tmesh, tsw_, tba = tprepare(tg, weights, to_torch(basis))
    y0 = (basis.T @ w0).astype(np.float32)
    mus = np.array([[4.5, 0.018], [5.0, 0.025]], np.float32)
    want = jsw.sweep_hprom(jg, jmesh, jsw_.astype(jnp.float32),
                           jnp.asarray(y0), jnp.asarray(jba, jnp.float32),
                           DT, 8, jnp.asarray(mus), engine="pallas_traj",
                           unroll_its=3, interpret=True)
    before = cuda_gn.TRAJ_LAUNCHES
    got = tsw.sweep_hprom(tg, tmesh, tsw_.to(F32), to_torch(y0),
                          tba.to(F32), DT, 8, mus, engine="pallas_traj",
                          unroll_its=3, ls_method="normal")
    assert cuda_gn.TRAJ_LAUNCHES == before
    assert got.shape == (2, y0.shape[0], 9) and got.dtype == F32
    for g, w in zip(got.numpy(), np.asarray(want)):
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-5
    blocks = trf.precompute_factored_blocks(tmesh, tba.to(F32))
    p6p, wgt_p = trf.precompute_pallas_system(blocks, tsw_.to(F32))
    for i, (mu1, mu2) in enumerate(mus.tolist()):
        one = trf.pallas_traj_hprom(tg, tmesh, p6p, wgt_p, to_torch(y0), DT,
                                    8, mu1, mu2, unroll_its=3)
        np.testing.assert_allclose(got[i].numpy(), one.red_coords.numpy(),
                                   rtol=1e-6, atol=1e-8)


def test_pad_to_multiple_matches_jax():
    mus = np.array([[4.25, 0.015], [5.5, 0.03], [4.75, 0.02]])
    for m in (1, 2, 3, 8):
        got, b = tsw.pad_to_multiple(mus, m)
        want, jb = jsw.pad_to_multiple(mus, m)
        np.testing.assert_array_equal(got, want)
        assert b == jb == 3 and got.shape[0] % m == 0


def test_unknown_engines_and_bad_mus_raise():
    _, tg = grids(8, 8)
    w0 = torch.ones(tg.state_dim, dtype=torch.float64)
    with pytest.raises(ValueError, match="engine"):
        tsw.sweep_fom(tg, w0, DT, 1, [[4.5, 0.02]], engine="pallas")
    with pytest.raises(ValueError, match="engine"):
        tsw.sweep_hprom(tg, None, None, None, None, DT, 1, [[4.5, 0.02]],
                        engine="tensor")
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        tsw.sweep_fom(tg, w0, DT, 1, [4.5, 0.02])
