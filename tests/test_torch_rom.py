"""The LSPG PROM, the ECSW HPROM, the sampled-mesh operators, the
snapshot cache and convert.py against the JAX package on the CPU.

Same numpy inputs (the 12x10 problem of tests/test_rom.py: a POD basis
from two oracle trajectories) go through both packages. Tolerances: f64
1e-12 relative; Gauss-Newton iteration counts equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu import rom as jrom
from finitedifference_tpu import snapshots as jsnap
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import sampled as jsm
from finitedifference_tpu.rom_factored import precompute_prom_pallas
from finitedifference_tpu_torch import rom as trom
from finitedifference_tpu_torch import snapshots as tsnap
from finitedifference_tpu_torch.convert import (
    grid_from_jax,
    mesh_from_jax,
    result_to_numpy,
    rom_result_from_jax,
)
from finitedifference_tpu_torch.ops import sampled as tsm
from finitedifference_tpu_torch.rom_factored import (
    precompute_prom_pallas as tprecompute,
)
from tests.test_rom import DT, MU, setup_problem
from finitedifference_tpu_torch import convert

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

F64 = torch.float64


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def problem():
    grid, ops, xc, w0, basis = setup_problem(k=8)
    return grid, grid_from_jax(grid), w0, basis


@pytest.fixture(scope="module")
def mesh_problem(problem):
    jg, tg, w0, basis = problem
    rng = np.random.default_rng(7)
    weights = np.zeros(jg.n_cells)
    chosen = rng.choice(jg.n_cells, size=40, replace=False)
    weights[chosen] = 1.0 + rng.uniform(size=40)
    jmesh, jsw, jba = jrom.prepare_hprom(jg, weights, basis)
    tmesh, tsw, tba = trom.prepare_hprom(tg, weights, to_torch(basis))
    return weights, jmesh, jsw, jba, tmesh, tsw, tba


@pytest.mark.parametrize("kw", [dict(), dict(ls_method="normal"),
                                dict(ls_method="cg"), dict(ls_method="svd"),
                                dict(extrapolate_guess=True)],
                         ids=["qr", "normal", "cg", "svd", "extrapolate"])
def test_lspg_prom_matches_jax(problem, kw):
    jg, tg, w0, basis = problem
    steps = 15
    want = jrom.lspg_prom(jg, jnp.asarray(w0), DT, steps, MU[0], MU[1],
                          jnp.asarray(basis), **kw)
    got = trom.lspg_prom(tg, to_torch(w0), DT, steps, MU[0], MU[1],
                         to_torch(basis), **kw)
    assert got.red_coords.shape == (basis.shape[1], steps + 1)
    assert rel(got.red_coords.numpy(), want.red_coords) < 1e-12
    assert got.total_gn_its == int(want.total_gn_its)


def test_lspg_prom_mixed_precision_solve(problem):
    """ls_dtype=float32: the solve in f32, residuals and stopping in f64,
    as in the JAX package; the counts stay equal."""
    jg, tg, w0, basis = problem
    want = jrom.lspg_prom(jg, jnp.asarray(w0), DT, 10, MU[0], MU[1],
                          jnp.asarray(basis), ls_dtype=jnp.float32)
    got = trom.lspg_prom(tg, to_torch(w0), DT, 10, MU[0], MU[1],
                         to_torch(basis), ls_dtype=torch.float32)
    assert got.red_coords.dtype == F64
    assert rel(got.red_coords.numpy(), want.red_coords) < 1e-5
    assert got.total_gn_its == int(want.total_gn_its)


def test_reconstruct_matches_jax(problem):
    jg, tg, w0, basis = problem
    res = trom.lspg_prom(tg, to_torch(w0), DT, 5, MU[0], MU[1],
                         to_torch(basis))
    got = trom.reconstruct(to_torch(basis), res.red_coords)
    want = jrom.reconstruct(basis, res.red_coords.numpy())
    assert got.shape == (jg.state_dim, 6)
    assert rel(got.numpy(), want) < 1e-14


@pytest.mark.parametrize("ls_method", ["qr", "normal", "cg"])
def test_ecsw_hprom_matches_jax(problem, mesh_problem, ls_method):
    jg, tg, w0, basis = problem
    _, jmesh, jsw, jba, tmesh, tsw, tba = mesh_problem
    steps = 15
    y0 = basis.T @ w0
    want = jrom.ecsw_hprom(jg, jmesh, jsw, jnp.asarray(y0), jnp.asarray(jba),
                           DT, steps, MU[0], MU[1], ls_method=ls_method)
    got = trom.ecsw_hprom(tg, tmesh, tsw, to_torch(y0), tba, DT, steps,
                          MU[0], MU[1], ls_method=ls_method)
    assert rel(got.red_coords.numpy(), want.red_coords) < 1e-12
    assert got.total_gn_its == int(want.total_gn_its)


def test_prepare_hprom_matches_jax(mesh_problem):
    weights, jmesh, jsw, jba, tmesh, tsw, tba = mesh_problem
    carried = mesh_from_jax(jmesh, device="cpu")
    for f in tmesh._fields:
        a, b = getattr(tmesh, f), getattr(carried, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    np.testing.assert_array_equal(tba.numpy(), np.asarray(jba))
    assert tmesh.n_sample == int((weights != 0).sum())


def test_all_cells_sampled_equals_lspg():
    """Unit weights on every cell: the HPROM is the PROM (the JAX
    package's own check, tests/test_ecsw.py), here within the port."""
    jg, _, _, w0, basis = setup_problem(nx=8, ny=8)
    tg = grid_from_jax(jg)
    mesh, sw, ba = trom.prepare_hprom(tg, np.ones(tg.n_cells),
                                      to_torch(basis))
    y0 = to_torch(basis.T @ w0)
    hprom = trom.ecsw_hprom(tg, mesh, sw, y0, ba, DT, 10, MU[0], MU[1])
    prom = trom.lspg_prom(tg, to_torch(w0), DT, 10, MU[0], MU[1],
                          to_torch(basis))
    np.testing.assert_allclose(hprom.red_coords.numpy(),
                               prom.red_coords.numpy(), rtol=1e-9,
                               atol=1e-11)
    assert hprom.total_gn_its == prom.total_gn_its


# ----------------------------------------------------------------------
# the sampled-mesh operators
# ----------------------------------------------------------------------

def sample_cells(grid, seed=0, frac=0.3):
    rng = np.random.default_rng(seed)
    n = grid.n_cells
    inds = rng.choice(n, size=max(4, int(frac * n)), replace=False)
    # corner cells exercise the boundary branches
    return np.unique(np.concatenate([inds, [0, grid.nx - 1, n - grid.nx,
                                            n - 1]]))


def test_augmented_mesh_and_indices_match_jax(problem):
    jg, tg, _, _ = problem
    sample = sample_cells(jg)
    np.testing.assert_array_equal(tsm.generate_augmented_mesh(tg, sample),
                                  jsm.generate_augmented_mesh(jg, sample))
    tmesh = tsm.build_sampled_mesh(tg, sample, device="cpu")
    jmesh = jsm.build_sampled_mesh(jg, sample)
    for f in tmesh._fields:
        np.testing.assert_array_equal(getattr(tmesh, f).numpy(),
                                      np.asarray(getattr(jmesh, f)), f)
    np.testing.assert_array_equal(
        tsm.augmented_state_indices(tmesh, tg.n_cells).numpy(),
        np.asarray(jsm.augmented_state_indices(jmesh, jg.n_cells)))


@pytest.mark.parametrize("seed", [0, 2])
def test_sampled_residual_and_jv_match_jax(problem, seed):
    jg, tg, _, basis = problem
    sample = sample_cells(jg, seed)
    tmesh = tsm.build_sampled_mesh(tg, sample, device="cpu")
    jmesh = jsm.build_sampled_mesh(jg, sample)
    idx = tsm.augmented_state_indices(tmesh, tg.n_cells).numpy()
    rng = np.random.default_rng(seed + 1)
    w = 1 + rng.uniform(size=jg.state_dim)
    wp = 1 + rng.uniform(size=jg.state_dim)
    want = jsm.sampled_residual(jnp.asarray(w[idx]), jnp.asarray(wp[idx]),
                                MU[0], MU[1], DT, jg, jmesh)
    got = tsm.sampled_residual(to_torch(w[idx]), to_torch(wp[idx]), MU[0],
                               MU[1], DT, tg, tmesh)
    assert rel(got.numpy(), want) < 1e-12
    want = jsm.sampled_jacobian_times_basis(
        jnp.asarray(w[idx]), jnp.asarray(basis[idx]), DT, jg, jmesh)
    got = tsm.sampled_jacobian_times_basis(
        to_torch(w[idx]), to_torch(basis[idx]), DT, tg, tmesh)
    assert rel(got.numpy(), want) < 1e-12


# ----------------------------------------------------------------------
# the snapshot cache, shared by both packages
# ----------------------------------------------------------------------

def test_filename_protocol_matches_jax():
    for mu, folder in (([4.25, 0.015], "param_snaps"), ([5.5, 0.03], "x")):
        assert tsnap.param_to_snap_fn(mu, snap_folder=folder) == \
            jsnap.param_to_snap_fn(mu, snap_folder=folder)


def test_cache_is_shared_between_packages(tmp_path):
    """The port writes a trajectory that the JAX package reads as a cache
    hit, and back: same file name, same .npy layout and bits."""
    jg = JGrid2D(nx=6, ny=6, x_up=100.0, y_up=100.0)
    tg = grid_from_jax(jg)
    w0 = np.ones(jg.state_dim)
    folder = str(tmp_path / "snaps")
    mine = tsnap.load_or_compute_snaps(MU, tg, to_torch(w0), DT, 4,
                                       snap_folder=folder)
    assert mine.shape == (jg.state_dim, 5) and mine.dtype == np.float64
    theirs = jsnap.load_or_compute_snaps(MU, jg, w0, DT, 4,
                                         snap_folder=folder)
    np.testing.assert_array_equal(theirs, mine)
    # a longer JAX trajectory replaces the cache; the port reads it back
    longer = jsnap.load_or_compute_snaps(MU, jg, w0, DT, 6,
                                         snap_folder=folder)
    back = tsnap.load_or_compute_snaps(MU, tg, to_torch(w0), DT, 6,
                                       snap_folder=folder)
    np.testing.assert_array_equal(back, longer)
    assert rel(mine, longer[:, :5]) < 1e-12
    # a shorter request is a slice of the cache
    np.testing.assert_array_equal(
        tsnap.load_or_compute_snaps(MU, tg, to_torch(w0), DT, 2,
                                    snap_folder=folder), longer[:, :3])


def test_collect_snapshots_and_missing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)     # missing_snapshots.log goes here
    jg = JGrid2D(nx=6, ny=6, x_up=100.0, y_up=100.0)
    tg = grid_from_jax(jg)
    w0 = to_torch(np.ones(jg.state_dim))
    folder = str(tmp_path / "snaps")
    mus = [[4.25, 0.0225], [5.5, 0.015]]
    both = tsnap.collect_snapshots(mus, tg, w0, DT, 3, snap_folder=folder)
    assert both.shape == (jg.state_dim, 8)
    with pytest.raises(FileNotFoundError):
        tsnap.collect_snapshots([[9.0, 0.01]], tg, w0, DT, 3,
                                snap_folder=folder, allow_missing=True)


class _Unconverged:
    """What a stepper returns: f32 snapshots and a worst final Newton
    residual, for the convergence warning."""

    def __init__(self, snaps, worst):
        self.snaps, self.max_final_relnorm = snaps, worst
        self.total_newton_its = 3


@pytest.mark.parametrize("worst,warns", [(1e-9, False), (1e-5, True)])
def test_convergence_warning_keyed_on_stored_dtype(tmp_path, monkeypatch,
                                                   capsys, worst, warns):
    """With an f64 w0 and f32 snapshots (the runners' setting) both
    packages warn above the f32 cutoff 1e-6, never at 1e-9: the cutoff
    follows the stored snapshots' dtype, not the Newton dtype."""
    import finitedifference_tpu.fom as jfom
    import finitedifference_tpu_torch.fom as tfom

    jg = JGrid2D(nx=6, ny=6, x_up=100.0, y_up=100.0)
    tg = grid_from_jax(jg)
    snaps = np.ones((jg.state_dim, 3), dtype=np.float32)
    for mod, arr in ((jfom, jnp.asarray(snaps)), (tfom, torch.from_numpy(
            snaps))):
        for name in ("inviscid_burgers_implicit2d",
                     "inviscid_burgers_implicit2d_skewed"):
            monkeypatch.setattr(mod, name, lambda *a, _arr=arr, **kw:
                                _Unconverged(_arr, worst))
    w0 = np.ones(jg.state_dim)
    for i, (load, grid, w) in enumerate((
            (tsnap.load_or_compute_snaps, tg, to_torch(w0)),
            (jsnap.load_or_compute_snaps, jg, w0))):
        got = load(MU, grid, w, DT, 2, snap_folder=str(tmp_path / f"s{i}"),
                   snaps_dtype=np.float32)
        assert got.dtype == np.float32
        out = capsys.readouterr().out
        assert ("unconverged" in out) == warns, out


def test_error_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(10, 5)) + 5
    b = a + 0.01 * rng.normal(size=a.shape)
    got, got_mean = tsnap.compute_error(b, a)
    want, want_mean = jsnap.compute_error(b, a)
    np.testing.assert_array_equal(got, want)
    assert got_mean == want_mean
    assert tsnap.relative_error_pct(b, a) == jsnap.relative_error_pct(b, a)


# ----------------------------------------------------------------------
# convert.py: JAX objects carried across
# ----------------------------------------------------------------------

def test_rom_result_round_trip(problem):
    jg, tg, w0, basis = problem
    want = jrom.lspg_prom(jg, jnp.asarray(w0), DT, 4, MU[0], MU[1],
                          jnp.asarray(basis))
    got = rom_result_from_jax(want, device="cpu")
    assert isinstance(got, trom.ROMResult)
    np.testing.assert_array_equal(got.red_coords.numpy(),
                                  np.asarray(want.red_coords))
    assert got.total_gn_its == int(want.total_gn_its)
    back = result_to_numpy(got)
    np.testing.assert_array_equal(back.red_coords,
                                  np.asarray(want.red_coords))
    assert back.gn_evals is None


def test_padded_basis_carried_across(problem):
    """The JAX package's padded full-grid layout, carried across, is the
    port's own."""
    jg, tg, _, basis = problem
    jvu, jvv, jmask, jtr = precompute_prom_pallas(jg, basis, tile_rows=4)
    tvu, tvv, tmask, ttr = tprecompute(tg, to_torch(basis), tile_rows=4)
    assert ttr == jtr
    for j, t in ((jvu, tvu), (jvv, tvv), (jmask, tmask)):
        carried = to_torch(j)
        assert carried.dtype == t.dtype and torch.equal(carried, t)
