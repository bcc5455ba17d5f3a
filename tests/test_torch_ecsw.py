"""The ECSW offline recipe against the JAX package on the CPU: the
training matrix, the Lawson-Hanson NNLS solvers (the MATLAB lsqnonneg
anchors of tests/test_ecsw.py), the weight recipe, and the whole
offline-to-online chain.

Tolerances: the training matrix in f64 1e-12 relative; the NNLS solvers
are host NumPy in both packages, so their weights are compared for
equality; the HPROM on the weights f64 1e-12 with equal Gauss-Newton
counts.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu import ecsw as jecsw
from finitedifference_tpu import rom as jrom
from finitedifference_tpu_torch import ecsw as tecsw
from finitedifference_tpu_torch import rom as trom
from finitedifference_tpu_torch.convert import grid_from_jax
from tests.test_ecsw import DT, MU, setup_problem
from finitedifference_tpu_torch import convert

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

SOLVERS = [tecsw.nnls, tecsw.nnls_gram]
SOLVER_IDS = ["nnls", "nnls_gram"]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def training():
    grid, ops, xc, w0, basis, s1 = setup_problem(nx=10, ny=10,
                                                 num_steps=20, k=8)
    # snapshot vs 3-steps-earlier state (run_HPROM_ecsw_joshua.py:61-64)
    snaps, prev = s1[:, 3::2], s1[:, 0:-3:2]
    c = np.asarray(jecsw.ecsw_training_matrix(
        grid, jnp.asarray(snaps), jnp.asarray(prev), jnp.asarray(basis),
        4.25, 0.0225, DT))
    return grid, grid_from_jax(grid), w0, basis, snaps, prev, c


@pytest.mark.parametrize("batch", [None, 1, 3])
def test_training_matrix_matches_jax(training, batch, monkeypatch):
    """All snapshots in one pass, or 1 or 3 per pass."""
    jg, tg, _, basis, snaps, prev, want = training
    if batch is not None:
        monkeypatch.setattr(tecsw, "BATCH_VALUES",
                            batch * basis.shape[1] * jg.n_cells)
    got = tecsw.ecsw_training_matrix(tg, to_torch(snaps), to_torch(prev),
                                     to_torch(basis), 4.25, 0.0225, DT)
    assert got.shape == want.shape == (snaps.shape[1] * basis.shape[1],
                                       jg.n_cells)
    assert rel(got.numpy(), want) < 1e-12


# ----------------------------------------------------------------------
# NNLS: the MATLAB lsqnonneg anchors (lsqnonneg.py:114-187)
# ----------------------------------------------------------------------

C0 = np.array([[0.0372, 0.2869], [0.6861, 0.7071],
               [0.6233, 0.6245], [0.6344, 0.6170]])
D0 = np.array([0.8587, 0.1781, 0.0747, 0.8405])


@pytest.mark.parametrize("solver", SOLVERS, ids=SOLVER_IDS)
@pytest.mark.parametrize("C,resnorm,tol", [
    (C0, 0.8315, 1e-3),
    (np.hstack((C0, [[0.4], [0.3], [0.1], [0.5]])), 0.1477, 1e-2),
    (np.hstack((C0, [[0.4], [-0.3], [-0.1], [0.5]])), 0.1027, 1e-2),
], ids=["case1", "case2", "case3"])
def test_matlab_cases(solver, C, resnorm, tol):
    x, got, _ = solver(C, D0)
    assert abs(got - resnorm) < tol
    assert np.all(x >= 0)


@pytest.mark.parametrize("solver", SOLVERS, ids=SOLVER_IDS)
def test_matlab_case_random10x5(solver):
    k = np.array([[0.1210, 0.2319, 0.4398, 0.9342, 0.1370],
                  [0.4508, 0.2393, 0.3400, 0.2644, 0.8188],
                  [0.7159, 0.0498, 0.3142, 0.1603, 0.4302],
                  [0.8928, 0.0784, 0.3651, 0.8729, 0.8903],
                  [0.2731, 0.6408, 0.3932, 0.2379, 0.7349],
                  [0.2548, 0.1909, 0.5915, 0.6458, 0.6873],
                  [0.8656, 0.8439, 0.1197, 0.9669, 0.3461],
                  [0.2324, 0.1739, 0.0381, 0.6649, 0.1660],
                  [0.8049, 0.1708, 0.4586, 0.8704, 0.1556],
                  [0.9084, 0.9943, 0.8699, 0.0099, 0.1911]])
    l = np.array([0.4225, 0.8560, 0.4902, 0.8159, 0.4608,
                  0.4574, 0.4507, 0.4122, 0.9016, 0.0056])
    _, resnorm, _ = solver(k, l)
    assert abs(resnorm - 0.3695) < 1e-2
    _, resnorm, _ = solver(k - 0.5, l)
    assert abs(resnorm - 2.8639) < 1e-2


@pytest.mark.parametrize("name", ["nnls", "nnls_gram"])
def test_nnls_equals_jax_and_scipy(name):
    """Host NumPy in both packages: the same weights, bit for bit, and
    scipy's NNLS to 1e-8."""
    import scipy.optimize
    rng = np.random.default_rng(0)
    for _ in range(5):
        C = rng.normal(size=(30, 12))
        d = rng.normal(size=30)
        x, ssq, resid = getattr(tecsw, name)(C, d)
        jx, jssq, jresid = getattr(jecsw, name)(C, d)
        np.testing.assert_array_equal(x, jx)
        assert ssq == jssq
        np.testing.assert_array_equal(resid, jresid)
        np.testing.assert_allclose(x, scipy.optimize.nnls(C, d)[0],
                                   atol=1e-8)


@pytest.mark.parametrize("solver", SOLVERS, ids=SOLVER_IDS)
def test_early_stops(solver):
    rng = np.random.default_rng(1)
    C = rng.uniform(size=(50, 40))
    d = C @ rng.uniform(size=40)
    x, _, _ = solver(C, d, max_support=5)
    assert 0 < (x > 0).sum() <= 6    # the joining column may overshoot
    x, _, resid = solver(C, d, rel_err_thresh=0.05)
    assert np.linalg.norm(resid) / np.linalg.norm(d) < 0.05


def test_gram_matches_lstsq():
    rng = np.random.default_rng(7)
    for _ in range(5):
        C = rng.normal(size=(40, 60))
        d = C @ (np.abs(rng.normal(size=60)) * (rng.random(60) < 0.3))
        x1, _, _ = tecsw.nnls(C, d)
        x2, _, _ = tecsw.nnls_gram(C, d)
        np.testing.assert_allclose(x2, x1,
                                   atol=1e-8 * max(1.0, np.abs(x1).max()))


def test_warm_start_matches_cold():
    """x0 warm starts land on the cold KKT point, whether the seed is
    exact, perturbed or junk."""
    rng = np.random.default_rng(11)
    C = rng.uniform(size=(50, 40))
    d = C @ (np.abs(rng.normal(size=40)) * (rng.random(40) < 0.4))
    x_cold, _, _ = tecsw.nnls(C, d)
    for x0 in (x_cold, x_cold + 0.05 * rng.random(40), rng.random(40)):
        np.testing.assert_allclose(tecsw.nnls(C, d, x0=x0)[0], x_cold,
                                   atol=1e-8)
        np.testing.assert_allclose(tecsw.nnls_gram(C, d, x0=x0)[0], x_cold,
                                   atol=1e-6)


@pytest.mark.parametrize("solver", SOLVERS, ids=SOLVER_IDS)
def test_warm_start_dense_seed_on_wide_problem(solver):
    """The r5 feasibility loop: a dense seed on an underdetermined
    problem still returns x >= 0 with an exact fit."""
    rng = np.random.default_rng(13)
    C = rng.uniform(size=(12, 60))
    d = C @ (np.abs(rng.normal(size=60)) * (rng.random(60) < 0.2))
    x, _, resid = solver(C, d, x0=rng.random(60) + 0.1)
    assert np.isfinite(x).all() and x.min() >= 0.0
    assert np.linalg.norm(resid) <= 1e-6 * np.linalg.norm(d)


def test_warm_start_respects_early_stop():
    rng = np.random.default_rng(12)
    C = rng.uniform(size=(50, 40))
    x_true = np.abs(rng.normal(size=40)) * (rng.random(40) < 0.4)
    d = C @ x_true
    x, _, resid = tecsw.nnls(C, d, rel_err_thresh=0.05, x0=x_true)
    assert np.linalg.norm(resid) / np.linalg.norm(d) < 0.05
    assert (x > 0).sum() <= (x_true > 0).sum()


@pytest.mark.parametrize("name", ["_GramCholesky", "_GramInverse"])
def test_gram_helpers_track_lstsq(name):
    """Adding and removing passive columns keeps the weights of the
    least-squares fit on the current columns, as JAX's helper does; a
    dependent column is refused."""
    rng = np.random.default_rng(5)
    G = rng.normal(size=(30, 10))
    G[:, 9] = G[:, 2] + G[:, 4]
    b = rng.normal(size=30)
    mine, theirs = getattr(tecsw, name)(G, b), getattr(jecsw, name)(G, b)
    for j in (0, 2, 4, 7, 5):
        assert mine.try_add(j) and theirs.try_add(j)
    assert not mine.try_add(9)
    mine.remove(1)
    theirs.remove(1)
    assert mine.cols == theirs.cols == [0, 4, 7, 5]
    want = np.linalg.lstsq(G[:, mine.cols], b, rcond=None)[0]
    np.testing.assert_allclose(mine.weights(), want, rtol=1e-10)
    np.testing.assert_array_equal(mine.weights(), theirs.weights())


# ----------------------------------------------------------------------
# the weight recipe
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ring", ["full", "inflow"])
def test_interior_mask_matches_jax(training, ring):
    jg, tg = training[:2]
    np.testing.assert_array_equal(tecsw.interior_mask(tg, ring),
                                  jecsw.interior_mask(jg, ring))


def test_interior_mask_unknown_ring(training):
    with pytest.raises(ValueError):
        tecsw.interior_mask(training[1], "square")


@pytest.mark.parametrize("method", ["nnls", "nnls_lstsq", "scipy_nnls"])
def test_weights_equal_jax(training, method):
    """The recipe from a tensor C (as the port's training matrix gives
    it) equals the JAX recipe from the numpy C."""
    jg, tg, *_, c = training
    want = jecsw.compute_ecsw_weights(c, jg, bc_w=5.0, method=method,
                                      rel_err_thresh=1e-4)
    got = tecsw.compute_ecsw_weights(to_torch(c), tg, bc_w=5.0,
                                     method=method, rel_err_thresh=1e-4)
    np.testing.assert_array_equal(got, want)
    assert 0 < int((got > 0).sum()) < jg.n_cells


def test_ecm_not_ported_yet(training):
    """The name is historical: method="ecm" was not ported until the
    runners' slice. Now it gives a nonnegative weight field with the
    fixed ring weight; an unknown method still raises."""
    tg, c = training[1], training[-1]
    w = tecsw.compute_ecsw_weights(to_torch(c), tg, bc_w=5.0, method="ecm",
                                   ecm_tolerance=1e-4)
    ring = ~tecsw.interior_mask(tg).ravel()
    assert np.all(w >= 0) and np.all(w[ring] == 5.0)
    assert 0 < int((w[~ring] > 0).sum()) < int((~ring).sum())
    with pytest.raises(ValueError):
        tecsw.compute_ecsw_weights(c, tg, method="lars")


def test_ecm_keywords_bind_as_in_jax(training):
    """The JAX signature's ECM keywords sit before `ring`: a keyword call
    with them runs ECM on a rank-4 sketch, and a call that spells out
    every argument up to `ring` by position gives JAX's weights."""
    jg, tg, *_, c = training
    w = tecsw.compute_ecsw_weights(to_torch(c), tg, method="ecm",
                                   ecm_tolerance=1e-3, ecm_rank=4)
    # a rank-4 sketch needs few points: at most rank + 1 interior cells
    n_int = int((w[tecsw.interior_mask(tg).ravel()] > 0).sum())
    assert 0 < n_int <= 5
    args = (5.0, "nnls", 1e-4, None, 1e-2, None, "inflow")
    want = jecsw.compute_ecsw_weights(c, jg, *args)
    got = tecsw.compute_ecsw_weights(to_torch(c), tg, *args)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 5.0 and got[1] != 5.0   # the inflow ring only


def test_offline_to_online_matches_jax(training):
    """Training matrix, NNLS weights, prepare_hprom, HPROM at the unseen
    mu: the port's chain against JAX's, and both near the FOM."""
    jg, tg, w0, basis, snaps, prev, c = training
    tc = tecsw.ecsw_training_matrix(tg, to_torch(snaps), to_torch(prev),
                                    to_torch(basis), 4.25, 0.0225, DT)
    weights = tecsw.compute_ecsw_weights(tc, tg, bc_w=5.0,
                                         rel_err_thresh=1e-4)
    jweights = jecsw.compute_ecsw_weights(c, jg, bc_w=5.0,
                                          rel_err_thresh=1e-4)
    np.testing.assert_allclose(weights, jweights, rtol=1e-6, atol=1e-9)
    y0 = basis.T @ w0
    mesh, sw, ba = trom.prepare_hprom(tg, weights, to_torch(basis))
    got = trom.ecsw_hprom(tg, mesh, sw, to_torch(y0), ba, DT, 20, MU[0],
                          MU[1])
    jmesh, jsw, jba = jrom.prepare_hprom(jg, weights, basis)
    want = jrom.ecsw_hprom(jg, jmesh, jsw, jnp.asarray(y0), jnp.asarray(jba),
                           DT, 20, MU[0], MU[1])
    assert rel(got.red_coords.numpy(), want.red_coords) < 1e-12
    assert got.total_gn_its == int(want.total_gn_its)
    assert mesh.n_sample < jg.n_cells
