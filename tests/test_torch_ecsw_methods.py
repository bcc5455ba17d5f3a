"""The rest of the ECSW offline recipe against the JAX package on the CPU:
FISTA NNLS, empirical cubature, the sequential and multilevel weight
recipes, ECM through compute_ecsw_weights, and the device-resident
recipe (training matrix in chunks, device-scored Lawson-Hanson, device
multilevel NNLS), each fed the same seeded inputs as its JAX twin.

Tolerances: FISTA f64 1e-10 and f32 1e-5 (relative); the host recipes
(cubature, sequential, multilevel with host screening) 1e-10; FISTA
screening the same level-1 support and final weights 1e-8; the f32
training matrix 1e-6; the device NNLS recipes the same support and
weights 1e-8. ECM sketches with different random generators in the two
packages, so it is held to its cubature tolerance and to N_e within 10%
of the JAX recipe's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu import ecsw as jecsw
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch import ecsw as tecsw
from finitedifference_tpu_torch.convert import grid_from_jax
from tests.test_ecsw import DT, setup_problem

to_torch = functools.partial(convert.to_torch, device="cpu")
MU_TRAIN = (4.25, 0.0225)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def problem():
    """A 10^2 grid, 6 modes, the 3-step-offset pairs of a 20-step
    training trajectory, and JAX's training matrix on them."""
    grid, _, _, w0, basis, s1 = setup_problem(nx=10, ny=10, num_steps=20,
                                              k=6)
    snaps, prev = s1[:, 3::2], s1[:, 0:-3:2]
    c = np.asarray(jecsw.ecsw_training_matrix(
        grid, jnp.asarray(snaps), jnp.asarray(prev), jnp.asarray(basis),
        *MU_TRAIN, DT))
    return grid, grid_from_jax(grid), basis, snaps, prev, c


def training_residual(c, grid, weights, ring="full"):
    """||C_int w - C_int 1|| / ||C_int 1|| over the candidate columns."""
    flat = jecsw.interior_mask(grid, ring).ravel()
    ci = c[:, flat]
    d = ci.sum(axis=1)
    return np.linalg.norm(ci @ weights[flat] - d) / np.linalg.norm(d)


# ----------------------------------------------------------------------
# FISTA
# ----------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
def test_nnls_fista_matches_jax(batched, dtype, tol):
    rng = np.random.default_rng(3)
    cs = (rng.normal(size=(3, 40, 10)) + 2).astype(dtype)
    ds = np.einsum("bij,bj->bi", cs,
                   np.abs(rng.normal(size=(3, 10)))).astype(dtype)
    if batched:
        want_x, want_r = jax.vmap(
            lambda c, d: jecsw.nnls_fista(c, d, num_iters=300))(
            jnp.asarray(cs), jnp.asarray(ds))
        got_x, got_r = tecsw.nnls_fista(to_torch(cs), to_torch(ds),
                                        num_iters=300)
    else:
        want_x, want_r = jecsw.nnls_fista(jnp.asarray(cs[0]),
                                          jnp.asarray(ds[0]), num_iters=300)
        got_x, got_r = tecsw.nnls_fista(to_torch(cs[0]), to_torch(ds[0]),
                                        num_iters=300)
    assert got_x.dtype == to_torch(cs).dtype
    assert tuple(got_x.shape) == tuple(want_x.shape)
    assert rel(got_x.numpy(), want_x) < tol
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r),
                               rtol=tol * 100, atol=tol)
    assert np.all(got_x.numpy() >= 0)


# ----------------------------------------------------------------------
# empirical cubature
# ----------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("candidates", [False, True])
def test_empirical_cubature_matches_jax(inverse, candidates):
    """The same elements and weights; the explicit candidate set is too
    small, so the complement expansion runs too."""
    rng = np.random.default_rng(6)
    q, _ = np.linalg.qr(rng.normal(size=(150, 8)))
    kw = dict(tolerance=1e-8, use_inverse_updates=inverse)
    if candidates:
        kw["candidates"] = np.array([4, 40, 90, 120])
    z_j, w_j = jecsw.empirical_cubature(q, **kw)
    z_t, w_t = tecsw.empirical_cubature(to_torch(q), **kw)
    np.testing.assert_array_equal(z_t, z_j)
    assert rel(w_t, w_j) <= 1e-10
    assert np.all(w_t > 0)


# ----------------------------------------------------------------------
# the host weight recipes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("recipe", ["sequential", "multilevel_host"])
def test_host_weight_recipes_match_jax(problem, recipe):
    jg, tg, *_, c = problem
    if recipe == "sequential":
        kw = dict(batch_size=30, bc_w=5.0, rel_err_thresh=1e-4)
        want = jecsw.sequential_nnls_weights(c, jg, **kw)
        got = tecsw.sequential_nnls_weights(to_torch(c), tg, **kw)
    else:
        kw = dict(num_subdomains=4, bc_w=5.0, level1="host",
                  rel_err_thresh=1e-4)
        want = jecsw.multilevel_nnls_weights(c, jg, **kw)
        got = tecsw.multilevel_nnls_weights(to_torch(c), tg, **kw)
    assert rel(got, want) <= 1e-10
    np.testing.assert_array_equal(got > 0, want > 0)
    assert 0 < int((got > 0).sum()) < jg.n_cells


@pytest.mark.parametrize("case", ["training", "full_rank"])
def test_multilevel_fista_screening_matches_jax(problem, case, monkeypatch):
    """FISTA screening (f32, on the device of C: here the CPU) hands the
    level-2 solve the same columns as JAX's.

    On the training matrix (54 rows, 64 candidates) the NNLS solution is
    not unique and the f32 FISTA iterates sit 2000 iterations from
    convergence: rounding moves the screening values by about 1%, and
    the warm start, which seeds the level-2 factor in decreasing value
    order, then stops at another point of the solution set. There both
    recipes are held to the same support and to the 1e-4 training
    residual. On a full-rank C (the solution unique, FISTA converged)
    the final weights agree to 1e-8."""
    jg, tg, *_, c = problem
    if case == "full_rank":
        c = np.random.default_rng(9).normal(size=(160, jg.n_cells)) + 1.0
    seen = {}

    def spy(name, solver):
        def wrapped(cs, d, **kw):
            seen[name] = (np.array(cs), np.array(kw["x0"]))
            return solver(cs, d, **kw)
        return wrapped

    monkeypatch.setattr(jecsw, "nnls_gram", spy("jax", jecsw.nnls_gram))
    monkeypatch.setattr(tecsw, "nnls_gram", spy("torch", tecsw.nnls_gram))
    kw = dict(num_subdomains=4, bc_w=5.0, level1="fista",
              fista_iters=2000, device_block_chunk=3, rel_err_thresh=1e-4)
    want = jecsw.multilevel_nnls_weights(c, jg, **kw)
    got = tecsw.multilevel_nnls_weights(to_torch(c), tg, **kw)
    (cs_j, x0_j), (cs_t, x0_t) = seen["jax"], seen["torch"]
    assert cs_t.shape == cs_j.shape
    np.testing.assert_array_equal(cs_t, cs_j)      # the same support
    np.testing.assert_array_equal(x0_t > 0, x0_j > 0)
    assert np.all(got >= 0)
    if case == "full_rank":
        assert rel(got, want) <= 1e-8
    else:
        for w in (want, got):
            assert training_residual(c, jg, w) < 1e-4


@pytest.mark.parametrize("ecm_rank", [None, 40])
def test_ecm_weights_meet_tolerance(problem, ecm_rank):
    """ECM through compute_ecsw_weights (adaptive rSVD, or a fixed-rank
    sketch): its training residual meets the cubature tolerance, as
    JAX's does, with N_e within 10% of JAX's."""
    jg, tg, *_, c = problem
    kw = dict(bc_w=5.0, method="ecm", ecm_tolerance=1e-4,
              ecm_rank=ecm_rank)
    want = jecsw.compute_ecsw_weights(c, jg, **kw)
    got = tecsw.compute_ecsw_weights(to_torch(c), tg, **kw)
    for w in (want, got):
        assert np.all(w >= 0)
        assert training_residual(c, jg, w) <= 1e-4
    n_want = int((want > 0).sum())
    n_got = int((got > 0).sum())
    assert abs(n_got - n_want) <= 0.1 * n_want
    assert n_got < jg.n_cells


# ----------------------------------------------------------------------
# the device-resident recipe
# ----------------------------------------------------------------------

def test_training_matrix_device_matches_jax(problem):
    jg, tg, basis, snaps, prev, _ = problem
    want = np.asarray(jecsw.ecsw_training_matrix_device(
        jg, snaps, prev, basis, *MU_TRAIN, DT, chunk=3))
    got = tecsw.ecsw_training_matrix_device(
        tg, snaps, prev, to_torch(basis), *MU_TRAIN, DT, chunk=3)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) <= 1e-6
    with pytest.raises(ValueError, match="divide"):
        tecsw.ecsw_training_matrix_device(
            tg, snaps, prev, to_torch(basis), *MU_TRAIN, DT, chunk=2)


def test_training_matrix_device_multi_matches_jax(problem):
    jg, tg, basis, snaps, prev, _ = problem
    mus = [(4.25, 0.0225), (5.5, 0.03)]
    want = np.asarray(jecsw.ecsw_training_matrix_device_multi(
        jg, [(m1, m2, snaps, prev) for m1, m2 in mus], basis, DT, chunk=3))
    got = tecsw.ecsw_training_matrix_device_multi(
        tg, [(m1, m2, snaps, prev) for m1, m2 in mus], to_torch(basis), DT,
        chunk=3)
    assert tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("batch_add", [1, 8])
def test_lawson_hanson_device_matches_jax(problem, batch_add):
    jg, tg, *_, c = problem
    kw = dict(bc_w=5.0, ring="full", rel_err_thresh=1e-4,
              batch_add=batch_add)
    want = jecsw.lawson_hanson_weights_device(jnp.asarray(c), jg, **kw)
    got = tecsw.lawson_hanson_weights_device(to_torch(c), tg, **kw)
    np.testing.assert_array_equal(got > 0, want > 0)
    assert rel(got, want) <= 1e-8
    assert training_residual(c, jg, got) < 1e-4


@pytest.mark.parametrize("level1", ["global", "block"])
def test_multilevel_device_matches_jax(problem, level1):
    jg, tg, *_, c = problem
    kw = dict(num_subdomains=4, bc_w=5.0, ring="full", fista_iters=1000,
              level1=level1)
    want = jecsw.multilevel_nnls_weights_device(jnp.asarray(c), jg, **kw)
    got = tecsw.multilevel_nnls_weights_device(to_torch(c), tg, **kw)
    np.testing.assert_array_equal(got > 0, want > 0)
    assert rel(got, want) <= 1e-8
    assert np.all(got >= 0)
    with pytest.raises(ValueError, match="level1"):
        tecsw.multilevel_nnls_weights_device(to_torch(c), tg,
                                             level1="tiles")
