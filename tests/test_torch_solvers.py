"""The port's Gauss-Newton solver family against the JAX package on the
CPU: the same least-squares solutions, and the same Gauss-Newton states,
norms and iteration counts (f64 within 1e-12 relative)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu import solvers as jsol
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import stencil as jst
from finitedifference_tpu_torch import solvers as tsol
from finitedifference_tpu_torch.convert import grid_from_jax
from finitedifference_tpu_torch.ops import stencil as tst
from finitedifference_tpu_torch.precision import precision_flags
from finitedifference_tpu_torch import convert

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

MU = (4.75, 0.02)
DT = 0.05


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) \
        / np.linalg.norm(np.asarray(b))


def test_precision_pinned_at_import():
    """Importing the package pins full-f32 matmuls (no TF32)."""
    assert precision_flags() == {"cuda.matmul.allow_tf32": False,
                                 "cudnn.allow_tf32": False,
                                 "float32_matmul_precision": "highest"}


@pytest.mark.parametrize("method,shape", [
    ("normal", (40, 7)), ("cg", (40, 7)), ("svd", (40, 7)), ("qr", (40, 7)),
    ("svd", (5, 9)), ("qr", (5, 9))])
def test_lstsq_family(method, shape):
    """Each least-squares method matches its JAX twin (the normal
    equations on the tall, well-conditioned case; svd and qr also on a
    wide one, where qr takes the min-norm branch)."""
    rng = np.random.default_rng(shape[0])
    a = rng.normal(size=shape) + 3 * np.eye(*shape)
    b = rng.normal(size=shape[0])
    jfn = {"normal": jsol.lstsq_normal, "cg": jsol.lstsq_normal_cg,
           "svd": jsol.lstsq_svd, "qr": jsol.lstsq_qr}[method]
    want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
    got = tsol.LS_METHODS[method](to_torch(a), to_torch(b)).numpy()
    assert rel(got, want) < 1e-12


def test_lstsq_normal_ridge_and_matrix_rhs():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(30, 6))
    b = rng.normal(size=(30, 3))
    want = np.asarray(jsol.lstsq_normal(jnp.asarray(a), jnp.asarray(b),
                                        ridge=0.5))
    got = tsol.lstsq_normal(to_torch(a), to_torch(b), ridge=0.5).numpy()
    assert rel(got, want) < 1e-12


def test_unknown_ls_method():
    with pytest.raises(ValueError):
        tsol.ls_solver("lu")


def lspg_step_problem(nx=9, ny=7, k=6, seed=0):
    """One LSPG time step's Gauss-Newton problem on a random orthonormal
    basis, for both packages."""
    jg = JGrid2D(nx=nx, ny=ny, x_up=100.0, y_up=100.0)
    tg = grid_from_jax(jg)
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(jg.state_dim, k)))
    wp = 1.0 + 0.3 * rng.uniform(size=jg.state_dim)
    y0 = q.T @ wp
    return jg, tg, q, wp, y0


def run_both(jg, tg, q, wp, y0, weights=None, **kw):
    jb, tb = jnp.asarray(q), to_torch(q)
    jwp, twp = jnp.asarray(wp), to_torch(wp)
    want = jsol.gauss_newton(
        lambda y: jb @ y, lambda y, w: jb,
        lambda w: jst.burgers_residual_flat(w, jwp, MU[0], MU[1], DT, jg),
        lambda w, v: jst.jacobian_times_basis(w, v, DT, jg),
        jnp.asarray(y0),
        None if weights is None else jnp.asarray(weights), **kw)
    got = tsol.gauss_newton(
        lambda y: tb @ y, lambda y, w: tb,
        lambda w: tst.burgers_residual_flat(w, twp, MU[0], MU[1], DT, tg),
        lambda w, v: tst.jacobian_times_basis(w, v, DT, tg),
        to_torch(y0), None if weights is None else to_torch(weights), **kw)
    return want, got


@pytest.mark.parametrize("kw", [
    {},
    {"ls_method": "normal"},
    {"ls_method": "cg"},
    {"ls_method": "svd"},
    {"max_its": 1},
    {"min_delta": 0.0, "relnorm_cutoff": 1e-9},
    {"line_search": True, "ls_method": "normal"},
], ids=["qr", "normal", "cg", "svd", "max_its1", "no_stagnation",
        "line_search"])
def test_gauss_newton_matches_jax(kw):
    """Same final state, residual norms and iteration count, for each
    stopping rule and solver option."""
    want, got = run_both(*lspg_step_problem(), **kw)
    assert rel(got.y.numpy(), want.y) < 1e-12
    assert got.num_its == int(want.num_its)
    np.testing.assert_allclose(float(got.init_norm), float(want.init_norm),
                               rtol=1e-12)
    np.testing.assert_allclose(float(got.resnorm), float(want.resnorm),
                               rtol=1e-9)


def test_gauss_newton_weighted_and_mixed_precision():
    """ECSW weights on the rows, and an f32 least-squares solve under an
    f64 iteration (ls_dtype)."""
    jg, tg, q, wp, y0 = lspg_step_problem(seed=3)
    weights = 0.5 + np.random.default_rng(4).uniform(size=jg.state_dim)
    want, got = run_both(jg, tg, q, wp, y0, weights=weights)
    assert rel(got.y.numpy(), want.y) < 1e-12
    assert got.num_its == int(want.num_its)
    jb, tb = jnp.asarray(q), to_torch(q)
    jwp, twp = jnp.asarray(wp), to_torch(wp)
    want = jsol.gauss_newton(
        lambda y: jb @ y, lambda y, w: jb,
        lambda w: jst.burgers_residual_flat(w, jwp, MU[0], MU[1], DT, jg),
        lambda w, v: jst.jacobian_times_basis(w, v, DT, jg),
        jnp.asarray(y0), ls_dtype=jnp.float32, ls_method="normal")
    got = tsol.gauss_newton(
        lambda y: tb @ y, lambda y, w: tb,
        lambda w: tst.burgers_residual_flat(w, twp, MU[0], MU[1], DT, tg),
        lambda w, v: tst.jacobian_times_basis(w, v, DT, tg),
        to_torch(y0), ls_dtype=torch.float32, ls_method="normal")
    assert got.y.dtype == torch.float64
    assert got.num_its == int(want.num_its)
    # f32 solves: the updates agree to f32 rounding
    assert rel(got.y.numpy(), want.y) < 1e-6


def test_gauss_newton_fused_decode_and_w0():
    """decode_and_jac and w0 take the same path as decode/dec_jac."""
    jg, tg, q, wp, y0 = lspg_step_problem(seed=5)
    tb, twp = to_torch(q), to_torch(wp)

    def res(w):
        return tst.burgers_residual_flat(w, twp, MU[0], MU[1], DT, tg)

    def jac(w, v):
        return tst.jacobian_times_basis(w, v, DT, tg)

    a = tsol.gauss_newton(lambda y: tb @ y, lambda y, w: tb, res, jac,
                          to_torch(y0))
    b = tsol.gauss_newton(lambda y: tb @ y, None, res, jac, to_torch(y0),
                          decode_and_jac=lambda y: (tb @ y, tb),
                          w0=tb @ to_torch(y0))
    assert torch.equal(a.y, b.y) and a.num_its == b.num_its


def test_cg_normal_matches_jax_unrolled_cg():
    """The shared CG (also the plain fused-step solve) is JAX's
    lstsq_normal_cg on the formed normal equations."""
    rng = np.random.default_rng(9)
    a = rng.normal(size=(50, 8)) + 4 * np.eye(50, 8)
    b = rng.normal(size=50)
    want = np.asarray(jsol.lstsq_normal_cg(jnp.asarray(a), jnp.asarray(b)))
    got = tsol.cg_normal(to_torch(a.T @ a), to_torch(a.T @ b), 24).numpy()
    assert rel(got, want) < 1e-12
    # a zero right-hand side freezes at zero instead of NaN (tiny guard)
    z = tsol.cg_normal(to_torch(a.T @ a), torch.zeros(8, dtype=torch.float64))
    assert torch.equal(z, torch.zeros(8, dtype=torch.float64))
