"""The port's grid and stencils against the JAX package and the scipy
oracle (12x10 grid, non-square to catch x/y mixups, float64)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import stencil as jst
from finitedifference_tpu_torch.convert import grid_from_jax
from finitedifference_tpu_torch.ops import stencil as tst
from finitedifference_tpu_torch import convert

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

MU = [4.75, 0.02]
DT = 0.07
F64 = torch.float64


def grids(nx=12, ny=10):
    jg = JGrid2D(nx=nx, ny=ny, x_up=100.0, y_up=100.0)
    return jg, grid_from_jax(jg)


def states(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [1.0 + rng.uniform(size=s) for s in shapes]


def test_grid_coordinates_and_layout():
    jg, tg = grids()
    assert (tg.dx, tg.dy, tg.state_dim) == (jg.dx, jg.dy, jg.state_dim)
    np.testing.assert_allclose(tg.xc(dtype=F64, device="cpu").numpy(),
                               np.asarray(jg.xc(dtype=jnp.float64)),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(tg.yc(dtype=F64, device="cpu").numpy(),
                               np.asarray(jg.yc(dtype=jnp.float64)),
                               rtol=0, atol=1e-13)
    (w,) = states(0, jg.state_dim)
    tu, tv = tg.split_fields(to_torch(w))
    ju, jv = jg.split_fields(jnp.asarray(w))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tg.merge_fields(tu, tv).numpy(), w)
    assert tg.initial_state(dtype=F64, device="cpu").shape == (jg.state_dim,)


@pytest.mark.parametrize("mu", [(4.75, 0.02), (5.19, 0.026)])
def test_source_and_inflow_terms(mu):
    jg, tg = grids()
    np.testing.assert_allclose(
        tst.source_term(tg, mu[1], DT, dtype=F64, device="cpu").numpy(),
        np.asarray(jst.source_term(jg, mu[1], DT, dtype=jnp.float64)),
        rtol=0, atol=1e-13)
    np.testing.assert_allclose(
        tst.inflow_bc_term(tg, mu[0], DT, dtype=F64,
                           device="cpu").numpy(),
        np.asarray(jst.inflow_bc_term(jg, mu[0], DT, dtype=jnp.float64)),
        rtol=0, atol=1e-13)


def test_residual_matches_jax_and_oracle():
    jg, tg = grids()
    ops, xc = oracle.make_problem(nx=12, ny=10)
    w, wp = states(1, jg.state_dim, jg.state_dim)
    got = tst.burgers_residual_flat(to_torch(w), to_torch(wp), MU[0], MU[1],
                                    DT, tg).numpy()
    want_jax = np.asarray(jst.burgers_residual_flat(
        jnp.asarray(w), jnp.asarray(wp), MU[0], MU[1], DT, jg))
    np.testing.assert_allclose(got, want_jax, rtol=0, atol=1e-13)
    np.testing.assert_allclose(got, oracle.residual(w, wp, MU, DT, ops, xc),
                               rtol=0, atol=1e-13)


def test_apply_jacobian_flat():
    jg, tg = grids()
    ops, _ = oracle.make_problem(nx=12, ny=10)
    (w,) = states(2, jg.state_dim)
    dw = np.random.default_rng(3).normal(size=jg.state_dim)
    got = tst.apply_jacobian_flat(to_torch(w), to_torch(dw), DT, tg).numpy()
    want = np.asarray(jst.apply_jacobian_flat(jnp.asarray(w),
                                              jnp.asarray(dw), DT, jg))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    np.testing.assert_allclose(got, oracle.jacobian(w, DT, ops) @ dw,
                               rtol=0, atol=1e-13)


def test_jacobian_times_basis():
    jg, tg = grids()
    (w,) = states(4, jg.state_dim)
    basis = np.random.default_rng(5).normal(size=(jg.state_dim, 7))
    got = tst.jacobian_times_basis(to_torch(w), to_torch(basis), DT, tg)
    want = jst.jacobian_times_basis(jnp.asarray(w), jnp.asarray(basis), DT,
                                    jg)
    assert got.shape == (jg.state_dim, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-13)
