"""The port's FOM (Newton step, trajectories, the skewed engine) against
the JAX package on the CPU: same states, same Newton iteration counts."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu import fom as jfom
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu_torch import fom as tfom
from finitedifference_tpu_torch.convert import (
    grid_from_jax,
    result_to_numpy,
)
from finitedifference_tpu_torch.ops import cuda_wavefront
from finitedifference_tpu_torch import convert

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

MU = [4.75, 0.02]
DT = 0.05


def grids(nx, ny):
    jg = JGrid2D(nx=nx, ny=ny, x_up=100.0, y_up=100.0)
    return jg, grid_from_jax(jg)


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_newton_step_converged():
    jg, tg = grids(8, 6)
    wp = 1 + np.random.default_rng(0).uniform(size=jg.state_dim)
    want = jfom.newton_step(jnp.asarray(wp), MU[0], MU[1], DT, jg)
    got = result_to_numpy(tfom.newton_step(to_torch(wp), MU[0], MU[1], DT,
                                           tg))
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=1e-12)
    assert int(got.num_its) == int(want.num_its)
    np.testing.assert_allclose(got.init_norm, float(want.init_norm),
                               rtol=1e-12)
    # converged: both final residuals sit at roundoff, under the cutoff
    assert got.resnorm / got.init_norm < 1e-12
    assert float(want.resnorm / want.init_norm) < 1e-12


def test_newton_step_truncated():
    """max_its=1 stops before convergence: the one-update state and its
    (far from roundoff) residual norm agree."""
    jg, tg = grids(8, 6)
    wp = np.ones(jg.state_dim)
    want = jfom.newton_step(jnp.asarray(wp), MU[0], MU[1], DT, jg,
                            max_its=1)
    got = result_to_numpy(tfom.newton_step(to_torch(wp), MU[0], MU[1], DT,
                                           tg, max_its=1))
    np.testing.assert_allclose(got.w, np.asarray(want.w), rtol=1e-12)
    np.testing.assert_allclose(got.resnorm, float(want.resnorm),
                               rtol=1e-12)
    assert int(got.num_its) == int(want.num_its) == 1


def test_newton_step_f32_stagnation():
    """f32 state: cutoff 1e-6 and the stagnation escape, as JAX."""
    jg, tg = grids(13, 9)
    wp = np.ones(jg.state_dim, np.float32)
    want = jfom.newton_step(jnp.asarray(wp), MU[0], MU[1], DT, jg,
                            max_its=20)
    got = tfom.newton_step(to_torch(wp), MU[0], MU[1], DT, tg, max_its=20)
    assert got.w.dtype == torch.float32
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w),
                               rtol=1e-6)
    assert got.num_its == int(want.num_its)


def test_implicit_trajectory():
    jg, tg = grids(13, 9)
    w0 = np.ones(jg.state_dim)
    want = jfom.inviscid_burgers_implicit2d(jg, jnp.asarray(w0), DT, 10,
                                            MU[0], MU[1])
    got = tfom.inviscid_burgers_implicit2d(tg, to_torch(w0), DT, 10,
                                           MU[0], MU[1])
    np.testing.assert_allclose(got.snaps.numpy(), np.asarray(want.snaps),
                               rtol=1e-12, atol=1e-13)
    assert got.total_newton_its == int(want.total_newton_its)
    assert float(got.max_final_relnorm) < 1e-12


def test_skewed_engine_f64():
    jg, tg = grids(13, 9)
    w0 = np.ones(jg.state_dim)
    want = jfom.inviscid_burgers_implicit2d_skewed(
        jg, jnp.asarray(w0), DT, 10, MU[0], MU[1], use_pallas=False)
    got = tfom.inviscid_burgers_implicit2d_skewed(
        tg, to_torch(w0), DT, 10, MU[0], MU[1])
    np.testing.assert_allclose(got.snaps.numpy(), np.asarray(want.snaps),
                               rtol=1e-12, atol=1e-13)
    assert got.total_newton_its == int(want.total_newton_its)
    # the worst final relative residual sits at roundoff (~1e-15) in
    # both; it is a ratio of two norms of residual noise, so close, not
    # equal
    np.testing.assert_allclose(float(got.max_final_relnorm),
                               float(want.max_final_relnorm), rtol=0.5)
    assert float(got.max_final_relnorm) < 1e-12


def test_skewed_engine_f32_solve():
    """f64 Newton with f32 solves reaches the f64 standard trajectory."""
    jg, tg = grids(16, 16)
    w0 = np.ones(jg.state_dim)
    want = jfom.inviscid_burgers_implicit2d(jg, jnp.asarray(w0), DT, 20,
                                            5.19, 0.026)
    got = tfom.inviscid_burgers_implicit2d_skewed(
        tg, to_torch(w0), DT, 20, 5.19, 0.026, solve_dtype=torch.float32)
    assert rel(got.snaps.numpy(), np.asarray(want.snaps)) < 1e-12


def test_skewed_engine_extrapolated_guess():
    """The predictor changes only the Newton start: same trajectory as
    JAX's run of the same, equal counts, fewer than without it."""
    jg, tg = grids(32, 32)
    w0 = np.ones(jg.state_dim)
    want = jfom.inviscid_burgers_implicit2d_skewed(
        jg, jnp.asarray(w0), DT, 60, MU[0], MU[1], use_pallas=False,
        extrapolate_guess=True)
    got = tfom.inviscid_burgers_implicit2d_skewed(
        tg, to_torch(w0), DT, 60, MU[0], MU[1], block=8,
        extrapolate_guess=True)
    base = tfom.inviscid_burgers_implicit2d_skewed(
        tg, to_torch(w0), DT, 60, MU[0], MU[1], block=8)
    assert rel(got.snaps.numpy(), np.asarray(want.snaps)) < 1e-12
    assert rel(got.snaps.numpy(), base.snaps.numpy()) < 1e-12
    assert got.total_newton_its == int(want.total_newton_its)
    assert got.total_newton_its < base.total_newton_its


def test_explicit_trajectory():
    jg, tg = grids(8, 6)
    w0 = np.ones(jg.state_dim)
    want = jfom.inviscid_burgers_explicit2d(jg, jnp.asarray(w0), 0.01, 20,
                                            MU[0], MU[1])
    got = tfom.inviscid_burgers_explicit2d(tg, to_torch(w0), 0.01, 20,
                                           MU[0], MU[1])
    assert got.shape == (jg.state_dim, 21)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_segmented_solve_not_ported():
    """seg > 0 is ported (B7): on CPU tensors it runs the plain segment
    solve, launches no kernel and stays within the inexact-Newton bound
    of the exact chain (tests/test_torch_seg.py holds it against JAX)."""
    _, tg = grids(8, 6)
    w0 = torch.ones(tg.state_dim, dtype=torch.float64)
    seg = tfom.inviscid_burgers_implicit2d_skewed(tg, w0, DT, 2, MU[0],
                                                  MU[1], seg=4, block=8)
    exact = tfom.inviscid_burgers_implicit2d_skewed(tg, w0, DT, 2, MU[0],
                                                    MU[1], block=8)
    assert cuda_wavefront.SEG_LAUNCHES == 0
    assert rel(seg.snaps.numpy(), exact.snaps.numpy()) < 1e-5


def test_host_array_needs_a_card_or_cpu():
    """A numpy w0 goes to the CUDA device, never silently to the CPU:
    without a card the entry point raises; CPU tensors run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: numpy inputs run there")
    _, tg = grids(8, 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfom.inviscid_burgers_implicit2d_skewed(tg, np.ones(tg.state_dim),
                                                DT, 1, MU[0], MU[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.initial_state()
    assert tg.initial_state(device="cpu").device.type == "cpu"


def test_cpu_path_launches_no_kernel():
    _, tg = grids(8, 6)
    before = cuda_wavefront.LAUNCHES
    res = tfom.inviscid_burgers_implicit2d_skewed(
        tg, torch.ones(tg.state_dim, dtype=torch.float64), DT, 3,
        MU[0], MU[1])
    assert res.total_newton_its > 0
    assert cuda_wavefront.LAUNCHES == before == 0


def test_slice_end_to_end_from_jax_state():
    """The whole slice: a JAX grid and state carried across with
    grid_from_jax/to_torch, 20 skewed steps, back with result_to_numpy."""
    jg = JGrid2D(nx=32, ny=24, x_up=100.0, y_up=100.0)
    w0 = jg.initial_state(dtype=jnp.float64)
    want = jfom.inviscid_burgers_implicit2d_skewed(
        jg, w0, DT, 20, 5.19, 0.026, use_pallas=False)
    got = result_to_numpy(tfom.inviscid_burgers_implicit2d_skewed(
        grid_from_jax(jg), to_torch(w0), DT, 20, 5.19, 0.026))
    assert got.snaps.shape == want.snaps.shape
    np.testing.assert_allclose(got.snaps, np.asarray(want.snaps),
                               rtol=1e-12, atol=1e-13)
    assert int(got.total_newton_its) == int(want.total_newton_its)
