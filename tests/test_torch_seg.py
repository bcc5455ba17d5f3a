"""The overlapping-segment wavefront solve (B7) and the FOM's `seg > 0`
path against the JAX package on the CPU.

The port's plain version (ops/skewed.solve_skewed_seg_ref: what a CPU
tensor runs) is held against JAX's Pallas segment kernel in interpret
mode on the same skewed inputs (24x16 grid, block-8 layout), and against
the exact chain; the seg FOM against JAX's seg FOM with equal Newton
counts. Tolerances: f32 rtol 1e-5 / atol 1e-6 against the Pallas kernel
(the same f32 recurrence, rounded in another order), rtol / atol 2e-5
against the exact chain (tests/test_skewed.py's), FOM rel 1e-9 against
JAX (f64 Newton, f32 solves on both sides) and 1e-5 against the exact
chain (the inexact-Newton bound of tests/test_skewed.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu import fom as jfom
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import skewed as jsk
from finitedifference_tpu.ops.pallas_wavefront import (
    segment_geometry,
    solve_skewed_pallas_seg,
)
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch import fom as tfom
from finitedifference_tpu_torch.convert import grid_from_jax, layout_from_jax
from finitedifference_tpu_torch.ops import cuda_wavefront
from finitedifference_tpu_torch.ops import skewed as tsk

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

DT = 0.05


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) \
        / np.linalg.norm(np.asarray(b))


def seg_problem(dtype=np.float32, seed=8):
    """The 24x16 grid of tests/test_skewed.py with a block-8 layout and
    skewed u, v, fu, fv in [1, 2], zero off the band."""
    jg = JGrid2D(nx=24, ny=16, x_up=100.0, y_up=100.0)
    jlay = jsk.make_layout(jg, block=8)
    rng = np.random.default_rng(seed)
    arrs = [np.asarray(jsk.to_skewed(jnp.asarray(
        1 + rng.uniform(size=(jg.ny, jg.nx))), jlay)).astype(dtype)
        for _ in range(4)]
    return jg, jlay, grid_from_jax(jg), layout_from_jax(jlay), arrs


@pytest.mark.parametrize("n_seg,overlap", [(4, 16), (3, 8)])
def test_seg_ref_matches_pallas_seg(n_seg, overlap):
    """(4, 16): the overlap is longer than a segment (seg_len 10), so the
    warm-ups cross segment starts and negative diagonals."""
    jg, jlay, tg, tlay, arrs = seg_problem()
    want = solve_skewed_pallas_seg(*map(jnp.asarray, arrs), DT, jg, jlay,
                                   n_seg=n_seg, overlap=overlap,
                                   interpret=True)
    t = [to_torch(a) for a in arrs]
    got = tsk.solve_skewed_seg(*t, DT, tg, tlay, n_seg=n_seg,
                               overlap=overlap)
    exact = tsk.solve_skewed_ref(*t, DT, tg, tlay)
    seg_len, _ = segment_geometry(jlay, n_seg, overlap)
    assert tsk.segment_length(tlay, n_seg) == seg_len
    band = np.asarray(jsk.valid_mask(jlay, jnp.float64)) > 0
    for g, w, e in zip(got, want, exact):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=2e-5,
                                   atol=2e-5)
        assert np.all(g.numpy()[~band] == 0)


def test_seg_ref_truncates_with_short_overlap():
    """Segment 0 is exact whatever the overlap; later segments carry a
    truncation error that a longer warm-up shrinks (f64)."""
    _, _, tg, tlay, arrs = seg_problem(np.float64, seed=3)
    t = [to_torch(a) for a in arrs]
    exact = tsk.solve_skewed_ref(*t, DT, tg, tlay)
    seg_len = tsk.segment_length(tlay, 5)
    errs = []
    for overlap in (0, 2, 8):
        got = tsk.solve_skewed_seg_ref(*t, DT, tg, tlay, n_seg=5,
                                       overlap=overlap)
        assert torch.equal(got[0][:seg_len], exact[0][:seg_len])
        errs.append(float((got[0] - exact[0]).abs().max()))
    assert errs[0] > errs[1] > errs[2]
    one = tsk.solve_skewed_seg_ref(*t, DT, tg, tlay, n_seg=1, overlap=0)
    assert all(torch.equal(a, b) for a, b in zip(one, exact))


def test_fom_seg_matches_jax():
    """The seg FOM (f64 Newton, f32 segment solves) against JAX's
    Pallas seg path in interpret mode, and against the exact chain."""
    jg = JGrid2D(nx=16, ny=16, x_up=100.0, y_up=100.0)
    tg = grid_from_jax(jg)
    w0 = np.ones(jg.state_dim)
    want = jfom.inviscid_burgers_implicit2d_skewed(
        jg, jnp.asarray(w0), DT, 10, 5.19, 0.026, use_pallas=True,
        pallas_interpret=True, seg=4, seg_overlap=16)
    before = cuda_wavefront.SEG_LAUNCHES
    got = tfom.inviscid_burgers_implicit2d_skewed(
        tg, to_torch(w0), DT, 10, 5.19, 0.026, seg=4, seg_overlap=16,
        solve_dtype=torch.float32)
    exact = tfom.inviscid_burgers_implicit2d_skewed(
        tg, to_torch(w0), DT, 10, 5.19, 0.026)
    assert cuda_wavefront.SEG_LAUNCHES == before
    assert rel(got.snaps.numpy(), want.snaps) <= 1e-9
    assert got.total_newton_its == int(want.total_newton_its)
    assert rel(got.snaps.numpy(), exact.snaps.numpy()) < 1e-5


def test_seg_rejects_bad_geometry():
    _, _, tg, tlay, arrs = seg_problem()
    t = [to_torch(a) for a in arrs]
    with pytest.raises(ValueError, match="n_seg"):
        tsk.solve_skewed_seg(*t, DT, tg, tlay, n_seg=0, overlap=4)
    with pytest.raises(ValueError, match="overlap"):
        tsk.solve_skewed_seg(*t, DT, tg, tlay, n_seg=2, overlap=-1)
