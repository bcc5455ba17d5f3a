"""The port's wavefront solve and skewed ops against the JAX package
(the plain version of the CUDA kernel, run on the CPU)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import skewed as jsk
from finitedifference_tpu.ops import wavefront as jwf
from finitedifference_tpu.ops.pallas_wavefront import (
    solve_jacobian_wavefront_pallas,
    solve_skewed_pallas,
)
from finitedifference_tpu_torch.convert import (
    grid_from_jax,
    layout_from_jax,
)
from finitedifference_tpu_torch.ops import cuda_wavefront as cw
from finitedifference_tpu_torch.ops import skewed as tsk
from finitedifference_tpu_torch.ops import wavefront as twf
from finitedifference_tpu_torch.ops.stencil import apply_jacobian
from finitedifference_tpu_torch import convert

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

MU = [4.75, 0.02]
DT = 0.07
F64 = torch.float64


def grids(nx, ny):
    jg = JGrid2D(nx=nx, ny=ny, x_up=100.0, y_up=100.0)
    return jg, grid_from_jax(jg)


def skewed_pair(jg, tg, block=8):
    jlay = jsk.make_layout(jg, block=block)
    tlay = tsk.make_layout(tg, block=block)
    assert tuple(tlay) == tuple(jlay) and layout_from_jax(jlay) == tlay
    return jlay, tlay


def test_skew_unskew_roundtrip_and_vs_jax():
    x = np.random.default_rng(4).normal(size=(6, 8))
    s = twf.skew(to_torch(x), 6, 8)
    assert s.shape == (13, 6)
    np.testing.assert_array_equal(s.numpy(),
                                  np.asarray(jwf.skew(jnp.asarray(x), 6, 8)))
    np.testing.assert_array_equal(twf.unskew(s, 6, 8).numpy(), x)


@pytest.mark.parametrize("shape", [(8, 6), (6, 8), (13, 5)])
def test_solve_jacobian_wavefront(shape):
    nx, ny = shape
    jg, tg = grids(nx, ny)
    ops, _ = oracle.make_problem(nx=nx, ny=ny)
    rng = np.random.default_rng(5)
    w = 1 + rng.uniform(size=jg.state_dim)
    f = rng.normal(size=jg.state_dim)
    got = twf.solve_jacobian_flat(to_torch(w), to_torch(f), DT, tg).numpy()
    want_jax = np.asarray(jwf.solve_jacobian_flat(jnp.asarray(w),
                                                  jnp.asarray(f), DT, jg))
    want = oracle.spla.spsolve(oracle.jacobian(w, DT, ops), f)
    for ref in (want_jax, want):
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-12


def test_solve_jacobian_sweeps():
    jg, tg = grids(8, 6)
    rng = np.random.default_rng(6)
    u, v = (1 + rng.uniform(size=(6, 8)) for _ in range(2))
    fu, fv = (rng.normal(size=(6, 8)) for _ in range(2))
    got = twf.solve_jacobian_sweeps(*map(to_torch, (u, v, fu, fv)), DT, tg)
    want = jwf.solve_jacobian_sweeps(*map(jnp.asarray, (u, v, fu, fv)), DT,
                                     jg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-13)


def test_skewed_ops_match_jax():
    jg, tg = grids(12, 10)
    jlay, tlay = skewed_pair(jg, tg)
    rng = np.random.default_rng(7)
    u, v, up, vp = (1 + rng.uniform(size=(10, 12)) for _ in range(4))

    def jskew(x):
        return jsk.to_skewed(jnp.asarray(x), jlay)

    def tskew(x):
        return tsk.to_skewed(to_torch(x), tlay)

    for x in (u, v):
        np.testing.assert_array_equal(tskew(x).numpy(),
                                      np.asarray(jskew(x)))
        np.testing.assert_array_equal(
            tsk.from_skewed(tskew(x), tlay).numpy(), x)

    jvalid = jsk.valid_mask(jlay, jnp.float64)
    tvalid = tsk.valid_mask(tlay, F64)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    jsrc = jsk.skewed_source(jlay, jg, MU[1], DT, jnp.float64)
    jlbc = jsk.skewed_inflow_bc(jlay, jg, MU[0], DT, jnp.float64)
    tsrc = tsk.skewed_source(tlay, tg, MU[1], DT, F64, "cpu")
    tlbc = tsk.skewed_inflow_bc(tlay, tg, MU[0], DT, F64, "cpu")
    for t, j in ((tsrc, jsrc), (tlbc, jlbc)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-13)

    got = tsk.skewed_step_constant(tskew(up), tskew(vp), DT, tg, tsrc, tlbc,
                                   tvalid)
    want = jsk.skewed_step_constant(jskew(up), jskew(vp), DT, jg, jsrc,
                                    jlbc, jvalid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-13)
    got_r = tsk.skewed_residual_iter(tskew(u), tskew(v), got[0], got[1], DT,
                                     tg, tvalid)
    want_r = jsk.skewed_residual_iter(jskew(u), jskew(v), want[0], want[1],
                                      DT, jg, jvalid)
    full_r = jsk.skewed_residual(jskew(u), jskew(v), jskew(up), jskew(vp),
                                 DT, jg, jlay, jsrc, jlbc, jvalid)
    for g, w, f in zip(got_r, want_r, full_r):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-13)
        np.testing.assert_allclose(g.numpy(), np.asarray(f), rtol=0,
                                   atol=1e-13)


def residual_inputs(seed, nx=12, ny=10):
    """JAX and port grids and layouts, and skewed numpy fields zero off the
    band: a step's start (up, vp), a state (u, v) near it and an update
    (du, dv)."""
    jg, tg = grids(nx, ny)
    jlay, tlay = skewed_pair(jg, tg)
    rng = np.random.default_rng(seed)
    band = np.asarray(jsk.valid_mask(jlay, jnp.float64))
    shape = (jlay.nd_pad, jlay.ny_pad)
    up, vp = (1 + 0.2 * rng.uniform(size=shape) for _ in range(2))
    u, v = (x + 0.01 * rng.normal(size=shape) for x in (up, vp))
    du, dv = (1e-3 * rng.normal(size=shape) for _ in range(2))
    return jg, tg, jlay, tlay, [x * band for x in (up, vp, u, v, du, dv)]


def port_step(tg, tlay, dtype, fields):
    """The port's source, inflow and band mask in `dtype`, the fields as
    CPU tensors of it, and the step constant by skewed_step_constant."""
    src = tsk.skewed_source(tlay, tg, MU[1], DT, dtype, "cpu")
    lbc = tsk.skewed_inflow_bc(tlay, tg, MU[0], DT, dtype, "cpu")
    valid = tsk.valid_mask(tlay, dtype, "cpu")
    up, vp, u, v, du, dv = (torch.as_tensor(x, dtype=dtype) for x in fields)
    cp = tsk.skewed_step_constant(up, vp, DT, tg, src, lbc, valid)
    return src, lbc, valid, (up, vp, u, v, du, dv), cp


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_step_constant_norm_on_the_cpu_is_the_composition(dtype):
    """On CPU tensors skewed_step_constant_norm is skewed_step_constant
    and the norm of r0, bit for bit."""
    _, tg, _, tlay, fields = residual_inputs(11)
    src, lbc, valid, (up, vp, *_), want = port_step(tg, tlay, dtype, fields)
    got = tsk.skewed_step_constant_norm(up, vp, DT, tg, tlay, src, lbc,
                                        valid, workspace=None)
    norm = torch.sqrt(torch.sum(want[2] * want[2])
                      + torch.sum(want[3] * want[3]))
    for g, w in zip(got, (*want, norm)):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("update", [True, False], ids=["update", "guess"])
def test_update_residual_on_the_cpu_is_the_composition(dtype, update):
    """On CPU tensors skewed_update_residual is the Newton loop's eager
    update, bit for bit: u - du, skewed_residual_iter, the norm and the
    stop expression (the guess: no update, no stagnation term)."""
    _, tg, _, tlay, fields = residual_inputs(12)
    _, _, valid, (_, _, u, v, du, dv), cp = port_step(tg, tlay, dtype,
                                                      fields)
    init = torch.sqrt(torch.sum(cp[2] * cp[2]) + torch.sum(cp[3] * cp[3]))
    rn_prev = 0.5 * init if update else None
    got = tsk.skewed_update_residual(
        u, v, du if update else None, dv if update else None, cp[0], cp[1],
        DT, tg, tlay, valid, init_norm=init, rn_prev=rn_prev, cutoff=1e-12,
        workspace=None)
    if update:
        u, v = u - du, v - dv
    ru, rv = tsk.skewed_residual_iter(u, v, cp[0], cp[1], DT, tg, valid)
    rn = torch.sqrt(torch.sum(ru * ru) + torch.sum(rv * rv))
    stop = rn / init < 1e-12
    if update:
        stop = stop | (rn > 0.99 * rn_prev)
    for g, w in zip(got, (u, v, ru, rv, rn, stop)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("update", [True, False], ids=["update", "guess"])
def test_fused_residual_functions_match_jax(update):
    """The step constant with its norm and an update with its residual and
    norm, against the JAX package's skewed_step_constant and
    skewed_residual_iter at the state the update gives."""
    jg, tg, jlay, tlay, fields = residual_inputs(13)
    src, lbc, valid, (up, vp, u, v, du, dv), _ = port_step(tg, tlay, F64,
                                                           fields)
    jup, jvp, ju, jv, jdu, jdv = map(jnp.asarray, fields)
    jvalid = jsk.valid_mask(jlay, jnp.float64)
    jsrc = jsk.skewed_source(jlay, jg, MU[1], DT, jnp.float64)
    jlbc = jsk.skewed_inflow_bc(jlay, jg, MU[0], DT, jnp.float64)

    def jnorm(a, b):
        return float(jnp.sqrt(jnp.sum(a * a) + jnp.sum(b * b)))

    want_c = jsk.skewed_step_constant(jup, jvp, DT, jg, jsrc, jlbc, jvalid)
    got_c = tsk.skewed_step_constant_norm(up, vp, DT, tg, tlay, src, lbc,
                                          valid, workspace=None)
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-13)
    assert abs(float(got_c[4]) - jnorm(*want_c[2:])) <= 1e-13 * jnorm(
        *want_c[2:])
    if update:
        ju, jv = ju - jdu, jv - jdv
    want = jsk.skewed_residual_iter(ju, jv, want_c[0], want_c[1], DT, jg,
                                    jvalid)
    got = tsk.skewed_update_residual(
        u, v, du if update else None, dv if update else None, got_c[0],
        got_c[1], DT, tg, tlay, valid, init_norm=got_c[4], rn_prev=None,
        cutoff=1e-12, workspace=None)
    for g, w in zip(got[:4], (ju, jv, *want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-13)
    assert abs(float(got[4]) - jnorm(*want)) <= 1e-13 * jnorm(*want)


@pytest.mark.parametrize("branch,scale,stagnation,stop", [
    ("neither", (1e-3, 1e3), True, False),
    ("cutoff", (1e15, 1e3), True, True),
    ("stagnation", (1e-3, 1e-3), True, True),
    ("no stagnation term", (1e-3, 1e-3), False, False),
])
def test_stop_flag_agrees_with_the_eager_expression(branch, scale,
                                                    stagnation, stop):
    """The stop flag is rn / init_norm < cutoff, or rn > 0.99 rn_prev when
    rn_prev is given, in each branch."""
    _, tg, _, tlay, fields = residual_inputs(14)
    _, _, valid, (_, _, u, v, du, dv), cp = port_step(tg, tlay, F64, fields)
    r0 = torch.sqrt(torch.sum(cp[2] * cp[2]) + torch.sum(cp[3] * cp[3]))
    init, rn_prev = r0 * scale[0], r0 * scale[1]
    got = tsk.skewed_update_residual(
        u, v, du, dv, cp[0], cp[1], DT, tg, tlay, valid, init_norm=init,
        rn_prev=rn_prev if stagnation else None, cutoff=1e-12,
        workspace=None)
    rn = got[4]
    want = rn / init < 1e-12
    if stagnation:
        want = want | (rn > 0.99 * rn_prev)
    assert bool(got[5]) == bool(want) == stop, branch


def skewed_inputs(jlay, seed, dtype=np.float64):
    """Skewed u, v in [1, 2] and a normal rhs, zero off the band."""
    rng = np.random.default_rng(seed)
    band = np.asarray(jsk.valid_mask(jlay, jnp.float64))
    shape = (jlay.nd_pad, jlay.ny_pad)
    return [(a * band).astype(dtype) for a in (
        1 + rng.uniform(size=shape), 1 + rng.uniform(size=shape),
        rng.normal(size=shape), rng.normal(size=shape))]


def test_solve_skewed_ref_f64_matches_lax():
    jg, tg = grids(11, 7)
    jlay, tlay = skewed_pair(jg, tg)
    arrs = skewed_inputs(jlay, 2)
    got = tsk.solve_skewed_ref(*map(to_torch, arrs), DT, tg, tlay)
    want = jsk.solve_skewed_lax(*map(jnp.asarray, arrs), DT, jg, jlay)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def test_solve_skewed_ref_f32_matches_pallas_interpret():
    """24 diagonals in blocks of 8: the Pallas kernel (interpret mode)
    carries the chain across 3 sequential grid steps."""
    jg, tg = grids(14, 11)
    jlay, tlay = skewed_pair(jg, tg)
    assert jlay.nd_pad // 8 >= 3
    arrs = skewed_inputs(jlay, 3, np.float32)
    got = tsk.solve_skewed_ref(*map(to_torch, arrs), DT, tg, tlay)
    want = solve_skewed_pallas(*map(jnp.asarray, arrs), DT, jg, jlay,
                               block=8, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=1e-6)


def test_solve_inverts_own_jacobian():
    """J(u, v) applied to solve(f) gives back f, with the port's own
    apply_jacobian (13x5, f64)."""
    _, tg = grids(13, 5)
    rng = np.random.default_rng(8)
    u, v = (to_torch(1 + rng.uniform(size=(5, 13))) for _ in range(2))
    fu, fv = (to_torch(rng.normal(size=(5, 13))) for _ in range(2))
    du, dv = twf.solve_jacobian_wavefront(u, v, fu, fv, DT, tg)
    ju, jv = apply_jacobian(u, v, du, dv, DT, tg)
    np.testing.assert_allclose(ju.numpy(), fu.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(jv.numpy(), fv.numpy(), rtol=0, atol=1e-12)


# (nx, ny) of the unskewed solve's tests, as on the card: ny far above nx
# and no multiple of the kernel's 32-row warps (3, 100), and ny above 768,
# more warps than one CTA of the kernel's cluster holds (4, 800)
UNSKEWED_SHAPES = [(8, 6), (13, 5), (5, 40), (40, 5), (3, 100), (4, 800)]


def unskewed_inputs(nx, ny, seed, dtype):
    """u, v in [1, 2] and a normal right-hand side, each (ny, nx)."""
    rng = np.random.default_rng(seed)
    return [a.astype(dtype) for a in (
        1 + rng.uniform(size=(ny, nx)), 1 + rng.uniform(size=(ny, nx)),
        rng.normal(size=(ny, nx)), rng.normal(size=(ny, nx)))]


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("shape", UNSKEWED_SHAPES)
def test_unskewed_ref_f32_matches_pallas_interpret(shape):
    """solve_jacobian_wavefront_ref, the plain version of the B2 kernel,
    against the JAX package's B2 (solve_jacobian_wavefront_pallas in
    interpret mode, blocks of 8 diagonals) in float32: within 1e-5 in
    norm, the f32 tolerance of the card's kernels. The two differ in
    rounding only: the Pallas kernel multiplies by the block inverse's
    entries, the plain loop divides by the determinant."""
    nx, ny = shape
    jg, tg = grids(nx, ny)
    arrs = unskewed_inputs(nx, ny, nx + ny, np.float32)
    got = twf.solve_jacobian_wavefront_ref(*map(to_torch, arrs), DT, tg)
    want = solve_jacobian_wavefront_pallas(*map(jnp.asarray, arrs), DT, jg,
                                           block=8, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (ny, nx)
        assert rel_norm(g.numpy(), w) <= 1e-5


@pytest.mark.parametrize("shape", UNSKEWED_SHAPES)
def test_unskewed_ref_f64_matches_lax(shape):
    """solve_jacobian_wavefront_ref against the JAX package's lax.scan
    solve (ops/wavefront.solve_jacobian_wavefront) in float64: within
    1e-12 in norm, rounding only."""
    nx, ny = shape
    jg, tg = grids(nx, ny)
    arrs = unskewed_inputs(nx, ny, nx * ny, np.float64)
    got = twf.solve_jacobian_wavefront_ref(*map(to_torch, arrs), DT, tg)
    want = jwf.solve_jacobian_wavefront(*map(jnp.asarray, arrs), DT, jg)
    for g, w in zip(got, want):
        assert g.dtype == F64 and tuple(g.shape) == (ny, nx)
        assert rel_norm(g.numpy(), w) <= 1e-12


def test_unskewed_solve_on_the_cpu_is_the_plain_version():
    """On CPU tensors solve_jacobian_wavefront is its plain version, bit
    for bit, and launches nothing."""
    _, tg = grids(13, 5)
    args = [to_torch(a) for a in unskewed_inputs(13, 5, 9, np.float64)]
    before = (cw.LAUNCHES, cw.UNSKEWED_LAUNCHES)
    got = twf.solve_jacobian_wavefront(*args, DT, tg)
    want = twf.solve_jacobian_wavefront_ref(*args, DT, tg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (cw.LAUNCHES, cw.UNSKEWED_LAUNCHES) == before


def test_unskewed_solve_off_the_cpu_never_takes_the_plain_version(
        monkeypatch):
    """A tensor off the CPU goes to the kernel's wrapper, which raises
    where it cannot run (here a meta tensor): no fallback to the plain
    version, no launch counted."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version was reached")

    monkeypatch.setattr(twf, "solve_jacobian_wavefront_ref", plain)
    _, tg = grids(8, 6)
    meta = [torch.empty((6, 8), dtype=F64, device="meta") for _ in range(4)]
    before = cw.UNSKEWED_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        twf.solve_jacobian_wavefront(*meta, DT, tg)
    assert cw.UNSKEWED_LAUNCHES == before
