"""The full-grid Gauss-Newton system (B3) and the streaming PROM engine
against the JAX package on the CPU.

The port's plain version (ops/gn_full.gn_full_ref, what a CPU tensor
runs) is held against JAX's Pallas kernel in interpret mode on the same
padded inputs, over 3 row tiles (nx=12, ny=10, tile_rows=4), so the
south halo crosses tile boundaries; pallas_prom against JAX's
pallas_prom(interpret=True) with equal Gauss-Newton counts. Tolerances:
f32 Grams rtol 2e-4 / atol 3e-4 (JAX's own), the ||r||^2 corner
relative only (the dead-row check), f32 trajectories rtol 5e-4 /
atol 5e-6, f64 1e-12 relative.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu.ops import pallas_gn_full as jgf
from finitedifference_tpu.ops import stencil as jst
from finitedifference_tpu.rom import lspg_prom as jlspg
from finitedifference_tpu.rom_factored import pallas_prom as jpallas_prom
from finitedifference_tpu.rom_factored import (
    precompute_prom_pallas as jprecompute,
)
from finitedifference_tpu_torch import rom_factored as trf
from finitedifference_tpu_torch.convert import grid_from_jax
from finitedifference_tpu_torch.ops import gn_full as tgf
from finitedifference_tpu_torch.ops import stencil as tst
from finitedifference_tpu_torch.rom import lspg_prom as tlspg
from tests.test_rom import DT, MU, setup_problem
from finitedifference_tpu_torch import convert

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

F32, F64 = torch.float32, torch.float64


@pytest.fixture(scope="module")
def prom_problem():
    # nx=12, tile_rows=4: ny_pad=12, 3 tiles with south-halo traffic
    grid, _, _, w0, basis = setup_problem(nx=12, ny=10, num_steps=14, k=6)
    return grid, grid_from_jax(grid), w0, basis, basis.T @ w0


def slbc_pair(jgrid, tgrid):
    s2d = np.asarray(jst.source_term(jgrid, MU[1], DT, jnp.float32)) \
        + np.asarray(jst.inflow_bc_term(jgrid, MU[0], DT, jnp.float32))
    j = jnp.asarray(jgf.pad_field_full(s2d, jgrid, 4)[:, None])
    t = (tst.source_term(tgrid, MU[1], DT, F32, "cpu")
         + tst.inflow_bc_term(tgrid, MU[0], DT, F32, "cpu"))
    return j, tgf.pad_field_full(t, tgrid, 4)[:, None]


def test_layout_matches_jax(prom_problem):
    jg, tg, _, basis, _ = prom_problem
    assert tgf.full_layout(tg, 4) == jgf.full_layout(jg, 4)
    jvu, jvv, jtr = jgf.pad_basis_full(basis, jg, 4)
    tvu, tvv, ttr = tgf.pad_basis_full(to_torch(basis), tg, 4)
    assert ttr == jtr and tvu.dtype == F32
    np.testing.assert_array_equal(tvu.numpy(), np.asarray(jvu))
    np.testing.assert_array_equal(tvv.numpy(), np.asarray(jvv))
    np.testing.assert_array_equal(tgf.row_mask(tg, 4).numpy(),
                                  np.asarray(jgf.row_mask(jg, 4)))
    for nx, ny in ((750, 750), (250, 250), (16, 16)):
        from finitedifference_tpu.grid import Grid2D as JGrid2D
        g = JGrid2D(nx=nx, ny=ny)
        m = tgf.row_mask(grid_from_jax(g)).numpy()
        np.testing.assert_array_equal(m, np.asarray(jgf.row_mask(g)))


def kernel_inputs(prom_problem, seed=3):
    jg, tg, _, basis, y0 = prom_problem
    k = basis.shape[1]
    vu, vv, _ = jgf.pad_basis_full(basis, jg, 4)
    dmask = jgf.row_mask(jg, 4)
    nxp, _, tile = jgf.full_layout(jg, 4)
    rng = np.random.default_rng(seed)
    yp = np.asarray(y0, np.float32)
    y = yp + 0.01 * rng.normal(size=k).astype(np.float32)
    hdx, hdy = 0.5 * DT / jg.dx, 0.5 * DT / jg.dy
    return vu, vv, dmask, k, nxp, tile, yp, y, hdx, hdy


def test_gn_full_ref_matches_pallas_kernel(prom_problem):
    """first=True at yp (gext and the step constant cp), then
    first=False at y with that cp: the plain version against the Pallas
    kernel in interpret mode, over 3 tiles."""
    jg, tg = prom_problem[:2]
    vu, vv, dmask, k, nxp, tile, yp, y, hdx, hdy = kernel_inputs(
        prom_problem)
    assert vu.shape[0] // tile == 3
    jslbc, tslbc = slbc_pair(jg, tg)
    jg0, jcp = jgf.gn_full_first_pallas(vu, vv, jnp.asarray(yp), jslbc,
                                        dmask, k, nxp, tile, hdx, hdy,
                                        interpret=True)
    tg0, tcp = tgf.gn_full_first(to_torch(vu), to_torch(vv), to_torch(yp),
                                 tslbc, to_torch(dmask), k, nxp, tile, hdx,
                                 hdy)
    assert tg0.dtype == F64 and tg0.shape == (128, 128)
    np.testing.assert_allclose(tg0.numpy(), np.asarray(jg0), rtol=2e-4,
                               atol=3e-4)
    np.testing.assert_allclose(float(tg0[k, k]), float(jg0[k, k]),
                               rtol=1e-4)
    np.testing.assert_allclose(tcp.numpy(), np.asarray(jcp), rtol=1e-5,
                               atol=1e-6)
    # dead cells carry a zero step constant
    dead = to_torch(dmask)[:, 0] == 0
    assert torch.all(tcp[dead] == 0)

    jgx = jgf.gn_full_system_pallas(vu, vv, jnp.asarray(y), jcp, dmask, k,
                                    nxp, tile, hdx, hdy, interpret=True)
    tgx = tgf.gn_full_system(to_torch(vu), to_torch(vv), to_torch(y), tcp,
                             to_torch(dmask), k, nxp, tile, hdx, hdy)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=2e-4,
                               atol=3e-4)
    np.testing.assert_allclose(float(tgx[k, k]), float(jgx[k, k]),
                               rtol=1e-4)
    # lanes above k are exactly zero
    assert torch.all(tgx[k + 1:] == 0) and torch.all(tgx[:, k + 1:] == 0)


def test_gn_full_dead_rows_do_not_leak(prom_problem):
    """The ||r||^2 corner against the brute-force residual from the
    port's full-grid stencil ops, relatively (no atol): unmasked dead
    bottom rows would add an absolute term here (the JAX package's
    round-4 bug, +14% at 250^2)."""
    jg, tg, _, basis, _ = prom_problem
    vu, vv, dmask, k, nxp, tile, yp, y, hdx, hdy = kernel_inputs(
        prom_problem, seed=8)
    _, tslbc = slbc_pair(jg, tg)
    bf = to_torch(basis, dtype=F32)
    wp, w = bf @ to_torch(yp), bf @ to_torch(y)
    gext0, cp = tgf.gn_full_first(to_torch(vu), to_torch(vv), to_torch(yp),
                                  tslbc, to_torch(dmask), k, nxp, tile,
                                  hdx, hdy)
    gext = tgf.gn_full_system(to_torch(vu), to_torch(vv), to_torch(y), cp,
                              to_torch(dmask), k, nxp, tile, hdx, hdy)
    for g, state in ((gext0, wp), (gext, w)):
        r = tst.burgers_residual_flat(state, wp, MU[0], MU[1], DT, tg)
        jv = tst.jacobian_times_basis(state, bf, DT, tg)
        a = torch.cat((jv, r[:, None]), dim=1).double()
        ref = a.T @ a
        np.testing.assert_allclose(float(g[k, k]), float(ref[k, k]),
                                   rtol=1e-4)
        np.testing.assert_allclose(g[:k + 1, :k + 1].numpy(), ref.numpy(),
                                   rtol=2e-4, atol=3e-4)
    # without the mask the dead rows DO leak: the check above can fail
    leaky, _ = tgf.gn_full_ref(
        to_torch(vu), to_torch(vv), to_torch(yp), tslbc,
        torch.ones_like(to_torch(dmask)), k, nxp, tile, hdx, hdy, True)
    assert abs(float(leaky[k, k]) - float(gext0[k, k])) \
        > 1e-3 * float(gext0[k, k])


@pytest.mark.parametrize("tile_rows", [2, 4])
def test_gn_full_tiles_do_not_change_the_gram(prom_problem, tile_rows):
    """Per-tile partials summed in f64: 6 or 3 tiles give the same Gram
    as one tile (the several-tile check of the plain version)."""
    jg, tg, _, basis, y0 = prom_problem
    vu, vv, tr = tgf.pad_basis_full(to_torch(basis), tg, tile_rows)
    dm = tgf.row_mask(tg, tr)
    nxp, _, tile = tgf.full_layout(tg, tr)
    n_pad = vu.shape[0]
    y = to_torch(y0, dtype=F32)
    cp = 0.01 * torch.ones((n_pad, 2))
    args = (vu, vv, y, cp, dm, basis.shape[1], nxp)
    hd = (0.5 * DT / tg.dx, 0.5 * DT / tg.dy)
    many = tgf.gn_full_ref(*args, tile, *hd, False)[0]
    one = tgf.gn_full_ref(*args, n_pad, *hd, False)[0]
    assert n_pad // tile >= 3
    np.testing.assert_allclose(many.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_pallas_prom_matches_jax(prom_problem):
    """The streaming PROM engine against JAX's pallas_prom(interpret)
    at f32: trajectory and Gauss-Newton count."""
    jg, tg, w0, basis, y0 = prom_problem
    steps = 14
    jvu, jvv, jmask, _ = jprecompute(jg, basis, tile_rows=4)
    want = jpallas_prom(jg, jvu, jvv, jmask, jnp.asarray(y0, jnp.float32),
                        DT, steps, MU[0], MU[1], interpret=True)
    tvu, tvv, tmask, tr = trf.precompute_prom_pallas(tg, to_torch(basis),
                                                     tile_rows=4)
    got = trf.pallas_prom(tg, tvu, tvv, tmask, to_torch(y0, dtype=F32), DT,
                          steps, MU[0], MU[1], tile_rows=tr)
    assert got.red_coords.dtype == F32
    np.testing.assert_allclose(got.red_coords.numpy(),
                               np.asarray(want.red_coords), rtol=5e-4,
                               atol=5e-6)
    assert got.total_gn_its == int(want.total_gn_its)
    # one system call per update plus the stopping checks
    assert steps + got.total_gn_its >= got.gn_evals >= got.total_gn_its


def test_pallas_prom_unrolled_matches_jax(prom_problem):
    """unroll_its: a fixed budget of masked calls per step, no read-back,
    as JAX's unrolled pallas_prom."""
    jg, tg, w0, basis, y0 = prom_problem
    steps = 8
    jvu, jvv, jmask, _ = jprecompute(jg, basis, tile_rows=4)
    want = jpallas_prom(jg, jvu, jvv, jmask, jnp.asarray(y0, jnp.float32),
                        DT, steps, MU[0], MU[1], unroll_its=3,
                        interpret=True)
    tvu, tvv, tmask, tr = trf.precompute_prom_pallas(tg, to_torch(basis),
                                                     tile_rows=4)
    got = trf.pallas_prom(tg, tvu, tvv, tmask, to_torch(y0, dtype=F32), DT,
                          steps, MU[0], MU[1], unroll_its=3, tile_rows=tr)
    np.testing.assert_allclose(got.red_coords.numpy(),
                               np.asarray(want.red_coords), rtol=5e-4,
                               atol=5e-6)
    assert got.total_gn_its == int(want.total_gn_its)
    assert got.gn_evals == 3 * steps


def test_pallas_prom_f64_matches_jax_lspg(prom_problem):
    """In f64 (no Pallas counterpart: Mosaic has no f64) the streaming
    engine is the LSPG PROM with normal equations: JAX's f64 lspg_prom
    within 1e-12, equal counts."""
    jg, tg, w0, basis, y0 = prom_problem
    steps = 14
    want = jlspg(jg, jnp.asarray(w0), DT, steps, MU[0], MU[1],
                 jnp.asarray(basis), ls_method="normal")
    tvu, tvv, tmask, tr = trf.precompute_prom_pallas(
        tg, to_torch(basis), tile_rows=4, dtype=F64)
    got = trf.pallas_prom(tg, tvu, tvv, tmask, to_torch(y0), DT, steps,
                          MU[0], MU[1], tile_rows=tr)
    red, ref = got.red_coords.numpy(), np.asarray(want.red_coords)
    assert np.linalg.norm(red - ref) / np.linalg.norm(ref) < 1e-12
    assert got.total_gn_its == int(want.total_gn_its)
    # and the port's own lspg_prom agrees
    own = tlspg(tg, to_torch(w0), DT, steps, MU[0], MU[1], to_torch(basis),
                ls_method="normal")
    assert own.total_gn_its == got.total_gn_its


def test_pallas_prom_rejects_fused(prom_problem):
    jg, tg, w0, basis, y0 = prom_problem
    tvu, tvv, tmask, tr = trf.precompute_prom_pallas(tg, to_torch(basis))
    with pytest.raises(ValueError):
        trf.pallas_prom(tg, tvu, tvv, tmask, to_torch(y0, dtype=F32), DT,
                        2, MU[0], MU[1], ls_method="fused")
