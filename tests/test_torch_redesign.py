"""The logic of the Hopper designs of B1 and B3 that needs no card.

B1 (csrc/wavefront.cu) cuts the skewed rows into bands (its warps) that
each walk all diagonals and take from the band below only the carry of
that band's last row, one diagonal back. `solve_skewed_banded` below is
that schedule in plain PyTorch: it must equal ops/skewed.solve_skewed_ref
bit for bit in float64 (the same arithmetic per cell, whatever the bands),
and the JAX package's Pallas kernel (interpret mode) within the tolerance
of tests/test_torch_wavefront.py (float32: rtol 2e-6, atol 1e-6).

B3 (csrc/gn_full.cu) deals chunks of padded cells to persistent CTAs by
the geometry of ops/cuda_gn_full.full_geometry: every cell is covered
once, ragged ends included. The plain version gn_full_ref is held against
the JAX kernel at a k + 1 that is no multiple of 64 (float32 Grams rtol
2e-4 / atol 3e-4, JAX's own tolerance).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import pallas_gn_full as jgf
from finitedifference_tpu.ops import skewed as jsk
from finitedifference_tpu.ops.pallas_wavefront import solve_skewed_pallas
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.convert import grid_from_jax
from finitedifference_tpu_torch.ops import cuda_gn_full as cgf
from finitedifference_tpu_torch.ops import gn_full as tgf
from finitedifference_tpu_torch.ops import skewed as tsk

to_torch = functools.partial(convert.to_torch, device="cpu")

DT = 0.07
F32, F64 = torch.float32, torch.float64


# ----------------------------------------------------------------------
# B1: the banded schedule
# ----------------------------------------------------------------------

def solve_skewed_banded(su, sv, sfu, sfv, dt, grid, lay, band):
    """solve_skewed_ref's arithmetic, one band of `band` rows after the
    other: a band runs over all diagonals and sees of the band below only
    (du, dv, u, v) of its last row on the diagonal before."""
    kx = 0.5 * dt / grid.dx
    ky = 0.5 * dt / grid.dy
    valid = tsk._band(lay, su.device)
    sdu = torch.empty_like(sfu)
    sdv = torch.empty_like(sfv)
    zero = torch.zeros((), dtype=su.dtype)
    # what the band below handed up, per diagonal: none below row 0
    handed = [(zero, zero, zero, zero)] * lay.nd_pad
    for lo in range(0, lay.ny_pad, band):
        rows = slice(lo, min(lo + band, lay.ny_pad))
        u, v = su[:, rows], sv[:, rows]
        b11 = 1.0 + kx * u + 0.5 * ky * v
        b12 = 0.5 * ky * u
        b21 = 0.5 * kx * v
        b22 = 1.0 + ky * v + 0.5 * kx * u
        det = b11 * b22 - b12 * b21
        du_p = dv_p = u_p = v_p = torch.zeros_like(u[0])
        below = (zero, zero, zero, zero)   # the carry before diagonal 0
        hands = []
        for d in range(lay.nd_pad):
            du_s, dv_s, u_s, v_s = (
                torch.cat((b.reshape(1), x[:-1]))
                for b, x in zip(below, (du_p, dv_p, u_p, v_p)))
            rhs_u = sfu[d, rows] + kx * u_p * du_p \
                + 0.5 * ky * (v_s * du_s + u_s * dv_s)
            rhs_v = sfv[d, rows] + 0.5 * kx * (v_p * du_p + u_p * dv_p) \
                + ky * v_s * dv_s
            on = valid[d, rows]
            du_p = torch.where(on, (b22[d] * rhs_u - b12[d] * rhs_v)
                               / det[d], 0.0)
            dv_p = torch.where(on, (b11[d] * rhs_v - b21[d] * rhs_u)
                               / det[d], 0.0)
            sdu[d, rows] = du_p
            sdv[d, rows] = dv_p
            u_p, v_p = u[d], v[d]
            hands.append((du_p[-1], dv_p[-1], u_p[-1], v_p[-1]))
            below = handed[d]
        handed = hands
    return sdu, sdv


def skewed_case(nx, ny, seed, dtype):
    jg = JGrid2D(nx=nx, ny=ny, x_up=100.0, y_up=100.0)
    tg = grid_from_jax(jg)
    jlay = jsk.make_layout(jg, block=8)
    tlay = tsk.make_layout(tg, block=8)
    assert tuple(jlay) == tuple(tlay)
    rng = np.random.default_rng(seed)
    band = np.asarray(jsk.valid_mask(jlay, jnp.float64))
    shape = (jlay.nd_pad, jlay.ny_pad)
    arrs = [(a * band).astype(dtype) for a in (
        1 + rng.uniform(size=shape), 1 + rng.uniform(size=shape),
        rng.normal(size=shape), rng.normal(size=shape))]
    return jg, tg, jlay, tlay, arrs


# nx = ny-ish, ny >> nx and ny << nx; ny_pad is 128 in all three
GRIDS = [(14, 11), (5, 40), (40, 5)]


@pytest.mark.parametrize("band", [32, 96, 100, 128],
                         ids=["warp", "three_warps", "not_dividing", "one"])
@pytest.mark.parametrize("nx,ny", GRIDS)
def test_banded_solve_equals_plain_bit_for_bit(nx, ny, band):
    """Any cut of the rows into bands gives the plain solve's bits in
    float64, exact zeros off the band included: a band needs nothing of
    the band below but its last row, one diagonal back."""
    _, tg, _, tlay, arrs = skewed_case(nx, ny, 5, np.float64)
    assert (tlay.ny_pad % band == 0) == (band != 100 and band != 96)
    args = [to_torch(a) for a in arrs]
    got = solve_skewed_banded(*args, DT, tg, tlay, band)
    want = tsk.solve_skewed_ref(*args, DT, tg, tlay)
    off = ~tsk._band(tlay)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert bool((g[off] == 0).all())


@pytest.mark.parametrize("band", [32, 100], ids=["warp", "not_dividing"])
@pytest.mark.parametrize("nx,ny", GRIDS)
def test_banded_solve_matches_pallas_interpret(nx, ny, band):
    """The banded schedule in float32 against the JAX package's kernel
    (interpret mode, blocks of 8 diagonals)."""
    jg, tg, jlay, tlay, arrs = skewed_case(nx, ny, 6, np.float32)
    got = solve_skewed_banded(*(to_torch(a) for a in arrs), DT, tg, tlay,
                              band)
    want = solve_skewed_pallas(*map(jnp.asarray, arrs), DT, jg, jlay,
                               block=8, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == F32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=1e-6)


# ----------------------------------------------------------------------
# B3: the geometry of the persistent CTAs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_pad,k,itemsize,n_sm", [
    (565504, 95, 4, 132),     # 750^2, the main path
    (565504, 95, 8, 132),
    (64512, 95, 4, 132),      # 250^2: 2016 chunks over 132 CTAs
    (23104, 40, 4, 132),      # 150 x 149, k + 1 = 41
    (23104, 40, 8, 132),
    (120, 6, 4, 132),         # fewer chunks than CTAs, a ragged last chunk
    (4608, 150, 4, 7),        # kp = 256, an odd card
    (4608, 150, 8, 7),
    (1000, 127, 8, 132),      # all 128 lanes live
], ids=lambda v: str(v))
def test_full_geometry_covers_every_cell_once(n_pad, k, itemsize, n_sm):
    geo = cgf.full_geometry(n_pad, k, itemsize, n_sm)
    assert geo.lanes % cgf.LANE_STEP == 0
    assert k + 1 <= geo.lanes < k + 1 + cgf.LANE_STEP
    threads, ctas_per_sm, max_chunk = cgf.TUNING[itemsize]
    assert geo.chunk in cgf.CHUNK_CELLS and geo.chunk <= max_chunk
    assert cgf.shared_bytes(geo.chunk, geo.lanes, itemsize) * ctas_per_sm \
        <= cgf.SHARED_BUDGET
    assert 1 <= geo.n_ctas <= ctas_per_sm * n_sm
    assert geo.n_chunks == -(-n_pad // geo.chunk)
    # whole groups of one thread per 8x8 tile, a piece of a row per thread
    tiles = (geo.lanes // 8) * (geo.lanes // 8 + 1) // 2
    group = min(-(-tiles // 32) * 32, cgf.MAX_GROUP)
    assert geo.threads % group == 0 and geo.threads >= group
    assert geo.lanes // (16 // itemsize) <= geo.threads
    seen = np.zeros(n_pad, dtype=np.int64)
    chunks = np.zeros(geo.n_chunks, dtype=np.int64)
    for cta in range(geo.n_ctas):
        walk = list(geo.cta_chunks(cta))
        assert walk == sorted(walk)
        for c in walk:
            chunks[c] += 1
            cells = geo.chunk_cells(c, n_pad)
            assert 0 < len(cells) <= geo.chunk
            seen[cells.start:cells.stop] += 1
    assert (chunks == 1).all() and (seen == 1).all()
    # the shares differ by one chunk at most
    shares = [len(geo.cta_chunks(cta)) for cta in range(geo.n_ctas)]
    assert max(shares) - min(shares) <= 1


def test_full_geometry_is_fixed_by_the_shape():
    """The same shape gives the same cut: nothing depends on a run."""
    a = cgf.full_geometry(64512, 95, 4, 132)
    assert a == cgf.full_geometry(64512, 95, 4, 132)
    assert a.lanes == 96 and a.n_ctas == cgf.TUNING[4][1] * 132
    with pytest.raises(ValueError, match="shared memory"):
        cgf.full_geometry(64512, 3000, 8, 132)


@pytest.mark.parametrize("k", [40, 70])
def test_gn_full_ref_matches_pallas_kernel_off_the_lane_grid(k):
    """gn_full_ref against the JAX kernel (interpret mode) where k + 1 is
    a multiple neither of 64 nor of 16: first=True (Gram and step
    constant), then first=False with that constant, over 3 row tiles."""
    assert (k + 1) % 16 and (k + 1) % 64
    jg = JGrid2D(nx=12, ny=10)
    tg = grid_from_jax(jg)
    n = jg.n_cells
    rng = np.random.default_rng(k)
    basis = (rng.normal(size=(2 * n, k)) / n ** 0.5).astype(np.float32)
    vu, vv, _ = jgf.pad_basis_full(jnp.asarray(basis), jg, 4)
    dmask = jgf.row_mask(jg, 4)
    nxp, _, tile = jgf.full_layout(jg, 4)
    assert vu.shape == (3 * tile, 128)
    yp = ((1 + 0.1 * rng.normal(size=k)) * (n / k) ** 0.5).astype(np.float32)
    y = yp + 0.01 * rng.normal(size=k).astype(np.float32)
    slbc = (0.01 * rng.uniform(size=(vu.shape[0], 1))).astype(np.float32) \
        * np.asarray(dmask)
    hdx, hdy = 0.5 * DT / jg.dx, 0.5 * DT / jg.dy
    assert cgf.live_lanes(k) not in (k + 1, 64, 128)

    jg0, jcp = jgf.gn_full_first_pallas(vu, vv, jnp.asarray(yp),
                                        jnp.asarray(slbc), dmask, k, nxp,
                                        tile, hdx, hdy, interpret=True)
    tg0, tcp = tgf.gn_full_first(to_torch(vu), to_torch(vv), to_torch(yp),
                                 to_torch(slbc), to_torch(dmask), k, nxp,
                                 tile, hdx, hdy)
    np.testing.assert_allclose(tg0.numpy(), np.asarray(jg0), rtol=2e-4,
                               atol=3e-4)
    np.testing.assert_allclose(tcp.numpy(), np.asarray(jcp), rtol=1e-5,
                               atol=1e-6)
    jgx = jgf.gn_full_system_pallas(vu, vv, jnp.asarray(y), jcp, dmask, k,
                                    nxp, tile, hdx, hdy, interpret=True)
    tgx = tgf.gn_full_system(to_torch(vu), to_torch(vv), to_torch(y), tcp,
                             to_torch(dmask), k, nxp, tile, hdx, hdy)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=2e-4,
                               atol=3e-4)
    assert torch.all(tgx[k + 1:] == 0) and torch.all(tgx[:, k + 1:] == 0)
