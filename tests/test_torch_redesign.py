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

B6 (csrc/gn_traj.cu) runs one trajectory on a cluster of CTAs by the
geometry of ops/cuda_gn.traj_geometry: chunks of 32 cells go to the CTAs
in turn, each CTA sums its chunks' partial Grams in float64, and the
cluster adds the CTAs' partials in rank order. `cluster_system` below is
that reduction in plain PyTorch; run in place of the plain version's
system it matches trajectory_hprom_ref and the JAX kernel (interpret
mode) at tests/test_torch_traj.py's tolerances (f32 rel 1e-5, f64 rel
1e-10) with equal Gauss-Newton counts.

B7 (csrc/wavefront.cu) runs a segment on one CTA of warps that hold R
rows a lane and hand the carry of their top row to the warp above once a
block of K diagonals. `solve_seg_chained` below is that schedule in plain
PyTorch, warps in lock step one block apart, posts through a ring of
blocks: it equals solve_skewed_seg_ref bit for bit in float64 and the
JAX segment kernel (interpret mode) at tests/test_torch_seg.py's
tolerance (f32 rtol 1e-5, atol 1e-6).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import pallas_gn as jgn
from finitedifference_tpu.ops import pallas_gn_full as jgf
from finitedifference_tpu.ops import skewed as jsk
from finitedifference_tpu.ops.pallas_wavefront import (
    solve_skewed_pallas,
    solve_skewed_pallas_seg,
)
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.convert import grid_from_jax
from finitedifference_tpu_torch.ops import cuda_gn as cgn
from finitedifference_tpu_torch.ops import cuda_gn_full as cgf
from finitedifference_tpu_torch.ops import gn as tgn
from finitedifference_tpu_torch.ops import gn_full as tgf
from finitedifference_tpu_torch.ops import skewed as tsk
from tests.test_torch_gn import (  # noqa: F401 (mesh_problem: a fixture)
    mesh_problem,
    padded_pair,
)
from tests.test_torch_traj import jax_slbc

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


# ----------------------------------------------------------------------
# B6: the cluster's geometry and its reduction
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_p,k,itemsize", [
    (1536, 95, 4),    # the bench mesh, the main path
    (1536, 95, 8),
    (224, 150, 4),    # kp 256: 7 chunks, fewer than the CTAs
    (208, 60, 8),     # 7 chunks, the last one half full
    (304, 127, 8),    # all 128 lanes live, float64 at its limit
    (40, 12, 4),      # two chunks, 16 lanes
    (1000, 191, 4),   # the float32 limit, two tiles a thread
], ids=lambda v: str(v))
def test_traj_geometry_covers_every_cell_once(n_p, k, itemsize):
    geo = cgn.traj_geometry(n_p, k, itemsize)
    assert geo.lanes % cgn.TRAJ_LANE_STEP == 0
    assert k + 1 <= geo.lanes < k + 1 + cgn.TRAJ_LANE_STEP
    assert geo.lanes <= cgn.MAX_TRAJ_LANES[
        torch.float32 if itemsize == 4 else torch.float64]
    assert geo.cluster == cgn.TRAJ_CLUSTER == 8
    assert geo.n_chunks * cgn.TRAJ_CELLS >= n_p > (geo.n_chunks - 1) \
        * cgn.TRAJ_CELLS
    # every tile of the upper triangle has a thread in each group of at
    # most 160 (two tiles a thread above)
    assert geo.n_tiles() <= 2 * 160
    seen = np.zeros(n_p, dtype=np.int64)
    chunks = np.zeros(geo.n_chunks, dtype=np.int64)
    tiles = np.zeros(geo.n_tiles(), dtype=np.int64)
    for rank in range(geo.cluster):
        for c in geo.cta_chunks(rank):
            chunks[c] += 1
            cells = geo.chunk_cells(c, n_p)
            assert 0 < len(cells) <= cgn.TRAJ_CELLS
            seen[cells.start:cells.stop] += 1
        tiles[list(geo.cta_tiles(rank))] += 1
    assert (chunks == 1).all() and (seen == 1).all() and (tiles == 1).all()


def test_traj_geometry_is_fixed_by_the_shape():
    """The cut depends on the shape and the working type alone: there is
    no batch in it, so a point's sums are the same in any batch."""
    a = cgn.traj_geometry(1536, 95, 4)
    assert a == cgn.traj_geometry(1536, 95, 4)
    assert (a.lanes, a.n_chunks) == (96, 48)
    assert a.cta_chunks(3) == range(3, 48, cgn.TRAJ_CLUSTER)
    with pytest.raises(ValueError, match="shared memory"):
        cgn.traj_geometry(1536, 150, 8)


def cluster_system(n_ctas):
    """gn_system_ref as the cluster sums it: each chunk's partial Gram in
    the working type, the chunks of CTA r (r, r + n_ctas, ...) added in
    float64 in order, then the CTAs' sums added in rank order."""
    def system(p6c, y, cp, w_c, k, hdx, hdy, tile):
        assert tile == tgn.TRAJ_CELLS
        n_chunks = p6c.shape[1] // tile
        total = None
        for rank in range(n_ctas):
            part = torch.zeros((p6c.shape[2],) * 2, dtype=torch.float64)
            for c in range(rank, n_chunks, n_ctas):
                cells = slice(c * tile, (c + 1) * tile)
                part += ref_system(p6c[:, cells], y, cp[cells], w_c[cells],
                                   k, hdx, hdy, tile).double()
            total = part if total is None else total + part
        return total.to(p6c.dtype)
    return system


ref_system = tgn.gn_system_ref


@pytest.mark.parametrize("n_ctas", [cgn.TRAJ_CLUSTER, 3, 1])
def test_cluster_reduction_matches_ref_and_pallas(mesh_problem, monkeypatch,
                                                  n_ctas):
    """The cluster's reduction in place of the plain version's system:
    f32 against trajectory_hprom_ref and JAX's trajectory kernel
    (interpret), f64 against trajectory_hprom_ref; equal GN counts."""
    p = mesh_problem
    k = p["basis"].shape[1]
    jp6p, jwgt, tp6p, twgt = padded_pair(p)
    y0 = np.asarray(p["y0"], np.float32)
    slbc = jax_slbc(p["jg"], p["jmesh"], jp6p.shape[1], (4.75, 0.02))
    hdx, hdy = 0.5 * DT / p["jg"].dx, 0.5 * DT / p["jg"].dy
    steps = 12
    args = (tp6p, to_torch(y0), to_torch(slbc), twgt, k, hdx, hdy, steps)
    want = tgn.trajectory_hprom_ref(*args)
    jys, jits = jgn.trajectory_hprom_pallas(
        jp6p, jnp.asarray(y0), jnp.asarray(slbc), jwgt, k, hdx, hdy, steps,
        interpret=True)
    _, _, tp64, twgt64 = padded_pair(p, dtype=F64)
    args64 = (tp64, to_torch(p["y0"]), to_torch(slbc).double(), twgt64, k,
              hdx, hdy, steps)
    want64 = tgn.trajectory_hprom_ref(*args64)
    monkeypatch.setattr(tgn, "gn_system_ref", cluster_system(n_ctas))
    got = tgn.trajectory_hprom_ref(*args)
    got64 = tgn.trajectory_hprom_ref(*args64)

    def rel(a, b):
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                     / np.linalg.norm(np.asarray(b)))

    assert rel(got.ys.numpy(), want.ys.numpy()) <= 1e-5
    assert rel(got.ys.numpy(), np.asarray(jys)) <= 1e-5
    assert int(got.its) == int(want.its) == int(jits)
    assert rel(got64.ys.numpy(), want64.ys.numpy()) <= 1e-10
    assert int(got64.its) == int(want64.its)
    assert int(got64.evals) == int(want64.evals)


# ----------------------------------------------------------------------
# B7: the chained warps of a segment
# ----------------------------------------------------------------------

def solve_seg_chained(su, sv, sfu, sfv, dt, grid, lay, n_seg, overlap,
                      rows_per_lane, block, ring=4):
    """solve_skewed_seg_ref's arithmetic in the kernel's schedule: a
    segment's rows in warps of 32 * rows_per_lane rows, in lock step one
    block of `block` diagonals apart; a warp's top-row carries go, one
    post a diagonal, into a ring of `ring` blocks of the warp above, which
    reads block m's posts (and keeps the last post of block m - 1) while
    the warp below writes block m + 1."""
    kx = 0.5 * dt / grid.dx
    ky = 0.5 * dt / grid.dy
    valid = tsk._band(lay, su.device)
    seg_len = tsk.segment_length(lay, n_seg)
    band = 32 * rows_per_lane
    n_warps = -(-lay.ny_pad // band)
    zero = torch.zeros((), dtype=su.dtype)
    sdu = torch.empty_like(sfu)
    sdv = torch.empty_like(sfv)
    for g in range(n_seg):
        d_own = g * seg_len
        d_begin = max(0, d_own - overlap)
        d_end = min(d_own + seg_len, lay.nd_pad)
        if d_own >= d_end:
            continue
        n_blocks = -(-(d_end - d_begin) // block)
        rows = [slice(w * band, min((w + 1) * band, lay.ny_pad))
                for w in range(n_warps)]
        carry = [[torch.zeros(r.stop - r.start, dtype=su.dtype)
                  for _ in range(4)] for r in rows]
        boxes = [[None] * ring for _ in rows]      # written by the warp below
        last = [(zero,) * 4 for _ in rows]
        for tau in range(n_blocks + n_warps - 1):
            for w, r in enumerate(rows):
                m = tau - w
                if not 0 <= m < n_blocks:
                    continue
                d0 = d_begin + m * block
                n_diag = min(block, d_end - d0)
                posts = []
                for i in range(n_diag):
                    d = d0 + i
                    du_p, dv_p, u_p, v_p = carry[w]
                    if w == 0:
                        below = (zero,) * 4
                    elif i == 0:
                        below = last[w]
                    else:
                        below = boxes[w][m % ring][i - 1]
                    du_s, dv_s, u_s, v_s = (
                        torch.cat((b.reshape(1), x[:-1]))
                        for b, x in zip(below, (du_p, dv_p, u_p, v_p)))
                    u, v = su[d, r], sv[d, r]
                    b11 = 1.0 + kx * u + 0.5 * ky * v
                    b12 = 0.5 * ky * u
                    b21 = 0.5 * kx * v
                    b22 = 1.0 + ky * v + 0.5 * kx * u
                    det = b11 * b22 - b12 * b21
                    rhs_u = sfu[d, r] + kx * u_p * du_p \
                        + 0.5 * ky * (v_s * du_s + u_s * dv_s)
                    rhs_v = sfv[d, r] + 0.5 * kx * (v_p * du_p + u_p * dv_p) \
                        + ky * v_s * dv_s
                    on = valid[d, r]
                    du = torch.where(on, (b22 * rhs_u - b12 * rhs_v) / det,
                                     0.0)
                    dv = torch.where(on, (b11 * rhs_v - b21 * rhs_u) / det,
                                     0.0)
                    if d >= d_own:
                        sdu[d, r] = du
                        sdv[d, r] = dv
                    carry[w] = [du, dv, u, v]
                    posts.append((du[-1], dv[-1], u[-1], v[-1]))
                if w > 0:
                    last[w] = boxes[w][m % ring][n_diag - 1]
                    boxes[w][m % ring] = None         # the block is free
                if w + 1 < n_warps:
                    assert boxes[w + 1][m % ring] is None
                    boxes[w + 1][m % ring] = posts
    return sdu, sdv


SEG_SCHEDULES = [(1, 8), (2, 4), (1, 3), (6, 8)]


@pytest.mark.parametrize("rows_per_lane,block", SEG_SCHEDULES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("nx,ny,n_seg,overlap", [
    (14, 11, 4, 6),     # ny_pad 128 = 4 warps of 32 rows
    (5, 40, 5, 20),     # ny far above nx, overlap >= seg_len, n_seg not
                        # dividing nd_pad
    (40, 5, 5, 0),      # ny far below nx, overlap 0
    (13, 5, 14, 3),     # trailing segments that own nothing
])
def test_chained_seg_equals_plain_bit_for_bit(nx, ny, n_seg, overlap,
                                              rows_per_lane, block):
    """Any cut of a segment's rows into chained warps gives the plain
    segment solve's bits in float64, exact zeros off the band included."""
    _, tg, _, tlay, arrs = skewed_case(nx, ny, 7, np.float64)
    args = [to_torch(a) for a in arrs]
    seg_len = tsk.segment_length(tlay, n_seg)
    assert (nx, ny, n_seg) != (5, 40, 5) or (
        overlap >= seg_len and tlay.nd_pad % n_seg)
    assert (nx, ny, n_seg) != (13, 5, 14) or (n_seg - 1) * seg_len \
        >= tlay.nd_pad
    got = solve_seg_chained(*args, DT, tg, tlay, n_seg, overlap,
                            rows_per_lane, block)
    want = tsk.solve_skewed_seg_ref(*args, DT, tg, tlay, n_seg=n_seg,
                                    overlap=overlap)
    off = ~tsk._band(tlay)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert bool((g[off] == 0).all())


@pytest.mark.parametrize("rows_per_lane,block", [(1, 8), (6, 8)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("n_seg,overlap", [(4, 16), (3, 8)])
def test_chained_seg_matches_pallas_seg(n_seg, overlap, rows_per_lane,
                                        block):
    """The chained schedule in float32 against the JAX package's segment
    kernel (interpret mode) on tests/test_torch_seg.py's 24x16 problem."""
    jg = JGrid2D(nx=24, ny=16, x_up=100.0, y_up=100.0)
    jlay = jsk.make_layout(jg, block=8)
    rng = np.random.default_rng(8)
    arrs = [np.asarray(jsk.to_skewed(jnp.asarray(
        1 + rng.uniform(size=(jg.ny, jg.nx))), jlay)).astype(np.float32)
        for _ in range(4)]
    tg = grid_from_jax(jg)
    tlay = convert.layout_from_jax(jlay)
    want = solve_skewed_pallas_seg(*map(jnp.asarray, arrs), DT, jg, jlay,
                                   n_seg=n_seg, overlap=overlap,
                                   interpret=True)
    got = solve_seg_chained(*(to_torch(a) for a in arrs), DT, tg, tlay,
                            n_seg, overlap, rows_per_lane, block)
    for g, w in zip(got, want):
        assert g.dtype == F32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
