"""The one-launch design of the sampled Gauss-Newton kernels (B4, B5:
csrc/gn_sampled.cu), on the CPU.

The kernels run only on a card (tests/test_torch_cuda_gn.py holds them
against their plain versions there). What their design rests on is
checked here:
- ops/cuda_gn.sampled_geometry, the kernel's cut of a system: every cell
  in exactly one chunk, every chunk in one CTA of each part, every tile
  in one part, one wave of clusters on 132 SMs, each buffer of a CTA's
  shared memory within 227 KB;
- a plain model of the kernel's sums (chunk Grams, per-CTA sums, float64
  sums over a cluster and then over the clusters, each CTA's slice placed
  back into the Gram) against gn_system_ref and the JAX Pallas kernel;
- pallas_hprom makes one workspace a run and gets fresh outputs from
  every call, so the dynamic loop's counts stay JAX's run after run.

Tolerances: float64 1e-12 relative; float32 5e-5 relative (chunk Grams of
16 cells against the plain version's tiles, summed in float64).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu import rom_factored as jrf
from finitedifference_tpu.ops import pallas_gn as jgn
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch import rom_factored as trf
from finitedifference_tpu_torch.ops import cuda_gn as cgn
from finitedifference_tpu_torch.ops import gn as tgn
from tests.test_rom import DT, MU
from tests.test_torch_gn import (  # noqa: F401 (mesh_problem: a fixture)
    TILE,
    mesh_problem,
    padded_pair,
)

to_torch = functools.partial(convert.to_torch, device="cpu")

F32, F64 = torch.float32, torch.float64
SMS = 132   # streaming multiprocessors of an H100


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ----------------------------------------------------------------------
# the geometry
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_p,k,itemsize", [
    (1536, 95, 4),    # the bench mesh, the main path
    (1536, 95, 8),
    (1000, 150, 4),   # 150 modes: a short last chunk, uneven CTAs
    (1000, 150, 8),
    (2600, 40, 4),    # more chunks than CTAs
    (40, 6, 8),       # one cluster, most CTAs idle
    (2000, 223, 4),   # two parts of the tiles
    (600, 200, 8),    # two parts, chunks of 8 cells
    (400, 255, 8),    # three parts: the step's largest k
], ids=lambda v: str(v))
def test_sampled_geometry_covers_every_cell_once(n_p, k, itemsize):
    geo = cgn.sampled_geometry(n_p, k, itemsize)
    assert geo.lanes % cgn.SAMPLED_LANE_STEP == 0
    assert k + 1 <= geo.lanes < k + 1 + cgn.SAMPLED_LANE_STEP
    nt = geo.lanes // 8
    assert geo.n_tiles == nt * (nt + 1) // 2
    # the parts take every tile once, a thread for every tile of a part
    # in each group
    tiles = np.zeros(geo.n_tiles, dtype=np.int64)
    for part in range(geo.n_parts):
        r = geo.part_tile_range(part)
        assert 0 < len(r) <= geo.part_tiles <= cgn.SAMPLED_PART_TILES
        tiles[r.start:r.stop] += 1
    assert (tiles == 1).all()
    assert geo.group >= geo.part_tiles and geo.group % 32 == 0
    assert geo.threads % geo.group == 0 and geo.threads >= 128
    assert geo.threads <= cgn.SAMPLED_THREADS[itemsize]
    # one wave of clusters over all parts
    assert geo.cluster == cgn.SAMPLED_CLUSTER == 8
    n_ctas = geo.n_clusters * geo.cluster
    assert geo.n_parts * n_ctas <= SMS
    seen = np.zeros(n_p, dtype=np.int64)
    chunks = np.zeros(geo.n_chunks, dtype=np.int64)
    for cta in range(n_ctas):
        for c in geo.cta_chunks(cta):
            chunks[c] += 1
            cells = geo.chunk_cells(c, n_p)
            assert 0 < len(cells) <= geo.cells <= cgn.SAMPLED_MAX_CELLS
            seen[cells.start:cells.stop] += 1
    assert (chunks == 1).all() and (seen == 1).all()
    # the workspace: a slice (row r of every tile of its part) per CTA
    assert geo.workspace_len() == geo.n_parts * n_ctas * 8 * geo.part_tiles


SHARED = 227 * 1024   # bytes of shared memory a block can have


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("n_p,k,kp", [(1536, 95, 128), (1024, 150, 256)])
def test_sampled_shared_memory_fits(n_p, k, kp, itemsize):
    """At the bench shape and at the 150-mode fine campaign's, each of
    the buffers that take turns in a CTA's shared memory fits 227 KB on
    its own: a chunk's staged rows (16 cells), the float64 partial of a
    part's tiles beside the groups' tiles, and the step's CG Gram (k x k
    in the working type, whole in one CTA)."""
    geo = cgn.sampled_geometry(n_p, k, itemsize)
    assert geo.lanes <= kp <= cgn.MAX_STEP_LANES
    assert geo.n_parts == 1 and geo.cells == 16
    staged = 6 * geo.cells * (geo.lanes + 16 // itemsize) * itemsize
    assert staged <= cgn.SAMPLED_STAGE_BYTES
    groups = geo.threads // geo.group
    partial = 64 * geo.part_tiles * (8 + (itemsize * groups
                                          if groups > 1 else 0))
    assert partial <= SHARED
    assert k * k * itemsize <= SHARED - 16 * 1024


def test_sampled_geometry_limits():
    """The cut is the shape's alone; past the kernel's 8-bit tile table
    (2032 live lanes) the geometry raises ValueError (the wrappers raise
    it before any launch); every k the wrappers took before is in range,
    in parts above 176 live lanes."""
    assert cgn.sampled_geometry(1536, 95, 4) == cgn.sampled_geometry(
        1536, 95, 4)
    a = cgn.sampled_geometry(1536, 95, 4)
    assert (a.lanes, a.n_chunks, a.n_clusters, a.n_parts) == (96, 96, 12, 1)
    assert a.cta_chunks(5) == range(5, 96, 96)
    assert cgn.sampled_geometry(1536, 175, 8).n_parts == 1
    assert cgn.sampled_geometry(1536, 176, 8).n_parts == 2
    assert cgn.sampled_geometry(1536, 255, 4).n_parts == 3
    assert cgn.sampled_geometry(1536, 2031, 8).lanes == 2032
    with pytest.raises(ValueError, match="live lanes"):
        cgn.sampled_geometry(1536, 2032, 8)
    with pytest.raises(ValueError):
        cgn.sampled_geometry(1536, 0, 4)


# ----------------------------------------------------------------------
# a plain model of the kernel's sums
# ----------------------------------------------------------------------

def sampled_model(p6p, y, cp, wgt_p, k, hdx, hdy):
    """gn_system_ref as the kernel sums it: each chunk's Gram in the
    working type, CTA t adding its chunks t, t + n_ctas, ... in order;
    the CTAs of a cluster summed in rank order in float64; each 8x8 tile
    of the live lanes' upper triangle, part by part, summed over the
    clusters in order and placed back, mirrored, into a (kp, kp) Gram in
    the working type, zeros elsewhere."""
    dtype = p6p.dtype
    _, n_p, kp = p6p.shape
    geo = cgn.sampled_geometry(n_p, k, p6p.element_size())
    n_ctas = geo.n_clusters * geo.cluster
    ctas = [torch.zeros((kp, kp), dtype=dtype) for _ in range(n_ctas)]
    for cta in range(n_ctas):
        for c in geo.cta_chunks(cta):
            cells = geo.chunk_cells(c, n_p)
            s = slice(cells.start, cells.stop)
            ctas[cta] += tgn.gn_system_ref(p6p[:, s], y, cp[s], wgt_p[s],
                                           k, hdx, hdy, tile=len(cells))
    clusters = []
    for i in range(geo.n_clusters):
        total = torch.zeros((kp, kp), dtype=F64)
        for r in range(geo.cluster):
            total = total + ctas[i * geo.cluster + r].double()
        clusters.append(total)
    nt = geo.lanes // 8
    tiles = [(a, b) for a in range(nt) for b in range(a, nt)]
    gram = torch.zeros((kp, kp), dtype=dtype)
    stacked = torch.stack(clusters)
    for part in range(geo.n_parts):
        for t in geo.part_tile_range(part):
            a, b = tiles[t]
            block = stacked[:, 8 * a:8 * a + 8, 8 * b:8 * b + 8]
            total = block[0].clone()
            for c in range(1, len(clusters)):
                total = total + block[c]
            gram[8 * a:8 * a + 8, 8 * b:8 * b + 8] = total.to(dtype)
            gram[8 * b:8 * b + 8, 8 * a:8 * a + 8] = total.T.to(dtype)
    return gram


def random_system(n_s, k, tile, dtype, seed=3):
    rng = np.random.default_rng(seed)
    p6 = rng.normal(size=(6, n_s, k)) / k ** 0.5
    wgt = 1 + rng.uniform(size=n_s)
    p6p, wgt_p = tgn.pad_factored_inputs(to_torch(p6), to_torch(wgt),
                                         tile=tile, dtype=dtype)
    y = to_torch(rng.normal(size=k)).to(dtype)
    cp = to_torch(0.1 * rng.normal(size=(p6p.shape[1], 2))).to(dtype)
    return p6p, y, cp, wgt_p


@pytest.mark.parametrize("k,dtype", [(40, F32), (40, F64), (200, F64)],
                         ids=["f32", "f64", "k200-f64"])
def test_sampled_model_matches_ref_and_pallas(k, dtype):
    """On 300 cells and 40 modes (19 chunks, the last one of 12 cells,
    over 3 clusters of 8 CTAs), and on 200 modes in float64 (two parts of
    the tiles, 38 chunks of 8 cells), the model of the kernel's sums is
    the plain version's Gram, and the JAX kernel's in float32."""
    p6p, y, cp, wgt_p = random_system(300, k, 4, dtype)
    hdx, hdy = 0.5 * DT, 0.25 * DT
    geo = cgn.sampled_geometry(300, k, p6p.element_size())
    assert (geo.n_parts, geo.n_chunks, geo.n_clusters) == (
        (1, 19, 3) if k == 40 else (2, 38, 5))
    got = sampled_model(p6p, y, cp, wgt_p, k, hdx, hdy)
    want = tgn.gn_system_ref(p6p, y, cp, wgt_p, k, hdx, hdy, tile=4)
    assert rel(got.numpy(), want.numpy()) <= (1e-12 if dtype == F64
                                              else 5e-5)
    assert bool((got[k + 1:] == 0).all()) and bool((got[:, k + 1:] == 0)
                                                   .all())
    if dtype == F32:
        jax_gext = jgn.gn_system_pallas(
            jnp.asarray(p6p.numpy()), jnp.asarray(y.numpy()),
            jnp.asarray(cp.numpy()), jnp.asarray(wgt_p.numpy()), k, hdx,
            hdy, tile=4, interpret=True)
        assert rel(got.numpy(), np.asarray(jax_gext)) <= 5e-5


# ----------------------------------------------------------------------
# one workspace a run, fresh outputs every call
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ls_method", ["normal", "fused"])
def test_pallas_hprom_one_workspace_fresh_outputs(mesh_problem, monkeypatch,
                                                  ls_method):
    """Two dynamic-loop runs back to back: every call of a run gets the
    run's one workspace, the runs get different ones, no two calls return
    the same output tensor (the loop keeps the previous call's rn for its
    stagnation rule), and both runs give JAX's Gauss-Newton counts."""
    p = mesh_problem
    steps = 12
    jp6p, jwgt, tp6p, twgt = padded_pair(p)
    y0 = np.asarray(p["y0"], np.float32)
    want = jrf.pallas_hprom(p["jg"], p["jmesh"], jp6p, jwgt,
                            jnp.asarray(y0), DT, steps, MU[0], MU[1],
                            tile=TILE, interpret=True, ls_method=ls_method)
    calls = []
    name = "gn_step" if ls_method == "fused" else "gn_system"
    real = getattr(trf, name)

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((kwargs["workspace"], out))
        return out

    monkeypatch.setattr(trf, name, recorded)
    workspaces, outputs = [], []
    for _ in range(2):
        calls.clear()
        got = trf.pallas_hprom(p["tg"], p["tmesh"], tp6p, twgt,
                               to_torch(y0), DT, steps, MU[0], MU[1],
                               tile=TILE, ls_method=ls_method)
        assert got.total_gn_its == int(want.total_gn_its)
        assert len(calls) == got.gn_evals > steps
        run = {id(ws) for ws, _ in calls}
        assert len(run) == 1 and isinstance(calls[0][0],
                                            cgn.SampledWorkspace)
        workspaces.append(calls[0][0])
        outputs += [out if isinstance(out, tuple) else (out,)
                    for _, out in calls]
    assert workspaces[0] is not workspaces[1]
    # every call's outputs in storage of their own: a reused buffer
    # would show the same storage in two calls
    storages = [{t.untyped_storage().data_ptr() for t in out}
                for out in outputs]
    assert len(set().union(*storages)) == sum(len(x) for x in storages)
