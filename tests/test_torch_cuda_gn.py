"""The hand-written Gauss-Newton system kernels against their plain
PyTorch versions: B3 (csrc/gn_full.cu) and B4/B5 (csrc/gn_sampled.cu).

Tests marked `cuda` need an NVIDIA GPU and skip without one; on a machine
with a card run them with

    python -m pytest tests/test_torch_cuda_gn.py --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which this file does not
use). The tests without the marker run anywhere.

Tolerances, kernel against plain version on the same inputs: float64
1e-12 relative (Frobenius); float32 5e-5 relative, because both sum
float32 partial Grams over thousands of rows, in different orders and
over different sets of rows, before the float64 reduction. Gauss-Newton counts are equal.
"""

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch import rom_factored as rf
from finitedifference_tpu_torch.fom import inviscid_burgers_implicit2d
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops import cuda_gn as cg
from finitedifference_tpu_torch.ops import cuda_gn_full as cgf
from finitedifference_tpu_torch.ops import gn
from finitedifference_tpu_torch.ops import gn_full as gf
from finitedifference_tpu_torch.pod import pod
from finitedifference_tpu_torch.rom import prepare_hprom

DT = 0.05
MU = (4.75, 0.02)
F32, F64 = torch.float32, torch.float64
TOL = {F32: 5e-5, F64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def rel(got, want):
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def full_inputs(nx, ny, k, dtype, device, seed=0):
    """Padded basis halves with unit-scale columns, the mask, a y whose
    scalars are O(1), an O(1) step constant and a source term."""
    grid = Grid2D(nx=nx, ny=ny)
    gen = torch.Generator(device=device).manual_seed(seed)
    n = grid.n_cells
    basis = torch.randn((2 * n, k), generator=gen, dtype=dtype,
                        device=device) / n ** 0.5
    vu, vv, tr = gf.pad_basis_full(basis, grid, 4, dtype=dtype)
    dmask = gf.row_mask(grid, tr, dtype, device)
    nxp, _, tile = gf.full_layout(grid, tr)
    y = 1 + 0.1 * torch.randn(k, generator=gen, dtype=dtype, device=device)
    y = y * n ** 0.5 / k ** 0.5
    n_pad = vu.shape[0]
    cp = 0.1 * torch.randn((n_pad, 2), generator=gen, dtype=dtype,
                           device=device) * dmask
    slbc = 0.01 * torch.rand((n_pad, 1), generator=gen, dtype=dtype,
                             device=device) * dmask
    hd = (0.5 * DT / grid.dx, 0.5 * DT / grid.dy)
    return vu, vv, y, cp, slbc, dmask, k, nxp, tile, hd


def sampled_inputs(n_s, k, dtype, device, tile=256, seed=0):
    """Padded (6, n_p, kp) blocks with zero lanes above k, weights > 0 on
    the n_s real cells and 0 on the padding, y, cp."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p6 = torch.randn((6, n_s, k), generator=gen, dtype=dtype,
                     device=device) / k ** 0.5
    wgt = 1 + torch.rand(n_s, generator=gen, dtype=dtype, device=device)
    p6p, wgt_p = gn.pad_factored_inputs(p6, wgt, tile=tile, dtype=dtype)
    y = torch.randn(k, generator=gen, dtype=dtype, device=device)
    cp = 0.1 * torch.randn((p6p.shape[1], 2), generator=gen, dtype=dtype,
                           device=device)
    return p6p, y, cp, wgt_p, k


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("shape", [(12, 10, 6), (40, 33, 30),
                                   (250, 250, 95), (64, 64, 150),
                                   (150, 149, 40)])
def test_gn_full_kernel_matches_plain(cuda, shape, dtype):
    """B3, first=True and first=False, over many chunks: the Gram
    extension, the step constant, zeros above lane k, two runs bit-equal.
    (64, 64, 150) has 160 live lanes, more tiles than one group of
    threads holds; at (150, 149, 40) the chunks do not divide among the
    CTAs and k + 1 = 41 is no multiple of the 16-lane granularity."""
    vu, vv, y, cp, slbc, dmask, k, nxp, tile, hd = full_inputs(
        *shape, dtype, cuda)
    before = cgf.LAUNCHES
    g0, cp0 = gf.gn_full_first(vu, vv, y, slbc, dmask, k, nxp, tile, *hd)
    g1 = gf.gn_full_system(vu, vv, y, cp, dmask, k, nxp, tile, *hd)
    assert cgf.LAUNCHES == before + 2
    again = gf.gn_full_system(vu, vv, y, cp, dmask, k, nxp, tile, *hd)
    w0, wcp = gf.gn_full_ref(vu, vv, y, slbc, dmask, k, nxp, tile, *hd,
                             True)
    w1, _ = gf.gn_full_ref(vu, vv, y, cp, dmask, k, nxp, tile, *hd, False)
    torch.cuda.synchronize()
    assert g0.dtype == F64 and g0.shape == w0.shape
    assert rel(g0, w0) <= TOL[dtype]
    assert rel(g1, w1) <= TOL[dtype]
    assert rel(cp0, wcp) <= TOL[dtype]
    assert bool((g1[k + 1:] == 0).all()) and bool((g1[:, k + 1:] == 0).all())
    assert torch.equal(g1, again)
    if shape == (150, 149, 40):
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        geo = cgf.full_geometry(vu.shape[0], k, vu.element_size(), sms)
        assert geo.n_chunks % geo.n_ctas and geo.lanes != k + 1


SAMPLED_CASES = [(40, 6, 8), (1508, 95, 256), (700, 150, 256),
                 (1000, 150, 8), (2600, 40, 8), (600, 200, 8),
                 (400, 255, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("n_s,k,tile", SAMPLED_CASES)
def test_gn_sampled_kernels_match_plain(cuda, n_s, k, tile, dtype):
    """B4 (the system) and B5 (system + masked CG), one launch each, over
    many clusters: k = 150 included (kp = 256); at (1000, 150, 8) the last
    chunk is short and the 63 chunks do not divide among the clusters'
    CTAs; at (2600, 40, 8) the CTAs take more than one chunk; at 200
    and 255 modes (kp = 256) the tiles go in two and three parts, and
    the step's CG Gram spreads over the last cluster (both types at 255,
    float64 at 200). Two runs are bit-equal, with and without a
    workspace, and the kernel's own geometry is sampled_geometry's."""
    p6p, y, cp, wgt_p, k = sampled_inputs(n_s, k, dtype, cuda, tile)
    hd = (0.5 * DT, 0.25 * DT)
    ws = gn.sampled_workspace(p6p, k)
    s0, t0 = cg.SYSTEM_LAUNCHES, cg.STEP_LAUNCHES
    got = gn.gn_system(p6p, y, cp, wgt_p, k, *hd, tile=tile, workspace=ws)
    dy, rn = gn.gn_step(p6p, y, cp, wgt_p, k, *hd, tile=tile, workspace=ws)
    assert (cg.SYSTEM_LAUNCHES, cg.STEP_LAUNCHES) == (s0 + 1, t0 + 1)
    again = gn.gn_system(p6p, y, cp, wgt_p, k, *hd, tile=tile)
    dy2, rn2 = gn.gn_step(p6p, y, cp, wgt_p, k, *hd, tile=tile,
                          workspace=ws)
    want = gn.gn_system_ref(p6p, y, cp, wgt_p, k, *hd, tile)
    wdy, wrn = gn.gn_step_ref(p6p, y, cp, wgt_p, k, *hd, tile)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert rel(got, want) <= TOL[dtype]
    assert bool((got[k + 1:] == 0).all()) and bool((got[:, k + 1:] == 0)
                                                   .all())
    assert dy.shape == (k,) and rn.dim() == 0
    # the CG amplifies the Gram's rounding by its condition number
    assert rel(dy, wdy) <= 100 * TOL[dtype]
    assert rel(rn, wrn) <= TOL[dtype]
    assert torch.equal(got, again)
    assert torch.equal(dy, dy2) and torch.equal(rn, rn2)
    assert int(ws.counter.item()) == 0
    n_p, e = p6p.shape[1], p6p.element_size()
    geo = cg.sampled_geometry(n_p, k, e)
    for step in (False, True):
        kgeo = cg.kernel_geometry(n_p, k, e, step)
        assert kgeo.fits and kgeo.smem <= 232448
        assert kgeo[1:10] == (geo.lanes, geo.n_tiles, geo.n_parts,
                              geo.part_tiles, geo.group, geo.threads,
                              geo.cells, geo.n_chunks, geo.n_clusters)
        assert kgeo.ws_len == geo.workspace_len()
    if (n_s, tile) == (1000, 8):
        assert n_p % geo.cells and \
            geo.n_chunks % (geo.n_clusters * geo.cluster)
    if k >= 200:
        assert geo.n_parts == (2 if k == 200 else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("kind", ["system", "step"])
def test_gn_sampled_graph_replays_equal_eager(cuda, kind, dtype):
    """One gn_system or gn_step call with a workspace, captured in a CUDA
    graph and replayed three times, gives the eager call's bits: the
    kernel leaves its ticket counter at 0, syncs nothing and allocates
    nothing outside the graph's pool."""
    p6p, y, cp, wgt_p, k = sampled_inputs(1508, 95, dtype, cuda, 256)
    hd = (0.5 * DT, 0.25 * DT)
    ws = gn.sampled_workspace(p6p, k)

    def call():
        if kind == "system":
            return (gn.gn_system(p6p, y, cp, wgt_p, k, *hd, workspace=ws),)
        return gn.gn_step(p6p, y, cp, wgt_p, k, *hd, workspace=ws)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [x.clone() for x in call()]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(3):
        for x in captured:
            x.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))
    assert int(ws.counter.item()) == 0


@pytest.mark.cuda
def test_float32_matmuls_are_not_tf32(cuda):
    """The package pins full-f32 matmuls. A 1024^2 f32 product agrees
    with its f64 value to 1e-5 relative: TF32 (10-bit mantissa) misses
    that by two orders, as the same product with TF32 allowed shows."""
    import finitedifference_tpu_torch  # noqa: F401 (pins the flags)

    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((1024, 1024), generator=gen, device=cuda)
    b = torch.randn((1024, 1024), generator=gen, device=cuda)
    exact = a.double() @ b.double()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert rel(a @ b, exact) < 1e-5
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        assert rel(a @ b, exact) > 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def small_rom(device, dtype):
    """12x10 POD basis from a CPU FOM, and an ECSW-like mesh of 40
    random weighted cells."""
    grid = Grid2D(nx=12, ny=10)
    w0 = torch.ones(grid.state_dim, dtype=F64)
    s1 = inviscid_burgers_implicit2d(grid, w0, DT, 20, 4.25, 0.0225).snaps
    s2 = inviscid_burgers_implicit2d(grid, w0, DT, 20, 5.5, 0.015).snaps
    basis, _ = pod(torch.cat((s1, s2), dim=1), num_modes=8)
    rng = np.random.default_rng(7)
    weights = np.zeros(grid.n_cells)
    weights[rng.choice(grid.n_cells, size=40, replace=False)] = \
        1 + rng.uniform(size=40)
    basis = basis.to(device=device, dtype=dtype)
    mesh, sw, ba = prepare_hprom(grid, weights, basis)
    return grid, basis, (basis.T @ w0.to(device, dtype)), mesh, sw, ba


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
def test_pallas_prom_on_card_matches_cpu(cuda, dtype):
    """The streaming PROM on the card (B3 in every Gauss-Newton call)
    against its CPU run: equal counts, one launch per call."""
    runs = {}
    for dev in ("cpu", cuda):
        grid, basis, y0, *_ = small_rom(dev, dtype)
        vu, vv, dm, tr = rf.precompute_prom_pallas(grid, basis, 4, dtype)
        before = cgf.LAUNCHES
        res = rf.pallas_prom(grid, vu, vv, dm, y0, DT, 14, *MU,
                             tile_rows=tr)
        runs[str(dev)] = (res, cgf.LAUNCHES - before)
    (cpu, cpu_l), (gpu, gpu_l) = runs["cpu"], runs["cuda"]
    assert cpu_l == 0 and gpu_l == gpu.gn_evals > 0
    assert gpu.total_gn_its == cpu.total_gn_its
    assert rel(gpu.red_coords.cpu(), cpu.red_coords) <= \
        (1e-12 if dtype == F64 else 5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(ls_method="normal"),
                                dict(ls_method="cg", unroll_its=3),
                                dict(ls_method="fused", unroll_its=3),
                                dict(ls_method="fused")],
                         ids=["normal", "unroll3_cg", "unroll3_fused",
                              "fused"])
def test_pallas_hprom_on_card_matches_cpu(cuda, kw):
    """The sampled engine on the card (B4, or B5 when fused, one shared
    workspace a run) against its CPU run in f64: within 1e-12, equal
    counts, one launch per call."""
    runs = {}
    for dev in ("cpu", cuda):
        grid, basis, y0, mesh, sw, ba = small_rom(dev, F64)
        blocks = rf.precompute_factored_blocks(mesh, ba)
        p6p, wgt_p = rf.precompute_pallas_system(blocks, sw, tile=8,
                                                 dtype=F64)
        before = cg.SYSTEM_LAUNCHES + cg.STEP_LAUNCHES
        res = rf.pallas_hprom(grid, mesh, p6p, wgt_p, y0, DT, 12, *MU,
                              tile=8, **kw)
        runs[str(dev)] = (res, cg.SYSTEM_LAUNCHES + cg.STEP_LAUNCHES
                          - before)
    (cpu, cpu_l), (gpu, gpu_l) = runs["cpu"], runs["cuda"]
    assert cpu_l == 0 and gpu_l == gpu.gn_evals > 0
    assert gpu.total_gn_its == cpu.total_gn_its
    assert rel(gpu.red_coords.cpu(), cpu.red_coords) <= 1e-12


# ----------------------------------------------------------------------
# anywhere
# ----------------------------------------------------------------------

def test_cpu_tensors_raise_in_the_kernel_wrappers():
    """The wrappers take CUDA tensors only; they never fall back to the
    plain versions, and count no launch."""
    vu, vv, y, cp, slbc, dmask, k, nxp, _, hd = full_inputs(12, 10, 6, F32,
                                                            "cpu")
    p6p, y6, cp6, wgt_p, k6 = sampled_inputs(40, 6, F32, "cpu", tile=8)
    before = (cgf.LAUNCHES, cg.SYSTEM_LAUNCHES, cg.STEP_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cgf.gn_full_cuda(vu, vv, y, slbc, dmask, k, nxp, *hd, first=True)
    with pytest.raises(ValueError, match="CUDA"):
        cg.gn_system_cuda(p6p, y6, cp6, wgt_p, k6, *hd)
    with pytest.raises(ValueError, match="CUDA"):
        cg.gn_step_cuda(p6p, y6, cp6, wgt_p, k6, *hd)
    assert (cgf.LAUNCHES, cg.SYSTEM_LAUNCHES, cg.STEP_LAUNCHES) == before


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the dispatchers run the plain versions: the same
    numbers as calling them directly, and no launch counted."""
    vu, vv, y, cp, slbc, dmask, k, nxp, tile, hd = full_inputs(12, 10, 6,
                                                               F64, "cpu")
    p6p, y6, cp6, wgt_p, k6 = sampled_inputs(40, 6, F64, "cpu", tile=8)
    before = (cgf.LAUNCHES, cg.SYSTEM_LAUNCHES, cg.STEP_LAUNCHES)
    g, c = gf.gn_full_first(vu, vv, y, slbc, dmask, k, nxp, tile, *hd)
    wg, wc = gf.gn_full_ref(vu, vv, y, slbc, dmask, k, nxp, tile, *hd, True)
    assert torch.equal(g, wg) and torch.equal(c, wc)
    s = gn.gn_system(p6p, y6, cp6, wgt_p, k6, *hd, tile=8)
    assert torch.equal(s, gn.gn_system_ref(p6p, y6, cp6, wgt_p, k6, *hd, 8))
    assert (cgf.LAUNCHES, cg.SYSTEM_LAUNCHES, cg.STEP_LAUNCHES) == before
