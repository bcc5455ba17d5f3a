"""The hand-written wavefront kernels, the exact solve (B1) and the
overlapping-segment solve (B7), against their plain PyTorch versions.

Tests marked `cuda` need an NVIDIA GPU and skip without one; on a machine
with a card run them with

    python -m pytest tests/test_torch_cuda_wavefront.py --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which this file does not
use). The tests without the marker run anywhere.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch.fom import inviscid_burgers_implicit2d_skewed
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops import cuda_wavefront as cw
from finitedifference_tpu_torch.ops import skewed as sk
from finitedifference_tpu_torch.ops.wavefront import solve_jacobian_wavefront

DT = 0.05
PKG = pathlib.Path(__file__).resolve().parent.parent \
    / "finitedifference_tpu_torch"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def skewed_inputs(lay, dtype, device, seed=0):
    """u, v in [1, 2] and a normal right-hand side, zero off the band."""
    rng = np.random.default_rng(seed)
    band = sk.valid_mask(lay, torch.float64).numpy()
    shape = (lay.nd_pad, lay.ny_pad)
    arrs = (1 + rng.uniform(size=shape), 1 + rng.uniform(size=shape),
            rng.normal(size=shape), rng.normal(size=shape))
    return [torch.as_tensor(a * band, dtype=dtype, device=device)
            for a in arrs]


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(8, 6), (13, 5), (750, 750),
                                   (40, 1100), (20, 2100), (1000, 40),
                                   (30, 900), (5, 300), (300, 4000)])
def test_kernel_matches_plain(cuda, shape, dtype, tol):
    """f32 within 1e-5 and f64 within 1e-12 of the plain loop (the two
    differ only in rounding), with exact zeros off the band, and two runs
    bit-equal. The kernel is a chain of warps of 32 rows over a cluster of
    8 CTAs: (40, 1100) has 36 warps, which do not fill the CTAs evenly;
    (20, 2100) 9 warps a CTA, more than its schedulers; (1000, 40) two
    warps and ny far below nx; (30, 900) and (5, 300) ny far above nx, a
    band that crosses a warp in a few diagonals; (300, 4000) the widest
    layout, 16 warps a CTA."""
    nx, ny = shape
    grid = Grid2D(nx=nx, ny=ny)
    lay = sk.make_layout(grid)
    args = skewed_inputs(lay, dtype, cuda)
    got = cw.solve_skewed_cuda(*args, DT, grid, lay)
    again = cw.solve_skewed_cuda(*args, DT, grid, lay)
    want = sk.solve_skewed_ref(*args, DT, grid, lay)
    torch.cuda.synchronize()
    off_band = ~sk.valid_mask(lay, torch.bool, cuda)
    for g, a, w in zip(got, again, want):
        assert torch.isfinite(g).all()
        rel = float(torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w))
        assert rel <= tol
        assert bool((g[off_band] == 0).all())
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_is_deterministic_under_load(cuda, dtype):
    """Ten solves in a row on the same inputs, other work on the card in
    between, give the same bits: no cell's arithmetic depends on how the
    warps happen to be staggered."""
    grid = Grid2D(nx=250, ny=250)
    lay = sk.make_layout(grid)
    args = skewed_inputs(lay, dtype, cuda, seed=3)
    first = cw.solve_skewed_cuda(*args, DT, grid, lay)
    busy = torch.randn((2048, 2048), device=cuda)
    for _ in range(10):
        busy = busy @ busy.T / 2048
        again = cw.solve_skewed_cuda(*args, DT, grid, lay)
        assert all(torch.equal(f, a) for f, a in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 6), (13, 5)])
def test_unskewed_wrapper_matches_cpu(cuda, shape):
    """solve_jacobian_wavefront on the card (skew, kernel, unskew) equals
    its CPU run (the plain loop) in f64."""
    nx, ny = shape
    grid = Grid2D(nx=nx, ny=ny)
    rng = np.random.default_rng(1)
    u, v = (torch.as_tensor(1 + rng.uniform(size=(ny, nx)))
            for _ in range(2))
    fu, fv = (torch.as_tensor(rng.normal(size=(ny, nx))) for _ in range(2))
    before = cw.LAUNCHES
    got = solve_jacobian_wavefront(*(x.to(cuda) for x in (u, v, fu, fv)),
                                   DT, grid)
    assert cw.LAUNCHES == before + 1
    want = solve_jacobian_wavefront(u, v, fu, fv, DT, grid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-13)


@pytest.mark.cuda
def test_skewed_trajectory_matches_cpu(cuda):
    """48^2 f64 trajectory on the card (kernel in every Newton
    iteration) against the CPU run: rel < 1e-12, equal iteration
    counts, one launch per iteration."""
    grid = Grid2D(nx=48, ny=48)
    w0 = torch.ones(grid.state_dim, dtype=torch.float64)
    before = cw.LAUNCHES
    gpu = inviscid_burgers_implicit2d_skewed(grid, w0.to(cuda), DT, 20,
                                             4.75, 0.02)
    launches = cw.LAUNCHES - before
    cpu = inviscid_burgers_implicit2d_skewed(grid, w0, DT, 20, 4.75, 0.02)
    got = gpu.snaps.cpu().numpy()
    want = cpu.snaps.numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12
    assert gpu.total_newton_its == cpu.total_newton_its
    assert launches == gpu.total_newton_its
    assert float(gpu.max_final_relnorm) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape,n_seg,overlap", [
    ((13, 5), 4, 16), ((750, 750), 8, 64), ((750, 750), 16, 64),
    ((40, 1100), 4, 32), ((20, 2100), 16, 8), ((64, 64), 1, 0),
    ((13, 5), 14, 0), ((40, 1000), 4, 32), ((1000, 40), 8, 64),
    ((30, 900), 8, 64), ((750, 750), 7, 64), ((750, 750), 8, 0),
    ((200, 200), 8, 100), ((40, 1100), 1, 0), ((20, 2000), 1, 0),
    ((20, 2100), 1, 0)])
def test_seg_kernel_matches_plain(cuda, shape, n_seg, overlap, dtype, tol):
    """B7 against solve_skewed_seg_ref: f32 within 1e-5, f64 within 1e-12
    (rounding only), exact zeros off the band, two runs bit-equal, one
    launch; ny_pad > 1024 in the 1100 and 2100 rows; ny_pad 2176 no
    multiple of the 256 rows a warp holds at 8 rows a lane; ny far below
    (1000, 40) and far above (30, 900) nx; 7 segments do not divide nd_pad
    1536; overlap 0, and overlap 100 >= seg_len 64 at 200^2; n_seg = 1,
    overlap = 0 is B1's solve, bit for bit, in each band of rows a lane
    (ny_pad 128, 1152, 2048, 2176); at (13, 5) the last of 14 segments of
    10 diagonals owns none of the 128."""
    nx, ny = shape
    grid = Grid2D(nx=nx, ny=ny)
    lay = sk.make_layout(grid)
    args = skewed_inputs(lay, dtype, cuda, seed=nx)
    before = (cw.LAUNCHES, cw.SEG_LAUNCHES)
    got = sk.solve_skewed_seg(*args, DT, grid, lay, n_seg=n_seg,
                              overlap=overlap)
    assert (cw.LAUNCHES, cw.SEG_LAUNCHES) == (before[0], before[1] + 1)
    want = sk.solve_skewed_seg_ref(*args, DT, grid, lay, n_seg=n_seg,
                                   overlap=overlap)
    again = cw.solve_skewed_seg_cuda(*args, DT, grid, lay, n_seg=n_seg,
                                     overlap=overlap)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    off_band = ~sk.valid_mask(lay, torch.bool, cuda)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        rel = float(torch.linalg.vector_norm(g - w)
                    / torch.linalg.vector_norm(w))
        assert rel <= tol
        assert bool((g[off_band] == 0).all())
    if n_seg == 1:
        exact = cw.solve_skewed_cuda(*args, DT, grid, lay)
        assert all(torch.equal(g, e) for g, e in zip(got, exact))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seg_kernel_is_deterministic_under_load(cuda, dtype):
    """Ten segment solves in a row, other work on the card in between,
    give the same bits: the hand-off between a segment's warps is fixed
    by the shape, not by how the warps happen to be staggered."""
    grid = Grid2D(nx=750, ny=750)
    lay = sk.make_layout(grid)
    args = skewed_inputs(lay, dtype, cuda, seed=4)
    kw = dict(n_seg=8, overlap=64)
    first = cw.solve_skewed_seg_cuda(*args, DT, grid, lay, **kw)
    busy = torch.randn((2048, 2048), device=cuda)
    for _ in range(10):
        busy = busy @ busy.T / 2048
        again = cw.solve_skewed_seg_cuda(*args, DT, grid, lay, **kw)
        assert all(torch.equal(f, a) for f, a in zip(first, again))


@pytest.mark.cuda
def test_seg_trajectory_matches_cpu(cuda):
    """48^2 f64 seg trajectory on the card (B7 in every Newton iteration)
    against the CPU run: rel < 1e-12, equal counts, one launch an
    iteration."""
    grid = Grid2D(nx=48, ny=48)
    w0 = torch.ones(grid.state_dim, dtype=torch.float64)
    kw = dict(seg=4, seg_overlap=16)
    before = cw.SEG_LAUNCHES
    gpu = inviscid_burgers_implicit2d_skewed(grid, w0.to(cuda), DT, 20,
                                             4.75, 0.02, **kw)
    launches = cw.SEG_LAUNCHES - before
    cpu = inviscid_burgers_implicit2d_skewed(grid, w0, DT, 20, 4.75, 0.02,
                                             **kw)
    got = gpu.snaps.cpu().numpy()
    want = cpu.snaps.numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12
    assert gpu.total_newton_its == cpu.total_newton_its == launches


@pytest.mark.cuda
def test_seg_dispatch_raises_on_what_the_kernel_does_not_take(cuda):
    """A CUDA tensor the kernel cannot run raises; nothing falls back."""
    grid = Grid2D(nx=8, ny=6)
    lay = sk.make_layout(grid, block=8)
    before = cw.SEG_LAUNCHES
    half = skewed_inputs(lay, torch.float16, cuda)
    with pytest.raises(ValueError, match="float32 or float64"):
        sk.solve_skewed_seg(*half, DT, grid, lay, n_seg=2, overlap=4)
    args = skewed_inputs(lay, torch.float32, cuda)
    with pytest.raises(ValueError, match="n_seg"):
        sk.solve_skewed_seg(*args, DT, grid, lay, n_seg=lay.nd_pad + 1,
                            overlap=4)
    assert cw.SEG_LAUNCHES == before


# ----------------------------------------------------------------------
# anywhere
# ----------------------------------------------------------------------

def test_cpu_tensor_raises():
    """The kernel's wrapper takes CUDA tensors only; it never falls back
    to the plain version, and counts no launch."""
    grid = Grid2D(nx=8, ny=6)
    lay = sk.make_layout(grid, block=8)
    args = skewed_inputs(lay, torch.float64, "cpu")
    before = (cw.LAUNCHES, cw.SEG_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cw.solve_skewed_cuda(*args, DT, grid, lay)
    with pytest.raises(ValueError, match="CUDA"):
        cw.solve_skewed_seg_cuda(*args, DT, grid, lay, n_seg=2, overlap=4)
    assert (cw.LAUNCHES, cw.SEG_LAUNCHES) == before


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "finitedifference_tpu"), f"{path}: {mod}"
