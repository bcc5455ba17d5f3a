"""The hand-written whole-trajectory kernel (B6, csrc/gn_traj.cu) against
its plain PyTorch version.

Tests marked `cuda` need an NVIDIA GPU and skip without one; on a machine
with a card run them with

    python -m pytest tests/test_torch_cuda_traj.py --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which this file does not
use). The tests without the marker run anywhere.

Tolerances, kernel against plain version on the same inputs: float64
1e-10 relative over the trajectory with equal Gauss-Newton counts (both
sum the Gram in float64, in other orders); float32 1e-4 over 50 steps
(f32 partial Grams in other orders, carried through 150 CG solves).
"""

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch import rom_factored as rf
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops import cuda_gn as cg
from finitedifference_tpu_torch.ops import gn
from finitedifference_tpu_torch.parallel.sweep import sweep_hprom
from finitedifference_tpu_torch.rom import prepare_hprom

DT = 0.05
F32, F64 = torch.float32, torch.float64
MUS = [(4.25 + 0.125 * i, 0.015 + 0.00125 * i) for i in range(9)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def rel(got, want):
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def traj_problem(k, dtype, device, n_cells=220):
    """A 24x24 grid, a random orthonormal k-mode basis, n_cells weighted
    sampled cells (2 n_s > k + 1 keeps the Gauss-Newton well posed; the
    grid and mesh of the JAX package's k = 150 test), padded blocks."""
    grid = Grid2D(nx=24, ny=24)
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.normal(size=(grid.state_dim, k)))
    weights = np.zeros(grid.n_cells)
    weights[rng.choice(grid.n_cells, size=n_cells, replace=False)] = \
        1 + rng.uniform(size=n_cells)
    basis = torch.as_tensor(q, dtype=dtype, device=device)
    mesh, sw, ba = prepare_hprom(grid, weights, basis)
    blocks = rf.precompute_factored_blocks(mesh, ba)
    p6p, wgt_p = rf.precompute_pallas_system(blocks, sw, tile=8,
                                             dtype=dtype)
    y0 = basis.T @ torch.ones(grid.state_dim, dtype=dtype, device=device)
    return grid, mesh, p6p, wgt_p, y0


def batch_inputs(grid, mesh, p6p, y0, b):
    slbc = torch.stack([rf.traj_source(grid, mesh, DT, *mu, p6p.shape[1],
                                       p6p.dtype) for mu in MUS[:b]])
    return y0.expand(b, -1).contiguous(), slbc


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9])
@pytest.mark.parametrize("dtype,k", [(F64, 95), (F32, 95), (F32, 150)],
                         ids=["f64_kp128", "f32_kp128", "f32_kp256"])
def test_traj_kernel_matches_plain(cuda, dtype, k, b):
    grid, mesh, p6p, wgt_p, y0 = traj_problem(k, dtype, cuda)
    assert p6p.shape[2] == (128 if k < 128 else 256)
    yb, slbc = batch_inputs(grid, mesh, p6p, y0, b)
    hd = (0.5 * DT / grid.dx, 0.5 * DT / grid.dy)
    steps = 50
    before = cg.TRAJ_LAUNCHES
    got = gn.trajectory_hprom(p6p, yb, slbc, wgt_p, k, *hd, steps)
    assert cg.TRAJ_LAUNCHES == before + 1
    want = gn.trajectory_hprom_ref(p6p, yb, slbc, wgt_p, k, *hd, steps)
    torch.cuda.synchronize()
    assert got.ys.shape == (b, steps, k) and got.ys.dtype == dtype
    assert bool(torch.isfinite(got.ys).all())
    assert rel(got.ys, want.ys) <= (1e-10 if dtype == F64 else 1e-4)
    if dtype == F64:
        assert torch.equal(got.its, want.its)
        assert torch.equal(got.evals, want.evals)
    assert bool((got.its > 0).all())
    assert bool((got.evals <= 3 * steps).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k,n_cells", [(F32, 95, 220), (F64, 95, 220),
                                             (F32, 150, 220), (F64, 60, 40)],
                         ids=["f32_7chunks", "f64_7chunks", "f32_kp256",
                              "f64_2chunks"])
def test_traj_kernel_is_deterministic_and_batch_free(cuda, dtype, k,
                                                     n_cells):
    """Two launches give the same bits, and so does each point alone
    against its row of the 9-point launch: the cluster's geometry and its
    reductions are fixed by the shape, never by the batch. The layouts
    leave the cluster's 8 CTAs uneven work (7 chunks of 32 cells; 2)."""
    grid, mesh, p6p, wgt_p, y0 = traj_problem(k, dtype, cuda, n_cells)
    geo = cg.traj_geometry(p6p.shape[1], k, p6p.element_size())
    assert geo.n_chunks % geo.cluster != 0
    yb, slbc = batch_inputs(grid, mesh, p6p, y0, 9)
    hd = (0.5 * DT / grid.dx, 0.5 * DT / grid.dy)
    got = gn.trajectory_hprom(p6p, yb, slbc, wgt_p, k, *hd, 20)
    again = gn.trajectory_hprom(p6p, yb, slbc, wgt_p, k, *hd, 20)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i in (0, 4, 8):
        one = gn.trajectory_hprom(p6p, yb[i:i + 1].contiguous(),
                                  slbc[i:i + 1].contiguous(), wgt_p, k, *hd,
                                  20)
        assert torch.equal(one.ys[0], got.ys[i])
        assert int(one.its[0]) == int(got.its[i])


@pytest.mark.cuda
def test_pallas_traj_hprom_on_card_matches_cpu(cuda):
    """The engine in f64 on the card (one launch) against its CPU run
    (the plain version): within 1e-10, equal counts."""
    runs = {}
    for dev in ("cpu", cuda):
        grid, mesh, p6p, wgt_p, y0 = traj_problem(95, F64, dev)
        before = cg.TRAJ_LAUNCHES
        res = rf.pallas_traj_hprom(grid, mesh, p6p, wgt_p, y0, DT, 20,
                                   *MUS[4])
        runs[str(dev)] = (res, cg.TRAJ_LAUNCHES - before)
    (cpu, cpu_l), (gpu, gpu_l) = runs["cpu"], runs["cuda"]
    assert cpu_l == 0 and gpu_l == gpu.gn_evals == 1
    assert gpu.total_gn_its == cpu.total_gn_its
    assert rel(gpu.red_coords.cpu(), cpu.red_coords) <= 1e-10


@pytest.mark.cuda
def test_pallas_traj_sweep_is_one_launch(cuda):
    """Nine μ points of sweep_hprom(engine="pallas_traj") in ONE launch,
    each equal to its own single-point run."""
    grid = Grid2D(nx=24, ny=24)
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.normal(size=(grid.state_dim, 40)))
    weights = np.zeros(grid.n_cells)
    weights[rng.choice(grid.n_cells, size=120, replace=False)] = 1.0
    basis = torch.as_tensor(q, dtype=F32, device=cuda)
    mesh, sw, ba = prepare_hprom(grid, weights, basis)
    y0 = basis.T @ torch.ones(grid.state_dim, dtype=F32, device=cuda)
    before = cg.TRAJ_LAUNCHES
    red = sweep_hprom(grid, mesh, sw, y0, ba, DT, 30, MUS,
                      engine="pallas_traj")
    assert cg.TRAJ_LAUNCHES == before + 1
    assert red.shape == (9, 40, 31)
    p6p, wgt_p = rf.precompute_pallas_system(
        rf.precompute_factored_blocks(mesh, ba), sw)
    for i in (0, 8):
        one = rf.pallas_traj_hprom(grid, mesh, p6p, wgt_p, y0, DT, 30,
                                   *MUS[i])
        assert torch.equal(red[i], one.red_coords)


@pytest.mark.cuda
def test_traj_dispatch_raises_on_what_the_kernel_does_not_take(cuda):
    """f64 at 150 modes (a 160-lane float64 Gram and partial do not fit
    a CTA's shared memory) and float16 raise, naming the limit; no
    launch."""
    before = cg.TRAJ_LAUNCHES
    grid, mesh, p6p, wgt_p, y0 = traj_problem(150, F64, cuda)
    slbc = rf.traj_source(grid, mesh, DT, *MUS[0], p6p.shape[1], F64)
    with pytest.raises(ValueError, match="128 lanes"):
        gn.trajectory_hprom(p6p, y0, slbc, wgt_p, 150, 0.1, 0.1, 2)
    h = [x.half() for x in (p6p, y0, slbc, wgt_p)]
    with pytest.raises(ValueError, match="float32 or float64"):
        gn.trajectory_hprom(h[0], h[1], h[2], h[3], 150, 0.1, 0.1, 2)
    assert cg.TRAJ_LAUNCHES == before


# ----------------------------------------------------------------------
# anywhere
# ----------------------------------------------------------------------

def test_cpu_tensors_raise_in_the_traj_wrapper():
    """The wrapper takes CUDA tensors only, never falls back, counts no
    launch; the dispatcher runs the plain version on CPU tensors."""
    grid, mesh, p6p, wgt_p, y0 = traj_problem(12, F64, "cpu", n_cells=40)
    slbc = rf.traj_source(grid, mesh, DT, *MUS[0], p6p.shape[1], F64)
    hd = (0.5 * DT / grid.dx, 0.5 * DT / grid.dy)
    before = cg.TRAJ_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        cg.gn_traj_cuda(p6p, y0, slbc, wgt_p, 12, *hd, 2)
    got = gn.trajectory_hprom(p6p, y0, slbc, wgt_p, 12, *hd, 3)
    want = gn.trajectory_hprom_ref(p6p, y0, slbc, wgt_p, 12, *hd, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cg.TRAJ_LAUNCHES == before
