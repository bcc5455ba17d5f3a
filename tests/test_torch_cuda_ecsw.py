"""The device-resident ECSW recipe and the runners on the card against
the same calls on the CPU.

Tests marked `cuda` need an NVIDIA GPU and skip without one; on a machine
with a card run them with

    python -m pytest tests/test_torch_cuda_ecsw.py --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which this file does not
use).

Tolerances, card against CPU on the same float64 inputs: the training
matrix 1e-12 relative; FISTA 1e-10; the device NNLS recipes the same
support and weights 1e-8 (relative); a runner's error against the FOM
1e-6 percentage points.
"""

import os

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch import ecsw
from finitedifference_tpu_torch.fom import inviscid_burgers_implicit2d
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.pod import pod

DT = 0.05
MU_TRAIN = (4.25, 0.0225)
F64 = torch.float64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def problem():
    """A 16^2 grid, 8 modes, the 3-step-offset pairs of a 40-step training
    trajectory (on the CPU, float64) and the CPU training matrix."""
    grid = Grid2D(nx=16, ny=16)
    w0 = torch.ones(grid.state_dim, dtype=F64)
    snaps = inviscid_burgers_implicit2d(grid, w0, DT, 40, *MU_TRAIN).snaps
    basis, _ = pod(snaps, num_modes=8)
    pairs = (snaps[:, 3::4], snaps[:, 0:-3:4])
    c = ecsw.ecsw_training_matrix(grid, *pairs, basis, *MU_TRAIN, DT)
    return grid, basis, pairs, c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_training_matrix_device_card_vs_cpu(cuda, problem, dtype):
    grid, basis, pairs, _ = problem
    want = ecsw.ecsw_training_matrix_device(grid, *pairs, basis, *MU_TRAIN,
                                            DT, chunk=2, dtype=dtype)
    got = ecsw.ecsw_training_matrix_device(
        grid, *(p.to(cuda) for p in pairs), basis.to(cuda), *MU_TRAIN, DT,
        chunk=2, dtype=dtype)
    assert got.device.type == "cuda" and got.dtype == dtype
    assert rel(got.cpu(), want) <= (1e-12 if dtype == F64 else 1e-6)


@pytest.mark.cuda
def test_nnls_fista_card_vs_cpu(cuda):
    rng = np.random.default_rng(4)
    cs = torch.as_tensor(rng.normal(size=(5, 60, 12)) + 1.0)
    ds = torch.einsum("bij,bj->bi", cs,
                      torch.as_tensor(np.abs(rng.normal(size=(5, 12)))))
    want_x, want_r = ecsw.nnls_fista(cs, ds, num_iters=400)
    got_x, got_r = ecsw.nnls_fista(cs.to(cuda), ds.to(cuda), num_iters=400)
    assert rel(got_x.cpu(), want_x) <= 1e-10
    assert rel(got_r.cpu(), want_r) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["lawson_hanson", "multilevel_global",
                                    "multilevel_block"])
def test_device_nnls_card_vs_cpu(cuda, problem, recipe):
    grid, _, _, c = problem
    if recipe == "lawson_hanson":
        def run(cd):
            return ecsw.lawson_hanson_weights_device(
                cd, grid, bc_w=5.0, ring="full", rel_err_thresh=1e-4)
    else:
        level1 = recipe.split("_")[1]

        def run(cd):
            return ecsw.multilevel_nnls_weights_device(
                cd, grid, num_subdomains=4, bc_w=5.0, ring="full",
                fista_iters=1000, level1=level1)
    want, got = run(c), run(c.to(cuda))
    np.testing.assert_array_equal(got > 0, want > 0)
    assert rel(got, want) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ecm", "multilevel", "sequential"])
def test_weight_methods_on_the_card(cuda, problem, method):
    """compute_ecsw_weights("ecm") sketches where C lies and
    multilevel_nnls_weights screens there: from the card's C each meets
    its stopping target, the 1e-4 training residual. The sequential
    recipe (host NNLS over 50-column batches, then a cleanup solve on
    their support) equals its CPU run, and its cleanup is held to 1e-3:
    a support assembled batch by batch need not reach the global 1e-4."""
    grid, _, _, c = problem
    cd = c.to(cuda)
    if method == "ecm":
        w = ecsw.compute_ecsw_weights(cd, grid, bc_w=5.0, method="ecm",
                                      ecm_tolerance=1e-4, ecm_rank=60)
    elif method == "multilevel":
        w = ecsw.multilevel_nnls_weights(cd, grid, num_subdomains=4,
                                         bc_w=5.0, rel_err_thresh=1e-4,
                                         fista_iters=1000)
    else:
        w = ecsw.sequential_nnls_weights(cd, grid, batch_size=50, bc_w=5.0,
                                         rel_err_thresh=1e-4)
    flat = ecsw.interior_mask(grid).ravel()
    ci = c.numpy()[:, flat]
    d = ci.sum(axis=1)
    assert np.all(w >= 0) and 0 < int((w[flat] > 0).sum()) < flat.sum()
    target = 1e-4
    if method == "sequential":
        np.testing.assert_array_equal(w, ecsw.sequential_nnls_weights(
            c, grid, batch_size=50, bc_w=5.0, rel_err_thresh=1e-4))
        target = 1e-3
    assert np.linalg.norm(ci @ w[flat] - d) / np.linalg.norm(d) < target


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["generic", "pallas"])
def test_hprom_runner_card_vs_cpu(cuda, tmp_path, monkeypatch, engine):
    """run_hprom --compute-ecsw at 12^2 on the card and on the CPU, in
    one directory (the card run builds the basis and the FOMs the CPU
    run then reads): equal N_e, weights to 1e-8, errors to 1e-6
    percentage points for the generic engine (normal equations on the
    card, QR on the CPU), 1e-3 for the f32 kernel engine."""
    from finitedifference_tpu_torch.runners import run_hprom

    monkeypatch.chdir(tmp_path)
    kw = dict(num_modes=6, bc_w=5.0, num_cells=12, num_steps=8,
              compute_ecsw=True, engine=engine)
    _, err_card = run_hprom.main(**kw, device="cuda")
    w_card = np.load("ecsw_weights_lspg_12x12.npy")
    _, err_cpu = run_hprom.main(**kw, device="cpu")
    w_cpu = np.load("ecsw_weights_lspg_12x12.npy")
    assert os.path.exists("basis_12x12.npy")
    np.testing.assert_array_equal(w_card > 0, w_cpu > 0)
    assert rel(w_card, w_cpu) <= 1e-8
    assert abs(err_card - err_cpu) <= (1e-6 if engine == "generic"
                                       else 1e-3)
