"""The RBF closures, their fits, the manifold ROM and a POD-RBF runner on the
card against the same calls on the CPU.

Tests marked `cuda` need an NVIDIA GPU and skip without one; on a machine
with a card run them with

    python -m pytest tests/test_torch_cuda_closures.py --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which this file does not
use).

Tolerances, card against CPU on the same float64 inputs: closure values,
Jacobians, fits and reduced coordinates 1e-10 relative (at shape
parameters whose kernel matrices are well conditioned: at a condition
number near 1e10 two LAPACK builds differ by ~1e-7); Gauss-Newton counts
equal; a runner's error against the FOM 1e-6 percentage points.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch.closures import common as cc
from finitedifference_tpu_torch.closures import rbf
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.sampled import (
    augmented_state_indices,
    build_sampled_mesh,
)
from finitedifference_tpu_torch.rom import manifold_rom
from finitedifference_tpu_torch.fom import inviscid_burgers_implicit2d
from finitedifference_tpu_torch.training import rbf_train

F64 = torch.float64
DT = 0.05
KNN_BRANCHES = [("gaussian", 1e-8), ("gaussian", 1e-5),
                ("multiquadric", 1e-8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def rel(a, b):
    a = a.detach().cpu().double().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    b = b.detach().cpu().double().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def smooth_pairs(n, n_p, n_s, seed):
    """n pairs of a smooth map R^n_p -> R^n_s and 5 queries."""
    rng = np.random.default_rng(seed)
    q_p = rng.uniform(-1, 1, size=(n, n_p))
    mix = rng.normal(size=(n_p, n_s))
    q_s = np.sin(q_p @ mix) + 0.1 * (q_p ** 2) @ np.abs(mix)
    return q_p, q_s, rng.uniform(-0.9, 0.9, size=(5, n_p))


def to(model, device):
    """A closure model's tensors moved to `device`."""
    def mv(x):
        return x.to(device) if isinstance(x, torch.Tensor) else x
    scaler = cc.MinMaxScaler(*map(mv, model.scaler))
    return type(model)(*(scaler if f is model.scaler else mv(f)
                         for f in model))


def outputs(closure, queries, device):
    out = []
    for y in queries:
        y = torch.as_tensor(y, device=device)
        p, j = closure.predict_and_jacobian(y)
        out.append((closure.predict(y), closure.jacobian(y), p, j))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gaussian", "imq", "multiquadric",
                                    "linear", "matern"])
def test_global_rbf_on_card_matches_cpu(cuda, kernel):
    q_p, q_s, queries = smooth_pairs(200, 10, 40, seed=1)
    cpu_model = rbf.fit_global_rbf(q_p, q_s, 2.0, kernel=kernel,
                                   device="cpu")
    card_fit = rbf.fit_global_rbf(q_p, q_s, 2.0, kernel=kernel,
                                  device=cuda)
    assert card_fit.w_global.device.type == "cuda"
    want = outputs(rbf.global_rbf_closure(cpu_model), queries, "cpu")
    for model in (to(cpu_model, cuda), card_fit):
        got = outputs(rbf.global_rbf_closure(model), queries, cuda)
        for g4, w4 in zip(got, want):
            for g, w in zip(g4, w4):
                assert g.device.type == "cuda"
                assert rel(g, w) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,ridge", KNN_BRANCHES)
def test_knn_rbf_on_card_matches_cpu(cuda, kernel, ridge):
    q_p, q_s, queries = smooth_pairs(300, 6, 20, seed=2)
    cpu_model = rbf.fit_knn_rbf(q_p, q_s, 2.0, 30, kernel=kernel,
                                ridge=ridge, device="cpu")
    want = outputs(rbf.knn_rbf_closure(cpu_model), queries, "cpu")
    got = outputs(rbf.knn_rbf_closure(to(cpu_model, cuda)), queries, cuda)
    for g4, w4 in zip(got, want):
        for g, w in zip(g4, w4):
            assert rel(g, w) <= 1e-10


@pytest.mark.cuda
def test_knn_k100_at_the_250_training_size(cuda):
    """kNN with k = 100 on 1128 pairs of 10 -> 140 coordinates (the 250^2
    runners' training set after max_pairs): the same neighbours and the
    same interpolant on the card as on the CPU, by vmap over 64 queries
    too."""
    q_p, q_s, _ = smooth_pairs(1128, 10, 140, seed=3)
    queries = np.random.default_rng(4).uniform(-0.9, 0.9, size=(64, 10))
    cpu_model = rbf.fit_knn_rbf(q_p, q_s, 3.0, 100, device="cpu")
    card_model = to(cpu_model, cuda)
    for y in queries[:4]:
        yc, yg = torch.as_tensor(y), torch.as_tensor(y, device=cuda)
        xk_c, _ = rbf._knn_gather(cpu_model, cpu_model.scaler.transform(yc))
        xk_g, _ = rbf._knn_gather(card_model,
                                  card_model.scaler.transform(yg))
        assert sorted(map(tuple, xk_c.numpy())) == \
            sorted(map(tuple, xk_g.cpu().numpy()))
    cpu_pred = torch.func.vmap(
        lambda v: rbf.rbf_knn_predict(cpu_model, v))(
        torch.as_tensor(queries))
    card_pred = torch.func.vmap(
        lambda v: rbf.rbf_knn_predict(card_model, v))(
        torch.as_tensor(queries, device=cuda))
    assert card_pred.shape == (64, 140)
    assert rel(card_pred, cpu_pred) <= 1e-10


@pytest.mark.cuda
def test_train_searches_on_card_match_cpu(cuda):
    q_p, q_s, _ = smooth_pairs(150, 4, 12, seed=5)
    kw = dict(epsilons=[1.0, 2.0, 4.0], kernels=("gaussian", "matern"))
    _, cpu_log = rbf_train.train_global_rbf(q_p, q_s, device="cpu", **kw)
    model, card_log = rbf_train.train_global_rbf(q_p, q_s, device=cuda,
                                                 **kw)
    assert model.w_global.device.type == "cuda"
    assert card_log["best"]["kernel"] == cpu_log["best"]["kernel"]
    assert card_log["best"]["epsilon"] == cpu_log["best"]["epsilon"]
    for k in kw["kernels"]:
        np.testing.assert_allclose(card_log[k]["errors"],
                                   cpu_log[k]["errors"], rtol=1e-10)
    kw = dict(epsilons=[2.0, 4.0], neighbor_counts=[10, 20],
              ridges=[1e-8, 1e-5])
    _, cpu_log = rbf_train.train_knn_rbf_search(q_p, q_s, device="cpu", **kw)
    _, card_log = rbf_train.train_knn_rbf_search(q_p, q_s, device=cuda,
                                                 **kw)
    assert card_log["best"] == pytest.approx(cpu_log["best"], rel=1e-10)


@pytest.fixture(scope="module")
def rom_problem():
    """A 12^2 manifold problem on the CPU: two training trajectories, the
    8-mode POD split 3 + 5 and a global RBF closure model."""
    grid = Grid2D(nx=12, ny=12, x_up=100.0, y_up=100.0)
    w0 = torch.ones(grid.state_dim, dtype=F64)
    snaps = torch.cat([inviscid_burgers_implicit2d(grid, w0, DT, 20,
                                                   *mu).snaps
                       for mu in ((4.25, 0.0225), (5.5, 0.015))], dim=1)
    u = torch.linalg.svd(snaps, full_matrices=False)[0][:, :8]
    q = (u.T @ snaps).T
    model = rbf.fit_global_rbf(q[:, :3], q[:, 3:], 2.0, device="cpu")
    return grid, w0, u[:, :3], u[:, 3:], model


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampled"])
def test_manifold_rom_on_card_matches_cpu(cuda, rom_problem, sampled):
    grid, w0, u_p, u_s, model = rom_problem
    results = []
    for device in ("cpu", cuda):
        up, us = u_p.to(device), u_s.to(device)
        kw = {}
        if sampled:
            mesh = build_sampled_mesh(grid, np.arange(0, grid.n_cells, 3),
                                      device=device)
            idx = augmented_state_indices(mesh, grid.n_cells)
            weights = torch.linspace(0.5, 2.0, int(mesh.pos_self.numel()),
                                     dtype=F64, device=device)
            kw = dict(mesh=mesh, sample_weights=weights)
            up, us = up[idx], us[idx]
        closure = rbf.global_rbf_closure(to(model, device))
        dec, jac = cc.manifold_decoder(up, us, closure)
        fused = cc.manifold_decoder_fused(up, us, closure)
        y0 = u_p.to(device).T @ w0.to(device)
        results.append(manifold_rom(grid, y0, dec, jac, DT, 10, 4.75, 0.02,
                                    decode_and_jac=fused, **kw))
    cpu_res, card_res = results
    assert card_res.red_coords.device.type == "cuda"
    assert rel(card_res.red_coords, cpu_res.red_coords) <= 1e-10
    assert card_res.total_gn_its == cpu_res.total_gn_its


@pytest.mark.cuda
def test_pod_rbf_global_runner_on_card_matches_cpu(cuda, tmp_path):
    """run_pod_rbf_global at 12^2 in two directories sharing the basis and
    snapshot cache the CPU run wrote: the same chosen model and error."""
    from finitedifference_tpu_torch.runners import run_pod_rbf_global

    kw = dict(num_cells=12, num_steps=8, num_primary=3, num_secondary=5)
    cpu_dir, card_dir = tmp_path / "cpu", tmp_path / "card"
    cpu_dir.mkdir()
    old = os.getcwd()
    try:
        os.chdir(cpu_dir)
        _, err_cpu = run_pod_rbf_global.main(**kw, device="cpu")
        shutil.copytree(cpu_dir, card_dir)
        os.chdir(card_dir)
        os.remove("pod_rbf_global_model_p3_12x12.npz")
        _, err_card = run_pod_rbf_global.main(**kw, device="cuda")
    finally:
        os.chdir(old)
    assert abs(err_card - err_cpu) <= 1e-6
    zc = np.load(cpu_dir / "pod_rbf_global_model_p3_12x12.npz")
    zg = np.load(card_dir / "pod_rbf_global_model_p3_12x12.npz")
    assert str(zg["kernel"]) == str(zc["kernel"])
    assert float(zg["epsilon"]) == float(zc["epsilon"])
