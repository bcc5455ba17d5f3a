"""The GP closure, its fits and trainer, the other global-RBF searches and the
POD-GP runner on the card against the same calls on the CPU.

Tests marked `cuda` need an NVIDIA GPU and skip without one; on a machine
with a card run them with

    python -m pytest tests/test_torch_cuda_gp.py --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which this file does not
use).

Tolerances, card against CPU on the same float64 inputs: closure values
and Jacobians 1e-12 relative; fitted hyperparameters and held-out
predictions 1e-9 (30-60 Adam steps amplify the rounding of two Cholesky
builds), as for the full per-mode fit in two mode chunks on the card;
the searches' choices equal and their errors to 1e-8; the SVR solver's
duals to 1e-9; a runner's error 1e-6 percentage points.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch.closures import common as cc
from finitedifference_tpu_torch.closures import gp
from finitedifference_tpu_torch.training import gp_train
from finitedifference_tpu_torch.training import rbf_train
from finitedifference_tpu_torch.training.svr import fit_svr


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU references here are small: torch's intra-op threads only
    spin, and their load slows the tests that share the machine. One
    thread for the module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """n pairs of a smooth map R^n_p -> R^n_s with outputs over four orders
    of magnitude, and 5 queries."""
    rng = np.random.default_rng(seed)
    q_p = rng.uniform(-1, 1, size=(n, n_p))
    mix = rng.normal(size=(n_p, n_s))
    q_s = (np.sin(q_p @ mix) + 0.1 * (q_p ** 2) @ np.abs(mix)) \
        * np.logspace(0, -4, n_s)
    return q_p, q_s, rng.uniform(-0.9, 0.9, size=(5, n_p))


def to(model, device):
    """A GP model's tensors moved to `device`."""
    def mv(x):
        return x.to(device) if isinstance(x, torch.Tensor) else x
    scaler = cc.MinMaxScaler(*map(mv, model.scaler))
    return type(model)(*(scaler if f is model.scaler else mv(f)
                         for f in model))


def outputs(model, queries, device):
    closure = gp.gp_closure(model)
    out = []
    for y in queries:
        y = torch.as_tensor(y, device=device)
        p, j = closure.predict_and_jacobian(y)
        out.append(torch.cat([closure.predict(y), closure.jacobian(y).ravel(),
                              p, j.ravel()]))
    return torch.stack(out)


FITS = {
    "iso": lambda q_p, q_s, d: gp.fit_gp(q_p, q_s, num_steps=40, device=d),
    "ard_nu25": lambda q_p, q_s, d: gp.fit_gp(q_p, q_s, num_steps=40,
                                              ard=True, nu=2.5, noise=1e-6,
                                              device=d),
    "scales": lambda q_p, q_s, d: gp.fit_gp_per_mode(q_p, q_s, num_steps=40,
                                                     device=d),
    "full": lambda q_p, q_s, d: gp.fit_gp_full_per_mode(
        q_p, q_s, num_steps=40, device=d),
    "variational": lambda q_p, q_s, d: gp.fit_gp_variational(
        q_p, q_s, num_inducing=32, num_steps=40, device=d),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FITS))
def test_gp_fit_and_closure_on_card_match_cpu(cuda, name):
    q_p, q_s, queries = smooth_pairs(200, 6, 12, seed=1)
    cpu = FITS[name](q_p, q_s, "cpu")
    card = FITS[name](q_p, q_s, cuda)
    assert card.alpha.device.type == "cuda"
    assert type(card) is type(cpu)
    for field in ("amplitude", "length_scale", "x_train"):
        assert rel(getattr(card, field), getattr(cpu, field)) <= 1e-9
    assert abs(card.noise - cpu.noise) <= 1e-9 * cpu.noise
    want = outputs(cpu, queries, "cpu")
    assert rel(outputs(card, queries, cuda), want) <= 1e-9
    # the CPU model carried to the card: the closure alone
    assert rel(outputs(to(cpu, cuda), queries, cuda), want) <= 1e-12


@pytest.mark.cuda
def test_full_per_mode_chunks_on_card(cuda):
    """The mode chunk bounds memory and leaves the result as it is to
    rounding on the card (cuBLAS and cuSOLVER pick their batched routines
    by the batch's size, so not bit for bit as on the CPU); at the 250^2
    training size (1,128 pairs, 10 -> 140) a few steps run in the
    default chunks."""
    q_p, q_s, _ = smooth_pairs(200, 6, 12, seed=2)
    a, b = (gp.fit_gp_full_per_mode(q_p, q_s, num_steps=20, mode_chunk=c,
                                    device=cuda) for c in (5, 12))
    for field in ("alpha", "length_scale", "amplitude"):
        assert rel(getattr(a, field), getattr(b, field)) <= 1e-9
    q_p, q_s, _ = smooth_pairs(1128, 10, 140, seed=3)
    big = gp.fit_gp_full_per_mode(q_p, q_s, num_steps=3, device=cuda)
    assert big.alpha.shape == (1128, 140)
    assert big.length_scale.shape == (140, 10)
    assert bool(torch.isfinite(big.alpha).all())


@pytest.mark.cuda
def test_train_gp_defaults_to_the_card(cuda, tmp_path):
    q_p, q_s, queries = smooth_pairs(120, 4, 6, seed=4)
    model = gp_train.train_gp(q_p, q_s, num_steps=20, noise=1e-6)
    assert model.alpha.device.type == "cuda"
    cpu = gp_train.train_gp(q_p, q_s, num_steps=20, noise=1e-6,
                            device="cpu")
    assert rel(outputs(model, queries, cuda),
               outputs(cpu, queries, "cpu")) <= 1e-9
    path = str(tmp_path / "m.npz")
    gp_train.save_gp(model, path)
    back = gp_train.load_gp(path)
    assert back.alpha.device.type == "cuda"
    assert torch.equal(back.alpha, model.alpha)


@pytest.mark.cuda
def test_searches_on_card_match_cpu(cuda):
    q_p, q_s, queries = smooth_pairs(150, 4, 8, seed=5)
    kw = dict(epsilons=[1.0, 2.0, 4.0], kernels=("gaussian", "imq"),
              n_folds=3)
    _, cpu_log = rbf_train.train_global_rbf_cv(q_p, q_s, device="cpu", **kw)
    model, card_log = rbf_train.train_global_rbf_cv(q_p, q_s, device=cuda,
                                                    **kw)
    assert model.w_global.device.type == "cuda"
    assert card_log["best"] == pytest.approx(cpu_log["best"], rel=1e-8)
    kw = dict(n_iters=8, n_seed=4)
    _, cpu_log = rbf_train.train_global_rbf_bayesian(q_p, q_s,
                                                     device="cpu", **kw)
    _, card_log = rbf_train.train_global_rbf_bayesian(q_p, q_s,
                                                      device=cuda, **kw)
    assert card_log["history"]["log10_eps"] == \
        cpu_log["history"]["log10_eps"]
    np.testing.assert_allclose(card_log["history"]["log_err"],
                               cpu_log["history"]["log_err"], rtol=1e-8,
                               atol=1e-12)
    _, cpu_info = rbf_train.fit_global_rbf_anisotropic(
        q_p, q_s, num_steps=30, device="cpu")
    _, card_info = rbf_train.fit_global_rbf_anisotropic(
        q_p, q_s, num_steps=30, device=cuda)
    np.testing.assert_allclose(card_info["scales"], cpu_info["scales"],
                               rtol=1e-8)
    cpu_c, cpu_info = rbf_train.train_svr(q_p, q_s, c_grid=(0.1, 1.0),
                                          device="cpu")
    card_c, card_info = rbf_train.train_svr(q_p, q_s, c_grid=(0.1, 1.0),
                                            device=cuda)
    assert card_info == pytest.approx(cpu_info, rel=1e-8)
    y = torch.as_tensor(queries[0])
    assert rel(card_c.predict(y.to(cuda)), cpu_c.predict(y)) <= 1e-8
    assert rel(card_c.jacobian(y.to(cuda)), cpu_c.jacobian(y)) <= 1e-8


@pytest.mark.cuda
def test_svr_solver_on_card_matches_cpu(cuda):
    """The batched SMO on the card and on the CPU: the same iterations and
    duals (the kernel is rounded to float32 in both)."""
    q_p, q_s, _ = smooth_pairs(300, 5, 16, seed=6)
    x = torch.as_tensor(q_p)
    y = torch.as_tensor(q_s)
    cpu = fit_svr(x, y, 1.0, 1e-3, 0.5)
    card = fit_svr(x.to(cuda), y.to(cuda), 1.0, 1e-3, 0.5)
    assert torch.equal(card.n_iter.cpu(), cpu.n_iter)
    assert rel(card.dual_coef, cpu.dual_coef) <= 1e-9
    assert rel(card.intercept, cpu.intercept) <= 1e-9


@pytest.mark.cuda
def test_pod_gp_runner_on_card_matches_cpu(cuda, tmp_path):
    """run_pod_gp_hprom --compute-ecsw at 12^2 in two directories sharing the
    basis and snapshot cache the CPU run wrote: the same N_e and error."""
    from finitedifference_tpu_torch.runners import run_pod_gp_hprom

    kw = dict(num_cells=12, num_steps=8, num_primary=3, num_secondary=5,
              compute_ecsw=True)
    cpu_dir, card_dir = tmp_path / "cpu", tmp_path / "card"
    cpu_dir.mkdir()
    old = os.getcwd()
    try:
        os.chdir(cpu_dir)
        _, err_cpu = run_pod_gp_hprom.main(**kw, device="cpu")
        shutil.copytree(cpu_dir, card_dir)
        os.chdir(card_dir)
        os.remove("pod_gp_model_12x12.npz")
        _, err_card = run_pod_gp_hprom.main(**kw, device="cuda")
    finally:
        os.chdir(old)
    assert abs(err_card - err_cpu) <= 1e-6
    wc = np.load(cpu_dir / "ecsw_weights_gp_nnls_12x12.npy")
    wg = np.load(card_dir / "ecsw_weights_gp_nnls_12x12.npy")
    assert int((wg > 0).sum()) == int((wc > 0).sum())
