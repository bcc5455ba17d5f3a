"""The port's RBF fits (finitedifference_tpu_torch.training.rbf_train)
against the JAX package's, on the CPU, float64.

- remove_duplicates keeps the same rows;
- train_global_rbf picks the same (kernel, epsilon) on the default
  16-point epsilon grid and the five kernels, every validation error
  within 1e-8 (relative; the ill-conditioned small-epsilon candidates
  measured 3e-9), and its refit predicts as JAX's does (1e-10);
- train_knn_rbf_search picks the same (k, epsilon, ridge) on a small
  grid, every error within 1e-8;
- the .npz model file written by either package loads in the other, with
  the same keys and weights, and predicts the same (1e-10: the chosen
  multiquadric's phi(r) @ W cancels, measured 1.5e-12).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu.closures import rbf as jrbf
from finitedifference_tpu.training import rbf_train as jtrain
from finitedifference_tpu.training import rnm_train as jrnm
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.closures import rbf as trbf
from finitedifference_tpu_torch.training import rbf_train as ttrain
from finitedifference_tpu_torch.training import rnm_train as trnm

to_torch = functools.partial(convert.to_torch, device="cpu")
KERNELS = ("gaussian", "imq", "multiquadric", "linear", "matern")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads only spin, and
    their load slows the tests that share the machine. One thread for the
    module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return np.linalg.norm(a - np.asarray(b)) / np.linalg.norm(np.asarray(b))


@pytest.fixture(scope="module")
def pairs():
    """76 pairs of a smooth map q_p (3) -> q_s (4), six of them repeated
    within the dedup tolerance (1e-10 apart)."""
    rng = np.random.default_rng(3)
    q_p = rng.uniform(-2, 3, size=(70, 3)) * np.array([1.0, 0.5, 2.0])
    q_p = np.vstack([q_p, q_p[:6] + 1e-10])
    q_s = np.stack([np.sin(q_p[:, 0]) + q_p[:, 1] ** 2,
                    np.cos(q_p[:, 2]) * q_p[:, 0],
                    np.tanh(q_p.sum(1)), q_p[:, 1] * q_p[:, 2]], 1)
    queries = rng.uniform(-2, 3, size=(5, 3)) * np.array([1.0, 0.5, 2.0])
    return q_p, q_s, queries


@pytest.fixture(scope="module")
def global_fits(pairs):
    q_p, q_s, _ = pairs
    return (jtrain.train_global_rbf(q_p, q_s),
            ttrain.train_global_rbf(q_p, q_s, device="cpu"))


def test_remove_duplicates_matches_jax(pairs):
    q_p, q_s, _ = pairs
    jp, js = jtrain.remove_duplicates(q_p, q_s)
    tp, ts = ttrain.remove_duplicates(torch.as_tensor(q_p), q_s)
    assert tp.shape == (70, 3) and ts.shape == (70, 4)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)
    # the first occurrences, in their order
    np.testing.assert_array_equal(tp, q_p[:70])


def test_project_snapshots_matches_jax():
    rng = np.random.default_rng(4)
    basis = np.linalg.qr(rng.normal(size=(40, 6)))[0]
    snaps_t = rng.normal(size=(9, 40))
    mu = rng.normal(size=(9, 2))
    for kw in ({}, {"num_secondary": 2}, {"mu_labels": mu}):
        want = jrnm.project_snapshots(basis, snaps_t, 3, **kw)
        got = trnm.project_snapshots(basis, snaps_t, 3, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got[0].shape == (9, 5)


def test_train_global_rbf_picks_jax_model(global_fits):
    (jm, jlog), (tm, tlog) = global_fits
    assert tlog["best"]["kernel"] == jlog["best"]["kernel"]
    assert tlog["best"]["epsilon"] == jlog["best"]["epsilon"]
    assert (tm.kernel, tm.epsilon) == (jm.kernel, jm.epsilon)
    assert abs(tlog["best"]["val_error"] / jlog["best"]["val_error"]
               - 1) <= 1e-8
    for kernel in KERNELS:
        assert tlog[kernel]["epsilons"] == jlog[kernel]["epsilons"]
        assert len(tlog[kernel]["errors"]) == 16
        np.testing.assert_allclose(tlog[kernel]["errors"],
                                   jlog[kernel]["errors"], rtol=1e-8)
    # the refit on all the deduped data: same scaled set, same predictions
    np.testing.assert_allclose(tm.q_p_train.numpy(),
                               np.asarray(jm.q_p_train), rtol=1e-14,
                               atol=1e-14)


def test_train_global_rbf_refit_predicts_as_jax(global_fits, pairs):
    (jm, _), (tm, _) = global_fits
    for y in pairs[2]:
        want = np.asarray(jrbf.rbf_global_predict(jm, jnp.asarray(y)))
        got = trbf.rbf_global_predict(tm, to_torch(y))
        assert rel(got, want) <= 1e-10


def test_train_global_rbf_ties_go_to_the_first(pairs):
    """Two kernels with the same errors: the first listed wins, in both
    packages (strict < over kernels, nanargmin over epsilons)."""
    q_p, q_s, _ = pairs
    kw = dict(epsilons=[0.5, 0.5, 2.0], kernels=("linear", "linear"))
    _, jlog = jtrain.train_global_rbf(q_p, q_s, **kw)
    _, tlog = ttrain.train_global_rbf(q_p, q_s, device="cpu", **kw)
    assert tlog["best"]["epsilon"] == jlog["best"]["epsilon"] == 0.5


def test_train_knn_rbf_search_picks_jax_model(pairs):
    q_p, q_s, queries = pairs
    kw = dict(epsilons=[0.3, 1.0, 3.0], neighbor_counts=[5, 10],
              ridges=[1e-8, 1e-5])
    jm, jlog = jtrain.train_knn_rbf_search(q_p, q_s, **kw)
    tm, tlog = ttrain.train_knn_rbf_search(q_p, q_s, device="cpu", **kw)
    for key in ("neighbors", "epsilon", "ridge"):
        assert tlog["best"][key] == jlog["best"][key]
    assert (tm.neighbors, tm.epsilon, tm.ridge) == \
        (jm.neighbors, jm.epsilon, jm.ridge)
    assert set(tlog["grid"]) == set(jlog["grid"])
    for key, err in jlog["grid"].items():
        assert abs(tlog["grid"][key] / err - 1) <= 1e-8
    for y in queries:
        want = np.asarray(jrbf.rbf_knn_predict(jm, jnp.asarray(y)))
        assert rel(trbf.rbf_knn_predict(tm, to_torch(y)), want) <= 1e-10


def test_knn_search_default_grid_counts(pairs):
    """Without a grid: 8 epsilons, the counts of (10, 20, 50, 100) that
    fit the training split, four ridges (here on a 16-point set)."""
    q_p, q_s, _ = pairs
    model, log = ttrain.train_knn_rbf_search(q_p[:20], q_s[:20],
                                             device="cpu")
    assert len(log["grid"]) == 8 * 1 * 4
    assert model.neighbors == 10


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_model_file_loads_in_both_packages(global_fits, pairs, writer,
                                           tmp_path):
    (jm, _), (tm, _) = global_fits
    path = str(tmp_path / "pod_rbf_global_model.npz")
    if writer == "jax":
        jtrain.save_global_rbf(jm, path)
    else:
        ttrain.save_global_rbf(tm, path)
    z = np.load(path, allow_pickle=True)
    assert sorted(z.files) == sorted(["w_global", "q_p_train", "epsilon",
                                      "kernel", "scaler_scale",
                                      "scaler_min"])
    jl = jtrain.load_global_rbf(path)
    tl = ttrain.load_global_rbf(path, device="cpu")
    assert tl.w_global.device.type == "cpu"
    assert (tl.kernel, tl.epsilon) == (jl.kernel, jl.epsilon)
    src = jm if writer == "jax" else tm
    for y in pairs[2]:
        want = np.asarray(jrbf.rbf_global_predict(jl, jnp.asarray(y)))
        got = trbf.rbf_global_predict(tl, to_torch(y))
        assert rel(got, want) <= 1e-10
        j = trbf.rbf_global_jacobian(tl, to_torch(y))
        assert rel(j, np.asarray(jrbf.rbf_global_jacobian(
            jl, jnp.asarray(y)))) <= 1e-10
    np.testing.assert_array_equal(tl.w_global.numpy(),
                                  np.asarray(src.w_global))


def test_fits_need_a_card_or_cpu(pairs, monkeypatch, tmp_path):
    q_p, q_s, _ = pairs
    path = str(tmp_path / "m.npz")
    jtrain.save_global_rbf(jtrain.train_global_rbf(q_p, q_s)[0], path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ttrain.train_global_rbf(q_p, q_s),
                 lambda: ttrain.train_knn_rbf_search(q_p, q_s),
                 lambda: ttrain.load_global_rbf(path)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
