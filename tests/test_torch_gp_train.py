"""The port's GP trainer and model file (finitedifference_tpu_torch.training
.gp_train) against the JAX package's, on the CPU, float64.

- train_gp with each per_mode (none, scales, full, variational) on the
  same 64 pairs (4 of them repeated, so dedup drops them): the same model
  type, hyperparameters and held-out closure values within 1e-10
  relative (measured ~1e-13 after 30 Adam steps), and the same verbose
  line;
- save_gp writes the JAX package's keys; each package loads the other's
  file (GPModel and PerModeGPModel) and predicts as the writer's model
  does, to 1e-12; a file without nu loads with nu 1.5, one without
  per_mode as a GPModel;
- an unknown per_mode raises ValueError; without a card and without
  device="cpu", train_gp fails at once.
"""

import contextlib
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu.closures import gp as jgp
from finitedifference_tpu.training import gp_train as jtrain
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.closures import gp as tgp
from finitedifference_tpu_torch.training import gp_train as ttrain

to_torch = functools.partial(convert.to_torch, device="cpu")
FIT_TOL = 1e-10
KEYS = ["alpha", "amplitude", "length_scale", "noise", "nu", "per_mode",
        "scaler_min", "scaler_scale", "x_train"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads only spin, and
    their load slows the tests that share the machine. One thread for the
    module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def rel(a, b):
    a, b = npy(a), npy(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def data():
    """60 distinct pairs R^3 -> R^4 plus 4 repeats, and 5 queries."""
    rng = np.random.default_rng(11)
    q_p = rng.uniform(-1, 2, size=(60, 3))
    q_s = np.stack([np.sin(2 * q_p[:, 0]) * q_p[:, 1], np.cos(q_p.sum(1)),
                    0.01 * q_p[:, 2] ** 2, 1e-3 * np.tanh(q_p[:, 0])], 1)
    q_p = np.concatenate([q_p, q_p[:4]])
    q_s = np.concatenate([q_s, q_s[:4]])
    return q_p, q_s, rng.uniform(-0.8, 1.8, size=(5, 3))


def closure_values(closure, queries, to):
    return np.stack([np.concatenate([npy(p).ravel(), npy(j).ravel()])
                     for p, j in (closure.predict_and_jacobian(to(q))
                                  for q in queries)])


def train(package, per_mode, q_p, q_s):
    kw = dict(noise=1e-6, num_steps=30, per_mode=per_mode, num_inducing=16,
              verbose=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model = package.train_gp(q_p, q_s, **kw) if package is jtrain \
            else package.train_gp(q_p, q_s, device="cpu", **kw)
    return model, out.getvalue()


@pytest.fixture(scope="module")
def trained(data):
    q_p, q_s, _ = data
    return {pm: (train(jtrain, pm, q_p, q_s), train(ttrain, pm, q_p, q_s))
            for pm in ttrain.PER_MODE}


@pytest.mark.parametrize("per_mode", ["none", "scales", "full",
                                      "variational"])
def test_train_gp_matches_jax(trained, data, per_mode):
    (jm, jout), (tm, tout) = trained[per_mode]
    cls = tgp.PerModeGPModel if per_mode == "full" else tgp.GPModel
    assert type(tm) is cls and type(jm).__name__ == cls.__name__
    n_train = 16 if per_mode == "variational" else 60   # deduped
    assert tm.x_train.shape == (n_train, 3)
    assert rel(tm.amplitude, jm.amplitude) <= FIT_TOL
    assert rel(tm.length_scale, jm.length_scale) <= FIT_TOL
    assert abs(tm.noise - jm.noise) <= FIT_TOL * jm.noise
    want = closure_values(jgp.gp_closure(jm), data[2], jnp.asarray)
    got = closure_values(tgp.gp_closure(tm), data[2], to_torch)
    assert rel(got, want) <= FIT_TOL
    assert tout.startswith("  gp: amplitude=")
    assert tout.count("length_scale=") == jout.count("length_scale=") == 1


@pytest.mark.parametrize("per_mode", ["none", "full"])
def test_model_files_load_both_ways(trained, data, tmp_path, per_mode):
    (jm, _), (tm, _) = trained[per_mode]
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jtrain.save_gp(jm, jpath)
    ttrain.save_gp(tm, tpath)
    zj, zt = np.load(jpath), np.load(tpath)
    assert sorted(zt.files) == sorted(zj.files) == KEYS
    for key in KEYS:
        assert zt[key].shape == zj[key].shape
        assert zt[key].dtype == zj[key].dtype
    assert bool(zt["per_mode"]) == (per_mode == "full")
    # the port reads the JAX file, and JAX reads the port's
    t_from_j = ttrain.load_gp(jpath, device="cpu")
    j_from_t = jtrain.load_gp(tpath)
    assert type(t_from_j).__name__ == type(jm).__name__
    assert type(j_from_t).__name__ == type(tm).__name__
    queries = data[2]
    assert rel(closure_values(tgp.gp_closure(t_from_j), queries, to_torch),
               closure_values(jgp.gp_closure(jm), queries,
                              jnp.asarray)) <= 1e-12
    assert rel(closure_values(jgp.gp_closure(j_from_t), queries,
                              jnp.asarray),
               closure_values(tgp.gp_closure(tm), queries,
                              to_torch)) <= 1e-12


def test_old_model_file_defaults(trained, tmp_path):
    """A file without nu and per_mode (an older save): nu 1.5, GPModel."""
    (_, _), (tm, _) = trained["none"]
    path = str(tmp_path / "old.npz")
    np.savez(path, x_train=npy(tm.x_train), alpha=npy(tm.alpha),
             length_scale=npy(tm.length_scale),
             amplitude=npy(tm.amplitude), noise=tm.noise,
             scaler_scale=npy(tm.scaler.scale_),
             scaler_min=npy(tm.scaler.min_))
    got = ttrain.load_gp(path, device="cpu")
    want = jtrain.load_gp(path)
    assert type(got) is tgp.GPModel and got.nu == want.nu == 1.5
    assert torch.equal(got.alpha, tm.alpha)


def test_train_gp_rejects_unknown_per_mode_and_needs_a_device(
        data, monkeypatch):
    q_p, q_s, _ = data
    with pytest.raises(ValueError, match="unknown per_mode"):
        ttrain.train_gp(q_p, q_s, per_mode="mixed", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train_gp(q_p, q_s, num_steps=2)
