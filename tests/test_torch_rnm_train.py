"""The port's RNM trainer and training monitor against the JAX package's, on
the CPU.

- TrainingMonitor on scripted loss sequences: the same stop decisions,
  epochs, best criteria and sidecar JSON, key for key; load_from_path
  restores the same epoch and histories.
- One _train_epoch from the same parameters (a Flax init carried across
  by convert.rnm_from_flax) with JAX's permutation (jax.random.
  permutation(sub, n)[:num_batches * batch_size], as JAX's _train_epoch
  draws it): float64 parameters, the epoch's loss and the evaluation
  loss after it to 1e-10 (measured 1e-15); float32 to 1.2e-5, three times
  the largest measured (the evaluation loss 3.8e-6, the epoch's loss
  9e-7, the parameters 1.6e-7: XLA's and PyTorch's f32 GEMMs sum in
  different orders, and Adam's division by the root of the second moment
  lifts the rounding of small gradients to the step's size).
- train_rnm splits the pairs into JAX's training and validation rows,
  learns the smooth map of tests/test_training.py to the same 0.1 bound,
  returns the best checkpoint, resumes with the epoch carried on, and
  prints JAX's verbose lines.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finitedifference_tpu.closures import ann as jann
from finitedifference_tpu.training import monitor as jmon
from finitedifference_tpu.training import rnm_train as jrnm
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.closures import ann as tann
from finitedifference_tpu_torch.training import minibatch
from finitedifference_tpu_torch.training import monitor as tmon
from finitedifference_tpu_torch.training import rnm_train as trnm

to_torch = functools.partial(convert.to_torch, device="cpu")
EPOCH_TOL = {np.float64: 1e-10, np.float32: 1.2e-5}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads only spin, and
    their load slows the tests that share the machine. One thread for the
    module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth_pairs(n=200, n_p=3, n_s=4, seed=0):
    """tests/test_training.py's smooth map."""
    rng = np.random.default_rng(seed)
    q_p = rng.uniform(-1, 1, size=(n, n_p))
    a = rng.normal(size=(n_p, n_s))
    q_s = np.tanh(q_p @ a)
    return q_p, q_s


def flat_flax(params):
    """A Flax RNM_NN's parameters in the port's flat order."""
    dense = params["params"]
    parts = []
    for i in range(len(dense)):
        parts += [np.asarray(dense[f"Dense_{i}"]["kernel"]).T.ravel(),
                  np.asarray(dense[f"Dense_{i}"]["bias"])]
    return np.concatenate(parts)


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.linalg.norm(a - np.asarray(b)) / np.linalg.norm(np.asarray(b))


SCRIPTS = [
    # (patience, [(train, val), ...])
    (2, [(1.0, 1.0), (1.0, 2.0), (1.0, 2.0), (1.0, 2.0), (0.5, 0.5)]),
    (1, [(1.0, 3.0), (1.0, 4.0), (1.0, 2.0), (1.0, 5.0), (1.0, 5.0)]),
    (0, [(2.0, 1.0), (1.5, 1.0), (1.0, 0.5)]),
    (3, [(4.0, 4.0), (3.0, 3.0), (2.0, 2.0), (1.0, 1.0), (1.0, 1.0),
         (0.5, 1.0), (0.25, 0.9)]),
]


@pytest.mark.parametrize("patience, script", SCRIPTS)
def test_monitor_matches_jax(patience, script, tmp_path):
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.pt")
    jm = jmon.TrainingMonitor(jpath, patience)
    tm = tmon.TrainingMonitor(tpath, patience)
    net = tann.init_rnm(2, 3, device="cpu")
    state = {"w": jnp.ones(3)}
    for train, val in script:
        want = jm.check_for_completion(train, val, state)
        got = tm.check_for_completion(train, val, net)
        assert got == want
        assert (tm.epoch, tm.best_crit, tm.its_since_improvement) == \
            (jm.epoch, jm.best_crit, jm.its_since_improvement)
        with open(jpath + ".json") as f:
            want_meta = json.load(f)
        with open(tpath + ".json") as f:
            got_meta = json.load(f)
        assert list(got_meta) == list(want_meta)
        assert got_meta == want_meta
    jfresh = jmon.TrainingMonitor(jpath, patience)
    tfresh = tmon.TrainingMonitor(tpath, patience)
    jfresh.load_from_path(jpath, {"w": jnp.zeros(3)})
    back = tfresh.load_from_path(tpath, tann.init_rnm(
        2, 3, generator=torch.Generator().manual_seed(4), device="cpu"))
    for a, b in zip(net.parameters(), back.parameters()):
        assert torch.equal(a, b)
    for field in ("epoch", "best_crit", "train_losses", "test_crits"):
        assert getattr(tfresh, field) == getattr(jfresh, field)


def test_checkpoint_keeps_its_dtype(tmp_path):
    """Like Flax's from_bytes, load_checkpoint keeps the saved tensors'
    dtype whatever the module's."""
    path = str(tmp_path / "m.pt")
    net64 = tann.init_rnm(3, 5, dtype=torch.float64, device="cpu")
    tmon.TrainingMonitor(path, 1).save_checkpoint(net64)
    back = tmon.load_checkpoint(path, tann.init_rnm(3, 5, device="cpu"))
    for a, b in zip(net64.parameters(), back.parameters()):
        assert b.dtype == torch.float64 and torch.equal(a, b)
        assert b.requires_grad


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_train_epoch_matches_jax(dtype):
    q_p, q_s = smooth_pairs(n=100)
    q_p, q_s = q_p.astype(dtype), q_s.astype(dtype)
    module, params = jann.init_rnm(3, 4, key=jax.random.PRNGKey(2))
    params = jax.tree_util.tree_map(lambda x: x.astype(dtype), params)
    bs, lr = 16, 3e-3
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=lr)
    key = jax.random.PRNGKey(5)
    want_p, _, want_loss = jrnm._train_epoch(
        module, opt, params, opt.init(params), jnp.asarray(q_p),
        jnp.asarray(q_s), key, bs)
    nb = q_p.shape[0] // bs
    perm = np.asarray(jax.random.permutation(key, q_p.shape[0]))[:nb * bs]
    net = convert.rnm_from_flax(params, device="cpu")
    _, got_loss = trnm._train_epoch(
        net, minibatch.adam_init_flat(net), to_torch(q_p), to_torch(q_s),
        torch.as_tensor(perm.copy()), bs, lr)
    assert rel(minibatch.flat_params(net)[0], flat_flax(want_p)) \
        <= EPOCH_TOL[dtype]
    assert abs(float(got_loss) - float(want_loss)) \
        <= EPOCH_TOL[dtype] * abs(float(want_loss))
    got_val = trnm._eval_loss(net, to_torch(q_p), to_torch(q_s))
    want_val = jrnm._eval_loss(module, want_p, jnp.asarray(q_p),
                               jnp.asarray(q_s))
    assert abs(float(got_val) - float(want_val)) \
        <= EPOCH_TOL[dtype] * abs(float(want_val))


def test_split_matches_jax(monkeypatch, tmp_path):
    """Both trainers see the same training and validation rows: each
    trainer's epoch and evaluation are replaced by recorders for one
    epoch, on pairs whose first column is the row number."""
    q_p, q_s = smooth_pairs(n=50)
    q_p[:, 0] = np.arange(50)
    seen = {}

    def jax_epoch(module, opt, params, opt_state, qp, qs, key, bs):
        seen["jax_train"] = np.asarray(qp[:, 0])
        return params, opt_state, jnp.asarray(1.0)

    def jax_eval(module, params, qp, qs):
        seen["jax_val"] = np.asarray(qp[:, 0])
        return jnp.asarray(1.0)

    def port_epoch(module, state, qp, qs, perm, bs, lr):
        seen["port_train"] = qp[:, 0].numpy()
        return state, torch.tensor(1.0)

    def port_eval(module, qp, qs):
        seen["port_val"] = qp[:, 0].numpy()
        return torch.tensor(1.0)

    monkeypatch.setattr(jrnm, "_train_epoch", jax_epoch)
    monkeypatch.setattr(jrnm, "_eval_loss", jax_eval)
    monkeypatch.setattr(trnm, "_train_epoch", port_epoch)
    monkeypatch.setattr(trnm, "_eval_loss", port_eval)
    jrnm.train_rnm(q_p, q_s, epochs=1, seed=17,
                   model_path=str(tmp_path / "j.msgpack"))
    trnm.train_rnm(q_p, q_s, epochs=1, seed=17,
                   model_path=str(tmp_path / "t.pt"), device="cpu")
    assert seen["port_train"].size == 45 and seen["port_val"].size == 5
    np.testing.assert_array_equal(seen["port_train"], seen["jax_train"])
    np.testing.assert_array_equal(seen["port_val"], seen["jax_val"])


def test_train_rnm_learns_smooth_map(tmp_path, capsys):
    """tests/test_training.py's case through the port: error under 0.1
    on the first 20 pairs, the module holding the best checkpoint."""
    q_p, q_s = smooth_pairs()
    path = str(tmp_path / "rnm.pt")
    net, mon = trnm.train_rnm(q_p, q_s, epochs=300, lr=3e-3,
                              batch_size=32, patience=100,
                              model_path=path, verbose=True, device="cpu")
    assert isinstance(net, tann.RNM_NN)
    with torch.no_grad():
        pred = net(to_torch(q_p[:20], dtype=torch.float32)).numpy()
    err = np.linalg.norm(pred - q_s[:20]) / np.linalg.norm(q_s[:20])
    assert err < 0.1
    best = torch.load(path, weights_only=True)
    for name, p in net.state_dict().items():
        assert torch.equal(p, best[name])
    assert mon.best_crit == min(mon.test_crits)
    assert mon.epoch == len(mon.test_crits)
    out = capsys.readouterr().out
    assert "  epoch 0: train " in out and "  epoch 200: train " in out
    assert "s/epoch" in out


def test_resume_continues_from_checkpoint(tmp_path):
    """tests/test_training.py's resume case: interrupted at epoch 60, the
    resumed run carries the epoch on, ends at least as good, and its
    history is contiguous."""
    q_p, q_s = smooth_pairs()
    path = str(tmp_path / "rnm.pt")
    _, mon1 = trnm.train_rnm(q_p, q_s, epochs=60, lr=3e-3, batch_size=32,
                             patience=100, model_path=path, device="cpu")
    _, mon2 = trnm.train_rnm(q_p, q_s, epochs=150, lr=3e-3, batch_size=32,
                             patience=100, model_path=path, resume=True,
                             device="cpu")
    assert mon2.epoch > 60
    assert mon2.best_crit <= mon1.best_crit
    assert len(mon2.train_losses) == mon2.epoch


def test_plateau_cuts_the_learning_rate(tmp_path, capsys):
    """A plateau patience of 2 epochs on a stalled fit: the learning rate
    halves with JAX's "lr ->" line, never below min_lr."""
    q_p, q_s = smooth_pairs(n=40)
    trnm.train_rnm(q_p, q_s, epochs=40, lr=1e-6, batch_size=8,
                   patience=100, plateau_patience=2, plateau_threshold=0.5,
                   min_lr=2e-7, model_path=str(tmp_path / "p.pt"),
                   verbose=True, device="cpu")
    cuts = [float(x.split("lr -> ")[1]) for x in
            capsys.readouterr().out.splitlines() if "lr -> " in x]
    assert cuts[:3] == [5e-7, 2.5e-7, 2e-7] and len(cuts) == 3
