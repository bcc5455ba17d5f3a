"""The port's autoencoder, its trainer and training/data against the JAX
package's, on the CPU.

Every network compared is a Flax Autoencoder initialised from a JAX key
and carried across by convert.ae_from_flax, at input widths 24-40:
- encode, decode (one vector, and a batch of columns against jax.vmap),
  forward and the torch.func.jacfwd decoder Jacobian against Flax apply
  and jax.jacfwd, on the runner's two dtype paths: the load path (a
  float32 network, float64 standardisation and state) and the retrain
  path (float32 throughout), and on a float64 network. Tolerances,
  relative: the float64 network 1e-12 (measured 9e-16 at most); the
  float32 network 2e-6, three times the largest measured (6.3e-7, the
  encoder on a batch of columns: XLA's and PyTorch's f32 GEMMs sum in
  different orders);
- the init: zero biases, kernels inside +-2 std, the sample std within 5%
  of sqrt(1 / fan_in) on the wide layers, float32 parameters whatever
  the input's dtype, a float64 input computed in float64 (Flax's
  promotion);
- one _train_epoch from the same parameters with JAX's permutation, and
  _eval_loss after it: float64 network and data to 1e-10 (measured
  8e-15 for the parameters, 1.1e-14 for the evaluation loss); float32 to
  5e-6, three times the largest measured (1.6e-6 for the evaluation
  loss, 1.5e-6 for the parameters: Adam's division by the root of the
  second moment lifts the rounding of small gradients to the step's
  size);
- train_autoencoder: JAX's training and validation rows and
  standardisation, reconstruction as tests/test_training.py's
  TestAETraining, the best checkpoint and its sidecar;
- training/data on a JAX-written 12^2 snapshot cache, bit for bit.
"""

import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finitedifference_tpu.closures import autoencoder as jae
from finitedifference_tpu.training import ae_train as jtrain
from finitedifference_tpu.training import data as jdata
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.closures import ann as tann
from finitedifference_tpu_torch.closures import autoencoder as tae
from finitedifference_tpu_torch.training import ae_train as ttrain
from finitedifference_tpu_torch.training import data as tdata
from finitedifference_tpu_torch.training import minibatch
from finitedifference_tpu_torch.training import monitor as tmon

to_torch = functools.partial(convert.to_torch, device="cpu")
DIM, LATENT = 24, 3
NET_TOL = {"float64": 1e-12, "float32": 2e-6}
EPOCH_TOL = {np.float64: 1e-10, np.float32: 5e-6}


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
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.linalg.norm(a - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def snapshots(n=60, dim=DIM, seed=0):
    """Rows of a smooth 2-parameter family lifted to `dim` features, near
    the flow's state (around 1, as the Burgers snapshots are)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1, 1, size=(n, 2))
    return 1 + np.tanh(z @ rng.normal(size=(2, dim)))


def flax_ae(dtype, dim=DIM, latent=LATENT, seed=1):
    module, params = jae.init_autoencoder(dim, latent,
                                          key=jax.random.PRNGKey(seed))
    return module, jax.tree_util.tree_map(lambda x: x.astype(dtype), params)


def flat_flax(params):
    """A Flax Autoencoder's parameters in the port's flat order."""
    parts = []
    for part in ("encoder", "decoder"):
        dense = params["params"][part]
        for i in range(len(dense)):
            parts += [np.asarray(dense[f"Dense_{i}"]["kernel"]).T.ravel(),
                      np.asarray(dense[f"Dense_{i}"]["bias"])]
    return np.concatenate(parts)


# (network dtype, standardisation and state dtype): the float64 network,
# the runner's load path and its retrain path
PATHS = {"float64": ("float64", "float64"), "load": ("float32", "float64"),
         "retrain": ("float32", "float32")}


@pytest.mark.parametrize("path", list(PATHS))
def test_carried_network_matches_flax(path):
    net_dt, state_dt = PATHS[path]
    tol = NET_TOL[net_dt]
    x = snapshots().astype(state_dt)
    mu, sig = x.mean(axis=0), x.std(axis=0) + 1e-10
    module, params = flax_ae(net_dt)
    want = jae.ScaledAE(module, params, jnp.asarray(mu), jnp.asarray(sig))
    got = convert.ae_from_flax(params, mu, sig, device="cpu")
    assert got.net_dtype == getattr(torch, net_dt)
    assert got.module.encoder.layers[0].weight.shape == (512, DIM)
    w = x[3]
    for name in ("forward", "encode"):
        a = getattr(got, name)(to_torch(w))
        b = getattr(want, name)(jnp.asarray(w))
        assert str(a.dtype)[6:] == str(b.dtype) == state_dt
        assert rel(a, b) <= tol, name
    z = np.asarray(want.encode(jnp.asarray(w)))
    a, b = got.decode(to_torch(z)), want.decode(jnp.asarray(z))
    assert str(a.dtype)[6:] == str(b.dtype) and rel(a, b) <= tol
    # a batch of columns, as the runner decodes red_coords
    zs = np.asarray(jax.vmap(want.encode)(jnp.asarray(x[:7]))).T
    batch = got.decode(to_torch(zs))
    assert batch.shape == (DIM, 7)
    assert rel(batch, jax.vmap(want.decode, in_axes=1, out_axes=1)(
        jnp.asarray(zs))) <= tol
    assert rel(got.encode(to_torch(x[:7].T)), zs) <= tol
    assert rel(got.forward(to_torch(x[:7].T)), jax.vmap(want.forward)(
        jnp.asarray(x[:7])).T) <= tol
    decode, dec_jac, encode = tae.ae_decoder_fns(got)
    jdec, jjac, _ = jae.ae_decoder_fns(want)
    jac = dec_jac(to_torch(z))
    assert jac.shape == (DIM, LATENT) and str(jac.dtype)[6:] == state_dt
    assert rel(jac, jjac(jnp.asarray(z))) <= tol
    assert rel(decode(to_torch(z)), jdec(jnp.asarray(z))) <= tol
    assert torch.equal(encode(to_torch(w)), got.encode(to_torch(w)))


def test_init_distribution():
    """Flax's lecun_normal through closures/ann.flax_init_: zero biases,
    kernels inside +-2 std, the sample std that of the truncated normal,
    sqrt(1 / fan_in), within 5% on the layers of >= 8,000 weights;
    float32 parameters that a float64 input does not change."""
    net = tae.init_autoencoder(40, 10, generator=torch.Generator()
                               .manual_seed(5), device="cpu")
    _, fparams = jae.init_autoencoder(40, 10, key=jax.random.PRNGKey(5))
    layers = [*net.encoder.layers, *net.decoder.layers]
    assert [la.out_features for la in layers] == \
        [512, 256, 128, 64, 10, 64, 128, 256, 512, 40]
    flax_kernels = [fparams["params"][part][f"Dense_{i}"]["kernel"]
                    for part in ("encoder", "decoder") for i in range(5)]
    for layer, flax_w in zip(layers, flax_kernels):
        std = math.sqrt(1.0 / layer.in_features) / tann.TRUNC_STD
        w = layer.weight.detach()
        assert torch.all(layer.bias == 0)
        assert float(w.abs().max()) <= 2 * std
        assert np.shape(flax_w) == tuple(w.T.shape)
        if w.numel() >= 8000:
            for sample in (float(w.std()), float(np.std(flax_w))):
                assert abs(sample * math.sqrt(layer.in_features) - 1) <= 0.05
    default = tae.init_autoencoder(40, 10, device="cpu")
    zero = tae.init_autoencoder(40, 10, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    for a, b in zip(default.parameters(), zero.parameters()):
        assert torch.equal(a, b)
    x = torch.ones(40, dtype=torch.float64)
    out = net(x)
    assert out.dtype == torch.float64
    assert all(p.dtype == torch.float32 for p in net.parameters())
    # a float64 input runs the float32 parameters in float64, as Flax does
    module = jae.Autoencoder(input_dim=40, latent_dim=10)
    want = module.apply(fparams, jnp.ones(40, jnp.float64))
    got = convert.ae_from_flax(fparams, np.zeros(40), np.ones(40),
                               device="cpu").module(x)
    assert str(want.dtype) == "float64" and rel(got, want) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_train_epoch_matches_jax(dtype):
    tol = EPOCH_TOL[dtype]
    x = snapshots(n=100).astype(dtype)
    mu, sig = x.mean(axis=0), x.std(axis=0) + 1e-10
    module, params = flax_ae(dtype)
    bs, lr = 16, 1e-3
    opt = optax.adam(lr)
    key = jax.random.PRNGKey(5)
    want_p, _, want_loss = jtrain._train_epoch(
        module, opt, params, opt.init(params), jnp.asarray(x),
        jnp.asarray(mu), jnp.asarray(sig), key, bs)
    nb = x.shape[0] // bs
    perm = np.asarray(jax.random.permutation(key, x.shape[0]))[:nb * bs]
    ae = convert.ae_from_flax(params, mu, sig, device="cpu")
    _, got_loss = ttrain._train_epoch(
        ae.module, minibatch.adam_init_flat(ae.module), to_torch(x),
        ae.mu_in, ae.sig_in, torch.as_tensor(perm.copy()), bs, lr)
    assert rel(minibatch.flat_params(ae.module)[0], flat_flax(want_p)) \
        <= tol
    assert abs(float(got_loss) / float(want_loss) - 1) <= tol
    got_val = ttrain._eval_loss(ae.module, to_torch(x), ae.mu_in, ae.sig_in)
    want_val = jtrain._eval_loss(module, want_p, jnp.asarray(x),
                                 jnp.asarray(mu), jnp.asarray(sig))
    assert abs(float(got_val) / float(want_val) - 1) <= tol


def test_split_and_standardisation_match_jax(monkeypatch, tmp_path):
    """Both trainers see the same training and validation rows and the
    same float32 standardisation: each trainer's epoch and evaluation are
    replaced by recorders for one epoch, on rows whose first column is
    the row number."""
    x = snapshots(n=50)
    x[:, 0] = np.arange(50)
    seen = {}

    def jax_epoch(module, opt, params, opt_state, xt, mu, sig, key, bs):
        seen["jax_train"] = np.asarray(xt[:, 0])
        return params, opt_state, jnp.asarray(1.0)

    def jax_eval(module, params, xv, mu, sig):
        seen["jax_val"] = np.asarray(xv[:, 0])
        return jnp.asarray(1.0)

    def port_epoch(loss_fn, module, state, data, perm, bs, lr):
        seen["port_train"] = data[0][:, 0].numpy()
        return state, torch.tensor(1.0)

    def port_eval(module, xv, mu, sig):
        seen["port_val"] = xv[:, 0].numpy()
        return torch.tensor(1.0)

    monkeypatch.setattr(jtrain, "_train_epoch", jax_epoch)
    monkeypatch.setattr(jtrain, "_eval_loss", jax_eval)
    monkeypatch.setattr(ttrain, "train_epoch", port_epoch)
    monkeypatch.setattr(ttrain, "_eval_loss", port_eval)
    want, _ = jtrain.train_autoencoder(
        x, 2, epochs=1, seed=17, model_path=str(tmp_path / "j.msgpack"))
    got, _ = ttrain.train_autoencoder(
        x, 2, epochs=1, seed=17, model_path=str(tmp_path / "t.pt"),
        device="cpu")
    assert seen["port_train"].size == 45 and seen["port_val"].size == 5
    np.testing.assert_array_equal(seen["port_train"], seen["jax_train"])
    np.testing.assert_array_equal(seen["port_val"], seen["jax_val"])
    for a, b in ((got.mu_in, want.mu_in), (got.sig_in, want.sig_in)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got.net_dtype == torch.float32


def test_train_autoencoder_reconstructs(tmp_path, capsys):
    """tests/test_training.py's TestAETraining through the port: error
    under 0.1 on the first 30 rows; the module holds the best checkpoint,
    whose sidecar has JAX's keys."""
    rng = np.random.default_rng(1)
    z = rng.uniform(-1, 1, size=(300, 2))
    lift = rng.normal(size=(2, 30))
    x = np.tanh(z @ lift) * 3 + 1
    path = str(tmp_path / "ae.pt")
    ae, mon = ttrain.train_autoencoder(
        x, latent_dim=2, epochs=200, lr=3e-3, patience=60, model_path=path,
        verbose=True, device="cpu")
    recon = ae.forward(to_torch(x[:30].T, dtype=torch.float32)).T.numpy()
    err = np.linalg.norm(recon - x[:30]) / np.linalg.norm(x[:30])
    assert err < 0.1
    best = torch.load(path, weights_only=True)
    for name, p in ae.module.state_dict().items():
        assert torch.equal(p, best[name])
    with open(path + ".json") as f:
        side = json.load(f)
    assert list(side) == ["epoch", "best_crit", "train_losses",
                          "test_crits"]
    assert mon.best_crit == min(mon.test_crits) == side["best_crit"]
    out = capsys.readouterr().out
    assert "  epoch 0: train " in out and "s/epoch" in out


def test_checkpoint_round_trip(tmp_path):
    """A saved autoencoder loads back into a fresh template bit for bit,
    in its own dtype, and its sidecar matches JAX's monitor's on the same
    losses."""
    from finitedifference_tpu.training import monitor as jmon

    path = str(tmp_path / "ae.pt")
    net = tae.init_autoencoder(DIM, LATENT, generator=torch.Generator()
                               .manual_seed(3), device="cpu")
    tm = tmon.TrainingMonitor(path, 2)
    jm = jmon.TrainingMonitor(str(tmp_path / "ae.msgpack"), 2)
    for train, val in ((1.0, 0.5), (0.9, 0.7), (0.8, 0.4)):
        assert tm.check_for_completion(train, val, net) == \
            jm.check_for_completion(train, val, {"w": jnp.ones(2)})
    back = tmon.load_checkpoint(path, tae.init_autoencoder(DIM, LATENT,
                                                           device="cpu"))
    for a, b in zip(net.parameters(), back.parameters()):
        assert b.dtype == torch.float32 and torch.equal(a, b)
    with open(path + ".json") as f, \
            open(str(tmp_path / "ae.msgpack") + ".json") as g:
        assert json.load(f) == json.load(g)


def test_training_data_matches_jax(tmp_path):
    """get_snapshot_params, random_split and load_training_data (with and
    without the reference subtracted) against JAX's on a snapshot cache
    the JAX package wrote (12^2, 6 steps): bit for bit."""
    import dataclasses

    from finitedifference_tpu.config import BurgersConfig as JConfig
    from finitedifference_tpu.grid import grid_from_config as jgrid_of
    from finitedifference_tpu_torch.config import BurgersConfig
    from finitedifference_tpu_torch.grid import grid_from_config

    folder = str(tmp_path / "param_snaps_12x12")
    jcfg = dataclasses.replace(JConfig().with_cells(12), num_steps=6)
    cfg = dataclasses.replace(BurgersConfig().with_cells(12), num_steps=6)
    w0 = np.ones(2 * 144)
    want, want_ref = jdata.load_training_data(jcfg, jgrid_of(jcfg), w0,
                                              snap_folder=folder)
    assert len(os.listdir(folder)) == 9
    got, got_ref = tdata.load_training_data(
        cfg, grid_from_config(cfg), torch.ones(2 * 144, dtype=torch.float64),
        snap_folder=folder)
    assert got.shape == (9 * 6, 2 * 144)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_ref, want_ref)
    raw, _ = tdata.load_training_data(cfg, grid_from_config(cfg), w0,
                                      subtract_ref=False, snap_folder=folder)
    np.testing.assert_array_equal(raw, jdata.load_training_data(
        jcfg, jgrid_of(jcfg), w0, subtract_ref=False, snap_folder=folder)[0])
    assert [list(m) for m in tdata.get_snapshot_params(cfg)] == \
        [list(m) for m in jdata.get_snapshot_params(jcfg)]
    for frac in (0.75, 0.9):
        a = tdata.random_split(raw, frac, np.random.default_rng(3))
        b = jdata.random_split(raw, frac, np.random.default_rng(3))
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
