"""The port's AE-LSPG runner on the CPU beside the JAX runner, each side in
its own working directory, at 12^2, 8 steps and latent 3.

The JAX run_ae_prom trains an autoencoder first (20 epochs, its retrain
path) and that one network drives both packages: written as JAX's
.msgpack with flax.serialization and as the port's .pt through
convert.ae_from_flax and the port's TrainingMonitor, each directory
starting from the JAX snapshot cache. run_ae_prom (no retrain: the load
path, standardisation and state in float64) then runs on each side:
- the network cast to float64: equal Gauss-Newton totals, saved
  trajectories and errors to 1e-10 (relative for the trajectories,
  percentage points for the errors; measured 5e-17 and 4e-16);
- the float32 network JAX trained: the decoder sums in float32, XLA's
  and PyTorch's GEMMs in different orders, so the trajectories agree to
  3e-6 (relative; measured 7.2e-7), the errors to 2e-5 points (measured
  5.5e-6), and the GN totals exactly.
The port's run_ae_prom also trains its own network (20 epochs, the
retrain path): a float32 online state, a finite error, the model file and
a sidecar with JAX's keys. Asked for the card where there is none, it
fails at once.
"""

import contextlib
import io
import json
import os
import re
import shutil
import sys

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from finitedifference_tpu.closures.autoencoder import init_autoencoder
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.runners import run_ae_prom as trun
from finitedifference_tpu_torch.training.monitor import TrainingMonitor

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "runners"))
import run_ae_prom as jrun  # noqa: E402

MU = (5.19, 0.026)
SMALL = dict(num_cells=12, num_steps=8, latent_dim=3)
SNAPS = "param_snaps_12x12"
JMODEL = "ae_model_12x12.msgpack"
TMODEL = "ae_model_12x12.pt"
# (trajectory rel, error points) per network dtype
TOL = {"float64": (1e-10, 1e-10), "float32": (3e-6, 2e-5)}


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
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) \
        / np.linalg.norm(np.asarray(b))


def run(main, **kw):
    """main(*MU, **SMALL, **kw) with its stdout kept: (err %, GN total,
    the saved trajectory, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, err = main(*MU, **SMALL, **kw)
    out = buf.getvalue()
    gn = int(re.findall(r"Total GN iterations: (\d+)", out)[-1])
    saved = re.findall(r"Snapshot saved as (\S+)", out)[-1]
    return dict(err=err, gn=gn, traj=np.load(saved), out=out)


def seed_dir(src, dst):
    dst.mkdir()
    shutil.copytree(src / SNAPS, dst / SNAPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{dtype: {side: run}} on the JAX-trained network, plus the JAX
    training run and the port's own."""
    root = tmp_path_factory.mktemp("ae")
    train = root / "jax_train"
    train.mkdir()
    out = {}
    old = os.getcwd()
    try:
        os.chdir(train)
        out["jax_train"] = run(jrun.main, retrain=True, epochs=20)
        # the runner's template: Flax's float32 parameters
        _, template = init_autoencoder(2 * 144, SMALL["latent_dim"])
        with open(train / JMODEL, "rb") as f:
            params = flax.serialization.from_bytes(template, f.read())
        for dtype in ("float64", "float32"):
            p = jax.tree_util.tree_map(lambda x: np.asarray(x, dtype),
                                       params)
            jdir, tdir = root / f"jax_{dtype}", root / f"torch_{dtype}"
            seed_dir(train, jdir)
            seed_dir(train, tdir)
            with open(jdir / JMODEL, "wb") as f:
                f.write(flax.serialization.to_bytes(p))
            TrainingMonitor(str(tdir / TMODEL), 1).save_checkpoint(
                convert.ae_from_flax(p, np.zeros(1), np.ones(1),
                                     device="cpu").module)
            os.chdir(jdir)
            j = run(jrun.main)
            os.chdir(tdir)
            t = run(trun.main, device="cpu")
            out[dtype] = {"jax": j, "torch": t}
        own = root / "torch_train"
        seed_dir(train, own)
        os.chdir(own)
        out["torch_train"] = run(trun.main, retrain=True, epochs=20,
                                 device="cpu")
        for key, side, name in (("torch_train", own, TMODEL),
                                ("jax_train", train, JMODEL)):
            with open(side / f"{name}.json") as f:
                out[key]["sidecar"] = json.load(f)
            out[key]["model_saved"] = (side / name).exists()
    finally:
        os.chdir(old)
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_load_path_matches_jax(runs, dtype):
    traj_tol, err_tol = TOL[dtype]
    j, t = runs[dtype]["jax"], runs[dtype]["torch"]
    assert "ae fit time" not in t["out"]            # loaded, not trained
    assert "online state: torch.float64" in t["out"]
    assert t["gn"] == j["gn"] >= SMALL["num_steps"]
    assert abs(t["err"] - j["err"]) <= err_tol
    assert t["traj"].shape == j["traj"].shape == (2 * 144, 9)
    assert t["traj"].dtype == j["traj"].dtype == np.float64
    assert rel(t["traj"], j["traj"]) <= traj_tol


def test_retrain_path_steps_a_float32_state(runs):
    """run_ae_prom --retrain --epochs 20 in the port: the trainer's lines,
    a float32 online state and trajectory (JAX's retrain path), a finite
    error, the model file and its sidecar with JAX's keys."""
    got, jax_run = runs["torch_train"], runs["jax_train"]
    assert "ae fit time" in got["out"] and "  epoch 0: train" in got["out"]
    assert "online state: torch.float32" in got["out"]
    assert got["traj"].dtype == jax_run["traj"].dtype == np.float32
    assert np.isfinite(got["err"]) and np.isfinite(jax_run["err"])
    assert got["gn"] >= SMALL["num_steps"]
    assert got["model_saved"] and jax_run["model_saved"]
    assert list(got["sidecar"]) == list(jax_run["sidecar"])
    assert 1 <= got["sidecar"]["epoch"] <= 20


def test_runner_without_card_fails_at_once(tmp_path, monkeypatch):
    """Without device="cpu" the runner asks for the card and, where there
    is none, raises before it computes or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(num_cells=12, num_steps=8)
    assert os.listdir(tmp_path) == []
