"""The port's RNM runners on the CPU beside the JAX runners, each side in its
own working directory, at 12^2, 8 steps and 3 + 5 modes.

The JAX run_rnm trains a network first (30 epochs) and that one network
drives both packages: written as JAX's .msgpack with flax.serialization
and as the port's .pt through convert.rnm_from_flax and the port's
TrainingMonitor, each directory starting from the JAX basis and snapshot
cache. run_rnm (no retrain) and run_hrnm --compute-ecsw then run on each
side:
- the network cast to float64: equal Gauss-Newton totals and N_e,
  weights, saved trajectories and errors to 1e-10 (relative for the
  arrays, percentage points for the errors; measured 2e-13 and below);
- the float32 network the runners train: the closure sums in float32,
  XLA's and PyTorch's GEMMs in different orders, so the trajectories
  agree to 3e-7 (relative; measured 7e-8), the errors to 2e-6 points
  (6.5e-7), the NNLS weights to 5e-5 (1.4e-5: the training matrix
  carries the closure's rounding), and the GN totals and N_e exactly.
The port's run_rnm also trains its own network (30 epochs) to a finite
error, and each runner asked for the card where there is none fails at
once.
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

from finitedifference_tpu.closures.ann import init_rnm as jinit
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.runners import run_hrnm as trun_h
from finitedifference_tpu_torch.runners import run_rnm as trun_r
from finitedifference_tpu_torch.training.monitor import TrainingMonitor

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "runners"))
import run_hrnm as jrun_h  # noqa: E402
import run_rnm as jrun_r  # noqa: E402

MU = (5.19, 0.026)
SMALL = dict(num_cells=12, num_steps=8, num_primary=3, num_secondary=5)
BASIS = "basis_12x12.npy"
SNAPS = "param_snaps_12x12"
JMODEL = "rnm_model_12x12.msgpack"
TMODEL = "rnm_model_12x12.pt"
WEIGHTS = "ecsw_weights_rnm_nnls_12x12.npy"
# (trajectory rel, error points, weights rel) per network dtype
TOL = {"float64": (1e-10, 1e-10, 1e-10), "float32": (3e-7, 2e-6, 5e-5)}


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
    N_e or None, the saved trajectory, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, err = main(*MU, **SMALL, **kw)
    out = buf.getvalue()
    gn = int(re.findall(r"Total GN iterations: (\d+)", out)[-1])
    n_e = re.findall(r"N_e = (\d+)", out)
    saved = re.findall(r"Snapshot saved as (\S+)", out)[-1]
    return dict(err=err, gn=gn, n_e=int(n_e[-1]) if n_e else None,
                traj=np.load(saved), out=out)


def seed_dir(src, dst):
    dst.mkdir()
    shutil.copy(src / BASIS, dst / BASIS)
    shutil.copytree(src / SNAPS, dst / SNAPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{dtype: {side: (dir, {"rnm": ..., "hrnm": ...})}} plus the JAX
    training run and the port's own."""
    root = tmp_path_factory.mktemp("rnm")
    train = root / "jax_train"
    train.mkdir()
    cpu = dict(device="cpu")
    out = {}
    old = os.getcwd()
    try:
        os.chdir(train)
        out["jax_train"] = run(jrun_r.main, retrain=True, epochs=30)
        _, template = jinit(3, 5)
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
                convert.rnm_from_flax(p, device="cpu"))
            os.chdir(jdir)
            j = {"rnm": run(jrun_r.main),
                 "hrnm": run(jrun_h.main, compute_ecsw=True)}
            os.chdir(tdir)
            t = {"rnm": run(trun_r.main, **cpu),
                 "hrnm": run(trun_h.main, compute_ecsw=True, **cpu)}
            out[dtype] = {"jax": (jdir, j), "torch": (tdir, t)}
        own = root / "torch_train"
        seed_dir(train, own)
        os.chdir(own)
        out["torch_train"] = run(trun_r.main, retrain=True, epochs=30,
                                 **cpu)
        for key, side, name in (("torch_train", own, TMODEL),
                                ("jax_train", train, JMODEL)):
            with open(side / f"{name}.json") as f:
                out[key]["sidecar"] = json.load(f)
            out[key]["model_saved"] = (side / name).exists()
    finally:
        os.chdir(old)
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["rnm", "hrnm"])
def test_runner_matches_jax(runs, dtype, name):
    traj_tol, err_tol, w_tol = TOL[dtype]
    (jdir, j), (tdir, t) = runs[dtype]["jax"], runs[dtype]["torch"]
    assert "rnm fit time" not in t[name]["out"]     # loaded, not trained
    assert t[name]["gn"] == j[name]["gn"] > SMALL["num_steps"] - 1
    assert abs(t[name]["err"] - j[name]["err"]) <= err_tol
    assert t[name]["traj"].shape == (2 * 144, 9)
    assert rel(t[name]["traj"], j[name]["traj"]) <= traj_tol
    if name == "hrnm":
        w_j, w_t = np.load(jdir / WEIGHTS), np.load(tdir / WEIGHTS)
        assert t[name]["n_e"] == j[name]["n_e"] == int((w_j > 0).sum())
        assert rel(w_t, w_j) <= w_tol


def test_runner_trains_its_own_network(runs):
    """run_rnm --retrain --epochs 30 in the port: a finite error, the
    trainer's lines, the model file and its sidecar with JAX's keys."""
    got, jax_run = runs["torch_train"], runs["jax_train"]
    assert np.isfinite(got["err"]) and np.isfinite(jax_run["err"])
    assert "rnm fit time" in got["out"] and "  epoch 0: train" in got["out"]
    assert got["model_saved"] and jax_run["model_saved"]
    assert list(got["sidecar"]) == list(jax_run["sidecar"])
    assert 1 <= got["sidecar"]["epoch"] <= 30


@pytest.mark.parametrize("runner", ["run_rnm", "run_hrnm"])
def test_runner_without_card_fails_at_once(runner, tmp_path, monkeypatch):
    """Without device="cpu" a runner asks for the card and, where there is
    none, raises before it computes or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    main = {"run_rnm": trun_r, "run_hrnm": trun_h}[runner].main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(num_cells=12, num_steps=8)
    assert os.listdir(tmp_path) == []
