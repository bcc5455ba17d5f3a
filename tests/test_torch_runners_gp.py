"""The port's POD-GP HPROM runner (run_pod_gp_hprom) on the CPU beside the
JAX runner, at 12^2, 8 steps and 3 + 5 modes (81 training pairs).

The port's directory starts from the JAX-written basis_12x12.npy and
param_snaps_12x12/ cache, so the comparison is of the GP path itself.
Each side runs --compute-ecsw with the shared-kernel GP (per_mode none),
then --retrain --per-mode full --compute-ecsw:
- the model file: the same keys, the same scaled training inputs and
  scaler, hyperparameters to 1e-8 relative (300 Adam steps; measured
  3e-10);
- the weight file: the same N_e and weights to 1e-10 relative (NNLS on a
  training matrix built through the fitted closure; measured 4e-13);
- equal Gauss-Newton totals, errors to 1e-6 percentage points, saved
  trajectories to 1e-10 relative (measured 1e-13).
Then each package runs on the other's pod_gp_model.npz and weights and
reproduces the writer's trajectory to 1e-10. Without a card and without
device="cpu" the runner fails at once.
"""

import contextlib
import io
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch.runners import run_pod_gp_hprom as trun

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "runners"))
import run_pod_gp_hprom as jrun  # noqa: E402
import run_pod_rbf_global as jrun_global  # noqa: E402

MU = (5.19, 0.026)
SMALL = dict(num_cells=12, num_steps=8, num_primary=3, num_secondary=5)
BASIS = "basis_12x12.npy"
SNAPS = "param_snaps_12x12"
MODEL = "pod_gp_model_12x12.npz"
WEIGHTS = "ecsw_weights_gp_nnls_12x12.npy"
RUNS = {"none": dict(compute_ecsw=True),
        "full": dict(retrain=True, per_mode="full", compute_ecsw=True)}


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
    """main(**kw) with its stdout kept: the error, GN total, N_e, saved
    trajectory, and copies of the model and weight files."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, err = main(*MU, **SMALL, **kw)
    out = buf.getvalue()
    saved = re.findall(r"Snapshot saved as (\S+)", out)[-1]
    return dict(err=err, out=out, traj=np.load(saved),
                gn=int(re.findall(r"Total GN iterations: (\d+)", out)[-1]),
                n_e=int(re.findall(r"N_e = (\d+)", out)[-1]),
                model=dict(np.load(MODEL)), weights=np.load(WEIGHTS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{side: (dir, {per_mode: result})}: the JAX runner in one directory
    (after the global-RBF runner has built the basis and cache there),
    then the port's in another that starts from copies of them."""
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("torch")
    j, t = {}, {}
    old = os.getcwd()
    try:
        os.chdir(jdir)
        with contextlib.redirect_stdout(io.StringIO()):
            jrun_global.main(*MU, **SMALL)
        for name, kw in RUNS.items():
            j[name] = run(jrun.main, **kw)
        shutil.copy(jdir / BASIS, tdir / BASIS)
        shutil.copytree(jdir / SNAPS, tdir / SNAPS)
        os.chdir(tdir)
        for name, kw in RUNS.items():
            t[name] = run(trun.main, device="cpu", **kw)
    finally:
        os.chdir(old)
    return {"jax": (jdir, j), "torch": (tdir, t)}


@pytest.mark.parametrize("per_mode", ["none", "full"])
def test_gp_runner_matches_jax(runs, per_mode):
    j, t = runs["jax"][1][per_mode], runs["torch"][1][per_mode]
    zj, zt = j["model"], t["model"]
    assert sorted(zt) == sorted(zj)
    assert bool(zt["per_mode"]) == bool(zj["per_mode"]) \
        == (per_mode == "full")
    for key in ("x_train", "scaler_scale", "scaler_min"):
        np.testing.assert_allclose(zt[key], zj[key], rtol=1e-12, atol=1e-14)
    for key in ("amplitude", "length_scale"):
        assert zt[key].shape == zj[key].shape
        assert rel(zt[key], zj[key]) <= 1e-8
    assert float(zt["noise"]) == float(zj["noise"]) == 1e-6
    assert "gp fit time" in t["out"]
    assert t["n_e"] == j["n_e"] == int((j["weights"] > 0).sum())
    assert rel(t["weights"], j["weights"]) <= 1e-10
    assert t["gn"] == j["gn"] > SMALL["num_steps"] - 1
    assert abs(t["err"] - j["err"]) <= 1e-6
    assert t["traj"].shape == (2 * 144, 9)
    assert rel(t["traj"], j["traj"]) <= 1e-10


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_each_package_runs_the_others_model(runs, reader, tmp_path,
                                            monkeypatch):
    """The last model written (per_mode full) and its weights, read by the
    other package: the writer's trajectory to 1e-10, its N_e and GN total."""
    writer = "jax" if reader == "torch" else "torch"
    wdir, results = runs[writer]
    for name in (BASIS, MODEL, WEIGHTS):
        shutil.copy(wdir / name, tmp_path / name)
    shutil.copytree(wdir / SNAPS, tmp_path / SNAPS)
    monkeypatch.chdir(tmp_path)
    main = (lambda *a, **kw: trun.main(*a, **kw, device="cpu")) \
        if reader == "torch" else jrun.main
    got = run(main)
    assert "gp fit time" not in got["out"] and "gp:" not in got["out"]
    assert "weight solve" not in got["out"]
    want = results["full"]
    assert got["n_e"] == want["n_e"]
    assert got["gn"] == want["gn"]
    assert rel(got["traj"], want["traj"]) <= 1e-10


def test_gp_runner_without_card_fails_at_once(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(num_cells=12, num_steps=8)
    assert os.listdir(tmp_path) == []
