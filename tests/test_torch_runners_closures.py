"""The port's POD-RBF runners on the CPU beside the JAX runners, each side
in its own working directory, at 12^2, 8 steps and 3 + 5 modes.

The port's directory starts from the JAX-written basis_12x12.npy and
param_snaps_12x12/ cache, so the comparison is of the closure path
itself: the rSVD generators do not matter, and neither does the FOMs'
last-digit rounding (the FOMs agree to 1e-12, tests/test_torch_runners.py),
which the kernel fits would otherwise amplify by their condition number.
- run_pod_rbf_global, run_pod_rbf_hprom --compute-ecsw (global, and kNN
  at epsilon 3) and run_pod_rbf (kNN) at epsilon 3: equal Gauss-Newton
  totals, equal N_e, weights to 1e-10 (the kNN variant's up to a
  near-tie between two cells of one grid column), errors to 1e-6
  percentage points, saved trajectories to 1e-10 (relative).
- run_pod_rbf at the reference's epsilon 0.01, k = 100 (all 81 pairs at
  this size): the local kernel system has a condition number near 1e10,
  where any two Cholesky implementations differ by ~1e-7 in the local
  weights (JAX's against SciPy's too); the trajectories agree to 1e-9
  (measured 3e-10), the errors to 1e-6 points, the GN totals exactly.
- The port reads the JAX model file and weights and gets JAX's numbers.
- A new runner asked for the card where there is none fails at once;
  the other searches (cv, bayesian, aniso, svr), once not ported, run
  (tests/test_torch_rbf_searches.py holds them to JAX's), and an unknown
  one raises ValueError.
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

from finitedifference_tpu_torch.runners import run_pod_rbf as trun_knn
from finitedifference_tpu_torch.runners import run_pod_rbf_global as trun_g
from finitedifference_tpu_torch.runners import run_pod_rbf_hprom as trun_h

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "runners"))
import run_pod_rbf as jrun_knn  # noqa: E402
import run_pod_rbf_global as jrun_g  # noqa: E402
import run_pod_rbf_hprom as jrun_h  # noqa: E402

MU = (5.19, 0.026)
SMALL = dict(num_cells=12, num_steps=8, num_primary=3, num_secondary=5)
KNN_EPS = 3.0        # the local systems' condition number stays small
BASIS = "basis_12x12.npy"
SNAPS = "param_snaps_12x12"
MODEL = "pod_rbf_global_model_p3_12x12.npz"
WEIGHTS = {"global": "ecsw_weights_rbf_global_nnls_12x12.npy",
           "knn": "ecsw_weights_rbf_knn_nnls_12x12.npy"}


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
    """main(**kw) with its stdout kept: (err %, GN total, N_e or None,
    the saved trajectory, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, err = main(*MU, **SMALL, **kw)
    out = buf.getvalue()
    gn = int(re.findall(r"Total GN iterations: (\d+)", out)[-1])
    n_e = re.findall(r"N_e = (\d+)", out)
    saved = re.findall(r"Snapshot saved as (\S+)", out)[-1]
    return dict(err=err, gn=gn, n_e=int(n_e[-1]) if n_e else None,
                traj=np.load(saved), out=out)


def workflow(extra_kw):
    return {
        "global": lambda: run(extra_kw["global"]),
        "hprom_global": lambda: run(extra_kw["hprom"], compute_ecsw=True),
        "hprom_knn": lambda: run(extra_kw["hprom"], variant="knn",
                                 epsilon=KNN_EPS, compute_ecsw=True),
        "knn": lambda: run(extra_kw["knn"], epsilon=KNN_EPS),
        "knn_ref": lambda: run(extra_kw["knn"]),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runners in one directory, then the port's in another that
    starts from the JAX basis and snapshot cache: {side: (dir, results)}."""
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("torch")
    cpu = dict(device="cpu")
    jax_mains = {"global": jrun_g.main, "hprom": jrun_h.main,
                 "knn": jrun_knn.main}
    port_mains = {name: (lambda m: lambda *a, **kw: m(*a, **kw, **cpu))(m)
                  for name, m in (("global", trun_g.main),
                                  ("hprom", trun_h.main),
                                  ("knn", trun_knn.main))}
    j, t = {}, {}
    old = os.getcwd()
    try:
        os.chdir(jdir)
        for name, fn in workflow(jax_mains).items():
            j[name] = fn()
        shutil.copy(jdir / BASIS, tdir / BASIS)
        shutil.copytree(jdir / SNAPS, tdir / SNAPS)
        os.chdir(tdir)
        for name, fn in workflow(port_mains).items():
            t[name] = fn()
    finally:
        os.chdir(old)
    return {"jax": (jdir, j), "torch": (tdir, t)}


@pytest.mark.parametrize("name", ["global", "hprom_global", "hprom_knn",
                                  "knn"])
def test_runner_matches_jax(runs, name):
    (jdir, j), (tdir, t) = runs["jax"], runs["torch"]
    assert t[name]["gn"] == j[name]["gn"] > SMALL["num_steps"] - 1
    assert abs(t[name]["err"] - j[name]["err"]) <= 1e-6
    assert t[name]["traj"].shape == (2 * 144, 9)
    assert rel(t[name]["traj"], j[name]["traj"]) <= 1e-10
    if name == "hprom_global":
        w_j = np.load(jdir / WEIGHTS["global"])
        w_t = np.load(tdir / WEIGHTS["global"])
        assert t[name]["n_e"] == j[name]["n_e"] == int((w_j > 0).sum())
        assert rel(w_t, w_j) <= 1e-10


def test_knn_hprom_weights_match_jax_up_to_ties(runs):
    """The kNN closure's training matrix has cells one row apart in the
    same grid column whose columns agree to ~1e-10 (the flow is nearly
    uniform in y away from the bottom wall), and the greedy NNLS takes the
    first of such a near-tie by rounding (say cell 85 in one package and
    cell 97, a row above, in the other). So: equal N_e, the same weight
    values, and supports that differ only within grid columns."""
    (jdir, j), (tdir, t) = runs["jax"], runs["torch"]
    w_j = np.load(jdir / WEIGHTS["knn"])
    w_t = np.load(tdir / WEIGHTS["knn"])
    assert t["hprom_knn"]["n_e"] == j["hprom_knn"]["n_e"] \
        == int((w_j > 0).sum()) == int((w_t > 0).sum())
    np.testing.assert_allclose(np.sort(w_t[w_t > 0]), np.sort(w_j[w_j > 0]),
                               rtol=1e-10)
    nx = 12
    assert sorted(np.flatnonzero(w_t) % nx) == \
        sorted(np.flatnonzero(w_j) % nx)


def test_knn_runner_at_the_reference_epsilon(runs):
    """eps = 0.01, k = 100: the condition number of the local system
    bounds the agreement (module docstring)."""
    j, t = runs["jax"][1]["knn_ref"], runs["torch"][1]["knn_ref"]
    assert t["gn"] == j["gn"]
    assert abs(t["err"] - j["err"]) <= 1e-6
    assert rel(t["traj"], j["traj"]) <= 1e-9


def test_global_model_file_matches_jax(runs):
    """The grid search chose the same (kernel, epsilon) on the same scaled
    pairs; the weights themselves come out of an SVD at a condition number
    near 1e8 and agree to 1e-6."""
    (jdir, _), (tdir, t) = runs["jax"], runs["torch"]
    zj, zt = np.load(jdir / MODEL), np.load(tdir / MODEL)
    assert sorted(zt.files) == sorted(zj.files)
    assert str(zt["kernel"]) == str(zj["kernel"])
    assert float(zt["epsilon"]) == float(zj["epsilon"])
    for key in ("q_p_train", "scaler_scale", "scaler_min"):
        np.testing.assert_allclose(zt[key], zj[key], rtol=1e-12, atol=1e-14)
    assert rel(zt["w_global"], zj["w_global"]) <= 1e-6
    assert "grid-search fit time" in t["global"]["out"]


def test_port_reads_jax_model_and_weights(runs, tmp_path, monkeypatch):
    """A directory holding what the JAX runners wrote (basis, snapshots,
    model, weights): the port loads the model and weights and reproduces
    JAX's trajectories."""
    jdir, j = runs["jax"]
    for name in (BASIS, MODEL, WEIGHTS["global"]):
        shutil.copy(jdir / name, tmp_path / name)
    shutil.copytree(jdir / SNAPS, tmp_path / SNAPS)
    monkeypatch.chdir(tmp_path)
    got = run(lambda *a, **kw: trun_g.main(*a, **kw, device="cpu"))
    assert "grid-search" not in got["out"]       # loaded, not trained
    assert got["gn"] == j["global"]["gn"]
    assert rel(got["traj"], j["global"]["traj"]) <= 1e-12
    got = run(lambda *a, **kw: trun_h.main(*a, **kw, device="cpu"))
    assert "weight solve" not in got["out"]      # the JAX weights, loaded
    assert got["n_e"] == j["hprom_global"]["n_e"]
    assert got["gn"] == j["hprom_global"]["gn"]
    assert abs(got["err"] - j["hprom_global"]["err"]) <= 1e-10
    assert rel(got["traj"], j["hprom_global"]["traj"]) <= 1e-12


@pytest.mark.parametrize("runner", ["run_pod_rbf_global",
                                    "run_pod_rbf_hprom", "run_pod_rbf"])
def test_runner_without_card_fails_at_once(runner, tmp_path, monkeypatch):
    """Without device="cpu" a runner asks for the card and, where there is
    none, raises before it computes or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    main = {"run_pod_rbf_global": trun_g, "run_pod_rbf_hprom": trun_h,
            "run_pod_rbf": trun_knn}[runner].main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(num_cells=12, num_steps=8)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("search", ["cv", "bayesian", "aniso", "svr"])
def test_other_searches_not_ported(search, tmp_path, monkeypatch):
    """The searches this test once found unported now run through the
    runner from an empty directory: a finite error, the search's own model
    file (none for svr, which trains on every run), nothing raised; an
    unknown search still raises ValueError."""
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        _, err = trun_g.main(num_cells=12, num_steps=8, search=search,
                             device="cpu")
    assert np.isfinite(err)
    stem = f"pod_rbf_global_model_{search}_12x12.npz"
    assert os.path.exists(tmp_path / stem) == (search != "svr")
    with pytest.raises(ValueError, match="unknown search"):
        trun_g.main(num_cells=12, num_steps=8, search="grid2",
                    device="cpu")


def test_split_training_matches_jax(runs, tmp_path, monkeypatch):
    """The projected pairs from the 9 cached trajectories, strided to at
    most max_pairs, and from a qcoords directory (test_* files skipped):
    the same arrays in both packages."""
    import common as jcommon

    from finitedifference_tpu_torch.runners import common as tcommon

    (jdir, _), (tdir, _) = runs["jax"], runs["torch"]
    cfg_j, cfg_t = jcommon.default_config(12, 8), tcommon.default_config(12, 8)
    (grid_j, w0), (grid_t, _) = jcommon.make_problem(cfg_j), \
        tcommon.make_problem(cfg_t)
    qdir = tmp_path / "qcoords"
    qdir.mkdir()
    rng = np.random.default_rng(6)
    for name in ("a.npz", "b.npz", "test_c.npz"):
        np.savez(qdir / name, q=rng.normal(size=(9, 10)))
    for kw in (dict(max_pairs=20), dict(max_pairs=7, qcoords_dir=str(qdir)),
               dict(num_secondary=None)):
        monkeypatch.chdir(jdir)
        want = jcommon.split_training(cfg_j, grid_j, w0, 8, 3, **kw)
        monkeypatch.chdir(tdir)
        got = tcommon.split_training(cfg_t, grid_t, w0, 8, 3, **kw,
                                     device="cpu")
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert got[3].shape == (81, 5)


def test_knn_hprom_at_the_reference_epsilon_matches_jax(tmp_path,
                                                        monkeypatch):
    """run_pod_rbf_hprom --variant knn --compute-ecsw at the reference's
    eps 0.01, k 100, at 12^2 and 40 steps (369 training pairs, so the 100
    neighbours are a true subset), the port's directory starting from the
    JAX basis and cache: the same N_e and Gauss-Newton total, weights to
    1e-6 (measured 1e-7: the local systems' condition number is near
    1e10) and trajectories to 1e-8 (measured 2e-9). At 250^2 the same
    runner's error moves with the rounding of its inputs (PERF.md §7)."""
    kw = dict(num_cells=12, num_steps=40, num_primary=3, num_secondary=5,
              variant="knn", compute_ecsw=True)
    weights = "ecsw_weights_rbf_knn_nnls_12x12.npy"
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    monkeypatch.chdir(jdir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, err_j = jrun_h.main(*MU, **kw)
    out_j = buf.getvalue()
    tdir.mkdir()
    shutil.copy(jdir / BASIS, tdir / BASIS)
    shutil.copytree(jdir / SNAPS, tdir / SNAPS)
    monkeypatch.chdir(tdir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, err_t = trun_h.main(*MU, **kw, device="cpu")
    out_t = buf.getvalue()
    for pattern in (r"N_e = (\d+)", r"Total GN iterations: (\d+)"):
        assert re.findall(pattern, out_t) == re.findall(pattern, out_j)
    assert abs(err_t - err_j) <= 1e-6
    assert rel(np.load(tdir / weights), np.load(jdir / weights)) <= 1e-6
    saved = "pod_rbf_hprom_knn_snaps_mu1_5.19_mu2_0.026.npy"
    assert rel(np.load(tdir / saved), np.load(jdir / saved)) <= 1e-8
