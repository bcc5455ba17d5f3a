"""The port's other global-RBF searches (finitedifference_tpu_torch.training
.rbf_train: cv, bayesian, aniso, svr) against the JAX package's, on the
CPU, float64, and through run_pod_rbf_global --search at 12^2.

- train_global_rbf_cv: the same folds, the same chosen (epsilon, kernel)
  and cv errors to 1e-10 relative at shape parameters whose kernel
  matrices are well conditioned (1-4); on the default 12-point grid down
  to 0.01, where the truncated SVD of a matrix with cond near 1e16 sets
  what any two LAPACK builds agree to, the same choice and errors to
  1e-6 (measured 8e-10);
- train_global_rbf_bayesian: the same seeds, the same picks and the
  history's log10(eps) equal, log errors to 1e-8 relative (the errors
  come from truncated SVDs at cond up to 1e16) and 1e-12 absolute (at
  epsilon 100 the error is 1 and its log an ulp from 0), the same chosen
  epsilon;
- fit_global_rbf_anisotropic: scales and validation error to 1e-8
  (measured 4e-10 after 40 Adam steps on the gradients of LU solves with
  a condition number near 1e8), the refit model's predictions to 1e-8;
- train_svr: the port's solver is libsvm's SMO without its shrinking
  heuristic (training/svr.py), the same iterations, duals and intercepts
  as sklearn's SVR(shrinking=False) to 1e-12; against the JAX package's
  sklearn fits (with shrinking, other iterates to the same 1e-3 KKT
  tolerance) the closure agrees to 5e-3 (measured 4e-4 to 1e-3);
- each search through run_pod_rbf_global at 12^2, 8 steps, 3 + 5 modes,
  beside the JAX runner on the same basis and snapshots: equal
  Gauss-Newton totals, errors to 1e-6 percentage points, trajectories to
  1e-8, and the search's own model file (none for svr).
"""

import contextlib
import functools
import io
import os
import re
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu.closures.rbf import rbf_global_predict as jpredict
from finitedifference_tpu.training import rbf_train as jtrain
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.closures.rbf import (
    rbf_global_predict as tpredict,
)
from finitedifference_tpu_torch.runners import run_pod_rbf_global as trun
from finitedifference_tpu_torch.training import rbf_train as ttrain

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "runners"))
import run_pod_rbf_global as jrun  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")
SMALL = dict(num_cells=12, num_steps=8, num_primary=3, num_secondary=5)
MU = (5.19, 0.026)


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


def smooth_pairs(n=120, n_p=3, n_s=4, seed=0, stretch=None):
    """tests/test_training_extras.py's pairs: tanh of a random mix."""
    rng = np.random.default_rng(seed)
    q_p = rng.uniform(-1, 1, size=(n, n_p))
    if stretch is not None:
        q_p = q_p * np.asarray(stretch)
    a = rng.normal(size=(n_p, n_s))
    q_s = np.tanh((q_p / (np.asarray(stretch) if stretch is not None
                          else 1.0)) @ a)
    return q_p, q_s


def held_out(model_j, model_t, q_p):
    want = np.stack([np.asarray(jpredict(model_j, jnp.asarray(y)))
                     for y in q_p])
    got = np.stack([npy(tpredict(model_t, to_torch(y))) for y in q_p])
    return rel(got, want)


@pytest.mark.parametrize("grid,tol", [
    (dict(epsilons=[1.0, 1.5, 2.5, 4.0], kernels=("gaussian", "imq"),
          n_folds=3), 1e-10),
    ({}, 1e-6)], ids=["conditioned", "default"])
def test_cv_search_matches_jax(grid, tol):
    q_p, q_s = smooth_pairs(n=120)
    jm, jlog = jtrain.train_global_rbf_cv(q_p, q_s, **grid)
    tm, tlog = ttrain.train_global_rbf_cv(q_p, q_s, device="cpu", **grid)
    assert tlog["best"]["kernel"] == jlog["best"]["kernel"]
    assert tlog["best"]["epsilon"] == jlog["best"]["epsilon"]
    assert tm.kernel == jm.kernel and tm.epsilon == jm.epsilon
    for k in grid.get("kernels", ("gaussian", "imq", "multiquadric")):
        assert tlog[k]["epsilons"] == jlog[k]["epsilons"]
        np.testing.assert_allclose(tlog[k]["cv_errors"],
                                   jlog[k]["cv_errors"], rtol=tol)
    assert abs(tlog["best"]["cv_error"] - jlog["best"]["cv_error"]) \
        <= tol * jlog["best"]["cv_error"]
    assert held_out(jm, tm, q_p[:5]) <= 1e-8


def test_bayesian_search_matches_jax():
    q_p, q_s = smooth_pairs()
    kw = dict(kernel="gaussian", n_iters=10, n_seed=4)
    jm, jlog = jtrain.train_global_rbf_bayesian(q_p, q_s, **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tm, tlog = ttrain.train_global_rbf_bayesian(q_p, q_s, device="cpu",
                                                    verbose=True, **kw)
    jh, th = jlog["history"], tlog["history"]
    assert len(th["log10_eps"]) == 10
    assert th["log10_eps"] == jh["log10_eps"]
    np.testing.assert_allclose(th["log_err"], jh["log_err"], rtol=1e-8,
                               atol=1e-12)
    assert tlog["best"]["epsilon"] == jlog["best"]["epsilon"]
    assert tlog["best"]["kernel"] == "gaussian"
    assert out.getvalue().count("bayes it") == 6
    assert held_out(jm, tm, q_p[:5]) <= 1e-8


def test_aniso_fit_matches_jax():
    q_p, q_s = smooth_pairs(n=150, stretch=[10.0, 1.0, 1.0])
    jm, jinfo = jtrain.fit_global_rbf_anisotropic(q_p, q_s, num_steps=40)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tm, tinfo = ttrain.fit_global_rbf_anisotropic(
            q_p, q_s, num_steps=40, device="cpu", verbose=True)
    np.testing.assert_allclose(tinfo["scales"], jinfo["scales"], rtol=1e-8)
    assert abs(tinfo["val_error"] - jinfo["val_error"]) \
        <= 1e-8 * jinfo["val_error"]
    assert tm.epsilon == jm.epsilon == 1.0
    assert rel(tm.scaler.scale_, jm.scaler.scale_) <= 1e-8
    assert held_out(jm, tm, q_p[:5]) <= 1e-8
    assert out.getvalue().count("aniso it") == 1      # i = 0 only


@pytest.mark.parametrize("c", [0.1, 1.0, 10.0])
def test_svr_solver_is_libsvm_without_shrinking(c):
    """training/svr.fit_svr against sklearn's SVR(shrinking=False), mode
    by mode: the same SMO iterations, dual coefficients and intercepts
    to 1e-12."""
    from sklearn.svm import SVR

    from finitedifference_tpu_torch.training.svr import fit_svr

    q_p, q_s = smooth_pairs(n=120)
    gamma = 1.0 / (3 * q_p.var())
    fit = fit_svr(to_torch(q_p), to_torch(q_s), c, 1e-3, gamma)
    for j in range(q_s.shape[1]):
        m = SVR(kernel="rbf", C=c, epsilon=1e-3, gamma=gamma,
                shrinking=False).fit(q_p, q_s[:, j])
        coef = np.zeros(q_p.shape[0])
        coef[m.support_] = m.dual_coef_[0]
        assert int(fit.n_iter[j]) == int(m.n_iter_)
        np.testing.assert_allclose(npy(fit.dual_coef[j]), coef, rtol=0,
                                   atol=1e-12)
        assert abs(float(fit.intercept[j]) - m.intercept_[0]) <= 1e-12


def test_svr_closure_matches_jax():
    """Against the JAX package's train_svr (sklearn's SVR with libsvm's
    shrinking, which takes other SMO iterates to the same 1e-3 stopping
    tolerance): gamma to 1e-12, the validation error to 1e-2 relative
    (measured 2.6e-3), the closure's values and Jacobians to 5e-3
    (measured 4e-4 and 1e-3); the analytic Jacobian against jacfwd of the
    port's own predict to 1e-10; float32 y in, float32 out."""
    q_p, q_s = smooth_pairs(n=150)
    jc, jinfo = jtrain.train_svr(q_p, q_s, c_grid=(1.0, 10.0))
    tc, tinfo = ttrain.train_svr(q_p, q_s, c_grid=(1.0, 10.0), device="cpu")
    assert tinfo["gamma"] == pytest.approx(jinfo["gamma"], rel=1e-12)
    assert tinfo["val_error"] == pytest.approx(jinfo["val_error"], rel=1e-2)
    preds, jacs = [], []
    for y in q_p[:4]:
        yj, yt = jnp.asarray(y), to_torch(y)
        j_t = tc.jacobian(yt)
        assert j_t.shape == (4, 3)
        assert rel(j_t, torch.func.jacfwd(tc.predict)(yt)) <= 1e-10
        preds.append((npy(tc.predict(yt)), np.asarray(jc.predict(yj))))
        jacs.append((npy(j_t), np.asarray(jc.jacobian(yj))))
        assert tc.predict(yt.float()).dtype == torch.float32
        assert tc.jacobian(yt.float()).dtype == torch.float32
    for pairs in (preds, jacs):
        got, want = map(np.stack, zip(*pairs))
        assert rel(got, want) <= 5e-3


# ------------------------------------------------------------- the runner


def run(main, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, err = main(*MU, **SMALL, **kw)
    out = buf.getvalue()
    gn = int(re.findall(r"Total GN iterations: (\d+)", out)[-1])
    saved = re.findall(r"Snapshot saved as (\S+)", out)[-1]
    return dict(err=err, gn=gn, traj=np.load(saved), out=out)


@pytest.fixture(scope="module")
def runner_dirs(tmp_path_factory):
    """A JAX directory with the 12^2 basis and snapshot cache, and a port
    directory starting from a copy of them."""
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("torch")
    old = os.getcwd()
    try:
        os.chdir(jdir)
        with contextlib.redirect_stdout(io.StringIO()):
            jrun.main(*MU, **SMALL)
    finally:
        os.chdir(old)
    shutil.copy(jdir / "basis_12x12.npy", tdir / "basis_12x12.npy")
    shutil.copytree(jdir / "param_snaps_12x12", tdir / "param_snaps_12x12")
    return jdir, tdir


@pytest.mark.parametrize("search", ["cv", "bayesian", "aniso", "svr"])
def test_runner_search_matches_jax(runner_dirs, search, monkeypatch):
    jdir, tdir = runner_dirs
    monkeypatch.chdir(jdir)
    want = run(jrun.main, search=search)
    monkeypatch.chdir(tdir)
    got = run(trun.main, search=search, device="cpu")
    assert got["gn"] == want["gn"]
    assert abs(got["err"] - want["err"]) <= 1e-6
    assert rel(got["traj"], want["traj"]) <= 1e-8
    assert f"{search}-search fit time" in got["out"]
    stem = f"pod_rbf_global_model_{search}_p3_12x12.npz"
    assert os.path.exists(tdir / stem) == (search != "svr") \
        == os.path.exists(jdir / stem)
    if search != "svr":
        zj, zt = np.load(jdir / stem), np.load(tdir / stem)
        assert sorted(zt.files) == sorted(zj.files)
        assert str(zt["kernel"]) == str(zj["kernel"])
        assert float(zt["epsilon"]) == float(zj["epsilon"])
