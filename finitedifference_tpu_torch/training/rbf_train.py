"""RBF closure fits with hyperparameter search (PyTorch).

Counterpart of finitedifference_tpu/training/rbf_train.py, the part the
POD-RBF runners use: dedup the projected coordinates, MinMax-scale q_p
to (-1, 1), grid-search (epsilon, kernel) on a train/val split with the
SVD-regularized solve of Phi W = q_s and keep the best global model; the
(k, epsilon, ridge) search of the kNN closure; the .npz model file, with
the JAX package's keys, so each package loads the other's
pod_rbf_global_model.npz.

The other searches of the POD-RBF global runner: the k-fold
cross-validated grid (train_global_rbf_cv), GP expected improvement over
log10(epsilon) (train_global_rbf_bayesian, on closures/gp), per-dimension
scales fitted by Adam on the validation error (fit_global_rbf_anisotropic)
and per-mode support-vector regression (train_svr, on training/svr.py's
batched libsvm solver).

The fits run on the device the caller names (default: the card; the JAX
package moves them to the host CPU because a TPU emulates f64). The
splits and folds are NumPy's default_rng(seed), as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Sequence, Tuple

import numpy as np
import torch

from finitedifference_tpu_torch.closures.common import (
    Closure,
    MinMaxScaler,
    fit_minmax,
)
from finitedifference_tpu_torch.closures.rbf import (
    GlobalRBF,
    _get_kernel,
    fit_global_rbf,
    fit_knn_rbf,
    kernel_matrix,
    rbf_knn_predict,
    svd_solve,
)
from finitedifference_tpu_torch.device import resolve_device, to_host
from finitedifference_tpu_torch.optim import adam_minimize


def remove_duplicates(q_p, q_s, decimals: int = 8):
    """Drop duplicate q_p rows (tolerance-rounded np.unique, like the
    reference's remove_duplicates); host NumPy arrays in and out."""
    q_p = to_host(q_p)
    q_s = to_host(q_s)
    _, idx = np.unique(np.round(q_p, decimals), axis=0, return_index=True)
    idx = np.sort(idx)
    return q_p[idx], q_s[idx]


def _val_error(q_p_tr, q_s_tr, q_p_va, q_s_va, eps, kernel, scaler,
               lambda_reg=1e-8, sval_tol=1e-8):
    """Held-out relative errors ||pred - q_s_va|| / ||q_s_va|| of the
    global fits on the training rows, one per entry of the 1-D tensor
    `eps`: the (n_eps, n, n) kernel matrices go through one batched SVD
    (the JAX package vmaps over eps)."""
    qn_tr = scaler.transform(q_p_tr)
    qn_va = scaler.transform(q_p_va)
    e = eps[:, None, None]
    n_tr, n_va = qn_tr.shape[0], qn_va.shape[0]
    # the linear kernel ignores eps: broadcast it to one matrix per eps
    phi = kernel_matrix(qn_tr, qn_tr, e, kernel).expand(len(eps), n_tr,
                                                         n_tr)
    phi = phi + lambda_reg * torch.eye(n_tr, dtype=phi.dtype,
                                       device=phi.device)
    w = svd_solve(phi, q_s_tr, sval_tol)
    pred = kernel_matrix(qn_va, qn_tr, e, kernel).expand(
        len(eps), n_va, n_tr) @ w
    return torch.linalg.vector_norm(pred - q_s_va, dim=(1, 2)) \
        / torch.linalg.vector_norm(q_s_va)


def _split(n: int, train_frac: float, seed: int):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_tr = int(train_frac * n)
    return perm[:n_tr], perm[n_tr:]


def train_global_rbf(q_p, q_s, *,
                     epsilons: Sequence[float] = None,
                     kernels: Sequence[str] = ("gaussian", "imq",
                                               "multiquadric", "linear",
                                               "matern"),
                     train_frac: float = 0.8, seed: int = 1234557,
                     dedup: bool = True, device=None,
                     verbose: bool = False) -> Tuple[GlobalRBF, dict]:
    """Grid-search (epsilon x kernel), return (best model, search log).

    Each candidate is fit on the train split and scored on the held-out
    split; the best (the first on a tie) is refit on all the (deduped)
    data. Runs on `device` (default: the card).
    """
    dev = resolve_device(device)
    if epsilons is None:
        epsilons = np.logspace(-2, 1, 16)
    q_p = to_host(q_p)
    q_s = to_host(q_s)
    if dedup:
        q_p, q_s = remove_duplicates(q_p, q_s)

    tr, va = _split(q_p.shape[0], train_frac, seed)
    scaler = fit_minmax(q_p[tr], device=dev)
    qp_tr = torch.as_tensor(q_p[tr], device=dev)
    qs_tr = torch.as_tensor(q_s[tr], device=dev)
    qp_va = torch.as_tensor(q_p[va], device=dev)
    qs_va = torch.as_tensor(q_s[va], device=dev)

    log = {}
    best = (np.inf, None, None)
    eps_arr = torch.as_tensor(np.asarray(epsilons, dtype=q_p.dtype),
                              device=dev)
    for kernel in kernels:
        errs = to_host(_val_error(qp_tr, qs_tr, qp_va, qs_va, eps_arr,
                                  kernel, scaler))
        i = int(np.nanargmin(errs))
        log[kernel] = {"epsilons": np.asarray(epsilons).tolist(),
                       "errors": errs.tolist()}
        if verbose:
            print(f"  {kernel}: best eps={epsilons[i]:.4g} "
                  f"err={errs[i]:.3e}")
        if errs[i] < best[0]:
            best = (errs[i], float(epsilons[i]), kernel)

    _, eps_best, kern_best = best
    # final fit on ALL (deduped) data with the chosen hyperparameters
    model = fit_global_rbf(torch.as_tensor(q_p, device=dev), q_s, eps_best,
                           kernel=kern_best,
                           scaler=fit_minmax(q_p, device=dev))
    log["best"] = {"epsilon": eps_best, "kernel": kern_best,
                   "val_error": float(best[0])}
    return model, log


def train_knn_rbf_search(q_p, q_s, *, epsilons=None, neighbor_counts=None,
                         ridges=None,
                         kernel: str = "gaussian", train_frac: float = 0.8,
                         seed: int = 1234557, device=None,
                         verbose: bool = False):
    """Search (epsilon, k, ridge) for the kNN-RBF closure: fit on a train
    split, score by held-out reconstruction error (every held-out query
    at once, torch.func.vmap over rbf_knn_predict), refit the best (the
    first on a tie) on all data. Runs on `device` (default: the card).
    """
    dev = resolve_device(device)
    q_p = to_host(q_p)
    q_s = to_host(q_s)
    if epsilons is None:
        epsilons = np.logspace(-2, 1, 8)
    tr, va = _split(q_p.shape[0], train_frac, seed)
    if neighbor_counts is None:
        neighbor_counts = [k for k in (10, 20, 50, 100) if k <= len(tr)]
    if ridges is None:
        ridges = [1e-8, 1e-6, 1e-5, 1e-4]

    qp_tr = torch.as_tensor(q_p[tr], device=dev)
    qp_va = torch.as_tensor(q_p[va], device=dev)
    best = (np.inf, None)
    log = {}
    for k in neighbor_counts:
        for eps in epsilons:
            for ridge in ridges:
                model = fit_knn_rbf(qp_tr, q_s[tr], float(eps), int(k),
                                    kernel=kernel, ridge=float(ridge))
                pred = torch.func.vmap(
                    lambda y: rbf_knn_predict(model, y))(qp_va)
                err = float(np.linalg.norm(to_host(pred) - q_s[va])
                            / np.linalg.norm(q_s[va]))
                log[(int(k), float(eps), float(ridge))] = err
                if verbose:
                    print(f"  knn k={k} eps={eps:.4g} "
                          f"ridge={ridge:.1g}: err={err:.3e}")
                if err < best[0]:
                    best = (err, (int(k), float(eps), float(ridge)))

    err, (k_best, eps_best, ridge_best) = best
    # final fit on all data
    model = fit_knn_rbf(torch.as_tensor(q_p, device=dev), q_s, eps_best,
                        k_best, kernel=kernel, ridge=ridge_best)
    return model, {"best": {"neighbors": k_best, "epsilon": eps_best,
                            "ridge": ridge_best, "val_error": err},
                   "grid": {str(k): v for k, v in log.items()}}


def _deduped(q_p, q_s, dedup):
    q_p = to_host(q_p)
    q_s = to_host(q_s)
    return remove_duplicates(q_p, q_s) if dedup else (q_p, q_s)


def _split_tensors(q_p, q_s, tr, va, dev):
    """(q_p[tr], q_s[tr], q_p[va], q_s[va]) as tensors on dev."""
    return tuple(torch.as_tensor(a[i], device=dev)
                 for a, i in ((q_p, tr), (q_s, tr), (q_p, va), (q_s, va)))


def _final_fit(q_p, q_s, eps, kernel, dev, scaler=None):
    """The chosen model refit on all the (deduped) data."""
    q_p = torch.as_tensor(q_p, device=dev)
    return fit_global_rbf(q_p, q_s, eps, kernel=kernel,
                          scaler=fit_minmax(q_p) if scaler is None
                          else scaler)


def train_global_rbf_cv(q_p, q_s, *, epsilons=None,
                        kernels=("gaussian", "imq", "multiquadric"),
                        n_folds: int = 5, seed: int = 1234557,
                        dedup: bool = True, device=None,
                        verbose: bool = False):
    """k-fold cross-validated (epsilon x kernel) grid search (the
    reference's compute_global_weights_grid_search_cv_with_kernels.py):
    equal-size folds from default_rng(seed).permutation (the remainder
    cut), a scaler fit per fold on its training rows, each fold's eps
    sweep one batched _val_error, the mean over folds; the best (the
    first on a tie) is refit on all data. Runs on `device` (default: the
    card)."""
    dev = resolve_device(device)
    q_p, q_s = _deduped(q_p, q_s, dedup)
    if epsilons is None:
        epsilons = np.logspace(-2, 1, 12)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(q_p.shape[0])
    fold_size = q_p.shape[0] // n_folds
    folds = perm[: fold_size * n_folds].reshape(n_folds, fold_size)

    eps_arr = torch.as_tensor(np.asarray(epsilons, dtype=q_p.dtype),
                              device=dev)
    best = (np.inf, None, None)
    log = {}
    for kernel in kernels:
        def one_fold(i):
            va = folds[i]
            tr = np.concatenate([folds[j] for j in range(n_folds)
                                 if j != i])
            scaler = fit_minmax(q_p[tr], device=dev)
            return to_host(_val_error(
                *_split_tensors(q_p, q_s, tr, va, dev), eps_arr, kernel,
                scaler))

        errs = np.mean([one_fold(i) for i in range(n_folds)], axis=0)
        i = int(np.nanargmin(errs))
        log[kernel] = {"epsilons": np.asarray(epsilons).tolist(),
                       "cv_errors": errs.tolist()}
        if verbose:
            print(f"  {kernel}: best eps={epsilons[i]:.4g} "
                  f"cv err={errs[i]:.3e}")
        if errs[i] < best[0]:
            best = (errs[i], float(epsilons[i]), kernel)

    _, eps_best, kern_best = best
    model = _final_fit(q_p, q_s, eps_best, kern_best, dev)
    log["best"] = {"epsilon": eps_best, "kernel": kern_best,
                   "cv_error": float(best[0])}
    return model, log


def train_global_rbf_bayesian(q_p, q_s, *, kernel: str = "gaussian",
                              n_iters: int = 20, n_seed: int = 5,
                              log_eps_bounds=(-4.0, 2.0),
                              train_frac: float = 0.8, seed: int = 1234557,
                              dedup: bool = True, device=None,
                              verbose: bool = False):
    """Bayesian optimization of epsilon (the reference's
    compute_global_weights_bayesian_optimization_with_kernels.py, with
    skopt): n_seed points on linspace(lo, hi), then GP expected
    improvement over 256 candidates of log10(epsilon), the GP a
    closures/gp.fit_gp (noise 1e-6, 100 Adam steps) on (log10 eps,
    log err); a repeated pick is re-drawn by rng.uniform. The candidates'
    posterior means come from one batched gp_predict (the JAX package
    reads them one candidate at a time). Runs on `device` (default: the
    card)."""
    from scipy.stats import norm as _norm

    from finitedifference_tpu_torch.closures.gp import (
        fit_gp,
        gp_predict,
        matern32,
    )

    dev = resolve_device(device)
    q_p, q_s = _deduped(q_p, q_s, dedup)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(q_p.shape[0])
    n_tr = int(train_frac * q_p.shape[0])
    tr, va = perm[:n_tr], perm[n_tr:]
    scaler = fit_minmax(q_p[tr], device=dev)
    parts = _split_tensors(q_p, q_s, tr, va, dev)

    def log_err(x):
        eps = torch.tensor([10.0 ** x], dtype=parts[0].dtype, device=dev)
        return float(torch.log(
            _val_error(*parts, eps, kernel, scaler)[0] + 1e-300))

    lo, hi = log_eps_bounds
    xs = list(np.linspace(lo, hi, n_seed))
    ys = [log_err(x) for x in xs]

    cand = np.linspace(lo, hi, 256)
    for it in range(n_iters - n_seed):
        gp = fit_gp(np.asarray(xs)[:, None], np.asarray(ys)[:, None],
                    noise=1e-6, num_steps=100, device=dev)
        best = min(ys)
        # expected improvement from the GP posterior
        cand_t = torch.as_tensor(cand, device=dev)[:, None]
        kv = to_host(matern32(gp.x_train, gp.scaler.transform(cand_t),
                              gp.length_scale, gp.amplitude))  # (n, 256)
        mu_c = to_host(torch.func.vmap(lambda c: gp_predict(gp, c))(
            cand_t))[:, 0]
        # posterior variance (cheap full form: k** - k*^T K^-1 k*)
        kmat = to_host(matern32(gp.x_train, gp.x_train, gp.length_scale,
                                gp.amplitude))
        kinv = np.linalg.inv(kmat + gp.noise * np.eye(kmat.shape[0]))
        var = np.maximum(float(gp.amplitude)
                         - np.einsum("ic,ij,jc->c", kv, kinv, kv), 1e-12)
        sd = np.sqrt(var)
        z = (best - mu_c) / sd
        ei = (best - mu_c) * _norm.cdf(z) + sd * _norm.pdf(z)
        x_next = float(cand[int(np.argmax(ei))])
        if any(abs(x_next - x) < 1e-9 for x in xs):
            x_next = float(rng.uniform(lo, hi))
        xs.append(x_next)
        ys.append(log_err(x_next))
        if verbose:
            print(f"  bayes it {it}: log10(eps)={x_next:.3f} "
                  f"log(err)={ys[-1]:.3f}")

    eps_best = 10.0 ** xs[int(np.argmin(ys))]
    model = _final_fit(q_p, q_s, eps_best, kernel, dev)
    log = {"best": {"epsilon": float(eps_best), "kernel": kernel,
                    "val_error": float(np.exp(min(ys)))},
           "history": {"log10_eps": xs, "log_err": ys}}
    return model, log


def _aniso_val_err(log_scales, base, qp_tr, qs_tr, qp_va, qs_va,
                   kernel):
    """Held-out relative error of the global fit at epsilon 1 on inputs
    scaled by base and then by exp(log_scales), differentiable: a 1e-8
    ridge and an LU solve, and sqrt(d^2 + 1e-300) for the distance, whose
    gradient is NaN at 0 (the Gram diagonal) without the floor."""
    phi_fn, _ = _get_kernel(kernel)

    def kmat(xa, xb):
        d2 = torch.sum((xa[:, None, :] - xb[None, :, :]) ** 2, dim=-1)
        return phi_fn(torch.sqrt(d2 + 1e-300), 1.0)

    scales = torch.exp(log_scales)
    sc = MinMaxScaler(scale_=base.scale_ * scales, min_=base.min_ * scales)
    qn_tr = sc.transform(qp_tr)
    qn_va = sc.transform(qp_va)
    phi = kmat(qn_tr, qn_tr)
    phi = phi + 1e-8 * torch.eye(phi.shape[0], dtype=phi.dtype,
                                 device=phi.device)
    w = torch.linalg.solve(phi, qs_tr)
    pred = kmat(qn_va, qn_tr) @ w
    return torch.linalg.vector_norm(pred - qs_va) \
        / torch.linalg.vector_norm(qs_va)


def fit_global_rbf_anisotropic(q_p, q_s, *, kernel: str = "gaussian",
                               num_steps: int = 300, lr: float = 0.05,
                               train_frac: float = 0.8,
                               seed: int = 1234557, dedup: bool = True,
                               device=None, verbose: bool = False):
    """Anisotropic global RBF (the reference's
    perform_training_bayesian_optimization_anisotropic_fine_tuned.py):
    per-dimension scales, Adam (optax's form, from zeros) on the
    held-out error of a differentiable fit (a 1e-8 ridge and an LU solve
    in place of the truncated SVD, whose gradient is NaN on
    near-degenerate spectra). The scales are folded into the scaler and
    the model refit on all data at epsilon 1, so the standard
    predict/Jacobian apply. Runs on `device` (default: the card)."""
    dev = resolve_device(device)
    q_p, q_s = _deduped(q_p, q_s, dedup)
    tr, va = _split(q_p.shape[0], train_frac, seed)
    base = fit_minmax(q_p[tr], device=dev)
    qp_tr, qs_tr, qp_va, qs_va = _split_tensors(q_p, q_s, tr, va, dev)

    def val_err(log_scales):
        return _aniso_val_err(log_scales, base, qp_tr, qs_tr, qp_va, qs_va,
                              kernel)

    def report(i, err, params):
        if verbose and i % 50 == 0:
            print(f"  aniso it {i}: val err {float(err):.3e} "
                  f"scales {np.exp(to_host(params[0])).round(3)}")

    params0 = torch.zeros(q_p.shape[1], dtype=torch.float64, device=dev)
    (params,) = adam_minimize(val_err, (params0,), num_steps, lr,
                              callback=report)
    scales = torch.exp(params)
    scaler = MinMaxScaler(scale_=base.scale_ * scales,
                          min_=base.min_ * scales)
    model = _final_fit(q_p, q_s, 1.0, kernel, dev, scaler=scaler)
    return model, {"scales": np.exp(to_host(params)).tolist(),
                   "val_error": float(val_err(params))}


def train_svr(q_p, q_s, *, c_grid=(0.1, 1.0, 10.0, 100.0),
              epsilon: float = 1e-3, gamma: str | float = "scale",
              train_frac: float = 0.8, seed: int = 1234557, device=None,
              verbose: bool = False):
    """SVR in place of the RBF weights (the reference's
    compute_global_svr_grid_search_with_kernels.py: an RBF-kernel SVR per
    secondary mode with a grid over C). The JAX package fits sklearn's
    SVR on the host; the port solves the same dual with libsvm's
    algorithm, every mode at once, on `device` (default: the card;
    training/svr.py). gamma "scale" is sklearn's 1 / (n_p var(x)). The
    best C's closure is
    pred_j(x) = sum_i coef_ji exp(-gamma ||x - x_i||^2) + b_j over the
    training points (coef 0 off the support), with its analytic
    Jacobian; it computes in float64 and casts back to y's dtype.
    Returns (closure, {"val_error", "gamma"})."""
    from finitedifference_tpu_torch.training.svr import fit_svr, svr_predict

    dev = resolve_device(device)
    q_p = to_host(q_p)
    q_s = to_host(q_s)
    tr, va = _split(q_p.shape[0], train_frac, seed)
    scaler = fit_minmax(q_p[tr], device=dev)
    xtr = scaler.transform(torch.as_tensor(q_p[tr], device=dev))
    xva = scaler.transform(torch.as_tensor(q_p[va], device=dev))
    if gamma == "scale":
        var = to_host(xtr).var()
        gma = 1.0 / (xtr.shape[1] * var) if var != 0 else 1.0
    elif gamma == "auto":
        gma = 1.0 / xtr.shape[1]
    else:
        gma = float(gamma)
    ytr = torch.as_tensor(q_s[tr], device=dev)

    best = (np.inf, None)
    for c in c_grid:
        t0 = time.time()
        fit = fit_svr(xtr, ytr, c, epsilon, gma)
        pred = to_host(svr_predict(fit, xtr, xva, gma))
        err = np.linalg.norm(pred - q_s[va]) / np.linalg.norm(q_s[va])
        if verbose:
            print(f"  svr C={c}: val err {err:.3e} (at most "
                  f"{int(fit.n_iter.max())} SMO iterations a mode, "
                  f"{time.time() - t0:.2f}s)")
        if err < best[0]:
            best = (err, fit)
    fit = best[1]
    cd = xtr.dtype

    def predict(y):
        x = scaler.transform(y.to(cd))
        return svr_predict(fit, xtr, x[None, :], gma)[0].to(y.dtype)

    def jacobian(y):
        # d/dx exp(-g ||x - x_i||^2) = -2 g (x - x_i) exp(...), chained
        # through the scaler
        diff = scaler.transform(y.to(cd))[None, :] - xtr  # (l, n_p)
        k = torch.exp(-gma * torch.sum(diff * diff, dim=1))
        jac = -2.0 * gma * ((fit.dual_coef * k[None, :]) @ diff)
        return (jac * scaler.scale_[None, :]).to(y.dtype)

    return Closure(predict=predict, jacobian=jacobian), \
        {"val_error": float(best[0]), "gamma": float(gma)}


def save_global_rbf(model: GlobalRBF, path: str) -> None:
    """Persist as an .npz with the JAX package's keys (the logical content
    of the reference's pod_rbf_global_model/{global_weights.pkl,
    scaler.pkl})."""
    np.savez(path,
             w_global=to_host(model.w_global),
             q_p_train=to_host(model.q_p_train),
             epsilon=model.epsilon, kernel=model.kernel,
             scaler_scale=to_host(model.scaler.scale_),
             scaler_min=to_host(model.scaler.min_))


def load_global_rbf(path: str, device=None) -> GlobalRBF:
    """The model of save_global_rbf (of either package), on `device`
    (default: the card)."""
    dev = resolve_device(device)
    z = np.load(path, allow_pickle=True)

    def arr(key):
        return torch.as_tensor(z[key], device=dev)

    return GlobalRBF(
        w_global=arr("w_global"),
        q_p_train=arr("q_p_train"),
        epsilon=float(z["epsilon"]), kernel=str(z["kernel"]),
        scaler=MinMaxScaler(scale_=arr("scaler_scale"),
                            min_=arr("scaler_min")),
    )
