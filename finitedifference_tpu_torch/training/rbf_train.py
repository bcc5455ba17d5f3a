"""RBF closure fits with hyperparameter search (PyTorch).

Counterpart of finitedifference_tpu/training/rbf_train.py, the part the
POD-RBF runners use: dedup the projected coordinates, MinMax-scale q_p
to (-1, 1), grid-search (epsilon, kernel) on a train/val split with the
SVD-regularized solve of Phi W = q_s and keep the best global model; the
(k, epsilon, ridge) search of the kNN closure; the .npz model file, with
the JAX package's keys, so each package loads the other's
pod_rbf_global_model.npz.

The fits run on the device the caller names (default: the card; the JAX
package moves them to the host CPU because a TPU emulates f64). The
train/val split is NumPy's default_rng(seed), as in the JAX package.
Not ported yet: train_global_rbf_cv, train_global_rbf_bayesian,
fit_global_rbf_anisotropic and train_svr (ROADMAP Queue A item 4d).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from finitedifference_tpu_torch.closures.common import (
    MinMaxScaler,
    fit_minmax,
)
from finitedifference_tpu_torch.closures.rbf import (
    GlobalRBF,
    fit_global_rbf,
    fit_knn_rbf,
    kernel_matrix,
    rbf_knn_predict,
    svd_solve,
)
from finitedifference_tpu_torch.device import resolve_device, to_host


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
