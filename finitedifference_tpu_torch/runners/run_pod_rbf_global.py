"""POD-RBF PROM with global interpolation (reference run_POD_RBF_global.py):
loads or trains pod_rbf_global_model.npz by a hyperparameter search, then
the manifold LSPG ROM at (mu1, mu2) against the cached FOM.

    python -m finitedifference_tpu_torch.runners.run_pod_rbf_global
        [--device cpu] [--retrain] [--num-primary 10 --num-secondary 140]
        [--search grid|cv|bayesian|aniso|svr]

Each search other than grid keeps its own model file
(pod_rbf_global_model_{search}.npz); svr trains on every run and writes
none.
"""

import os
import time

import numpy as np
import torch

from finitedifference_tpu_torch.closures.rbf import global_rbf_closure
from finitedifference_tpu_torch.runners.common import (
    base_parser,
    default_config,
    make_problem,
    res_path,
    run_manifold,
    runner_device,
    split_training,
)
from finitedifference_tpu_torch.snapshots import load_or_compute_snaps
from finitedifference_tpu_torch.training.rbf_train import (
    fit_global_rbf_anisotropic,
    load_global_rbf,
    save_global_rbf,
    train_global_rbf,
    train_global_rbf_bayesian,
    train_global_rbf_cv,
    train_svr,
)

MODEL_PATH = "pod_rbf_global_model.npz"
SEARCHES = ("grid", "cv", "bayesian", "aniso", "svr")


def get_global_rbf(cfg, grid, w0, num_primary, num_secondary,
                   model_path=None, retrain=False, search="grid",
                   device=None):
    """Build-or-load the global closure model: (u_p, u_s, closure).

    search, the hyperparameter strategy (each the port of a reference
    trainer script):
      grid     — (epsilon x kernel) grid search
                 (compute_global_weights_with_kernels.py);
      cv       — k-fold cross-validated grid
                 (compute_global_weights_grid_search_cv_with_kernels.py);
      bayesian — GP expected improvement over log10(epsilon)
                 (compute_global_weights_bayesian_optimization_with_kernels.py);
      aniso    — per-dimension length scales, fitted by Adam
                 (perform_training_bayesian_optimization_anisotropic_fine_tuned.py);
      svr      — per-mode support-vector regression
                 (compute_global_svr_grid_search_with_kernels.py), trained
                 on every run, with no model file.
    """
    if search not in SEARCHES:
        raise ValueError(f"unknown search {search!r}; use one of "
                         f"{SEARCHES}")
    u_p, u_s, q_p, q_s = split_training(cfg, grid, w0,
                                        num_primary + num_secondary,
                                        num_primary, num_secondary,
                                        device=device)
    if search == "svr":
        t0 = time.time()
        closure, info = train_svr(q_p, q_s, seed=cfg.seed, device=device,
                                  verbose=True)
        print(f"svr best: {info}")
        print(f"svr-search fit time: {time.time() - t0:.2f}s "
              f"({q_p.shape[0]} pairs)")
        return u_p, u_s, closure

    trainers = {"grid": train_global_rbf,
                "cv": train_global_rbf_cv,
                "bayesian": train_global_rbf_bayesian,
                "aniso": fit_global_rbf_anisotropic}
    if model_path is None:
        stem = MODEL_PATH if search == "grid" \
            else MODEL_PATH.replace(".npz", f"_{search}.npz")
        if num_primary != 10:
            # a non-default split gets its own artifact
            stem = stem.replace(".npz", f"_p{num_primary}.npz")
        model_path = res_path(cfg, stem)
    if retrain or not os.path.exists(model_path):
        t0 = time.time()
        model, log = trainers[search](q_p, q_s, seed=cfg.seed,
                                      device=device, verbose=True)
        print(f"{search}-search best: {log.get('best', log)}")
        print(f"{search}-search fit time: {time.time() - t0:.2f}s "
              f"({q_p.shape[0]} pairs)")
        save_global_rbf(model, model_path)
    else:
        model = load_global_rbf(model_path, device=device)
    return u_p, u_s, global_rbf_closure(model)


def training_warm_q1(cfg, grid, w0, u_p, device=None):
    """q_p of the first training trajectory at t=1 (the reference's step-0
    reseed source, hypernet2D.py:1100-1102)."""
    snaps = load_or_compute_snaps(cfg.mu_samples()[0], grid,
                                  torch.as_tensor(w0, device=device),
                                  cfg.dt, cfg.num_steps,
                                  snap_folder=cfg.snap_folder)
    return np.asarray(u_p).T @ snaps[:, 1]


def main(mu1=4.75, mu2=0.02, num_primary=10, num_secondary=140,
         retrain=False, num_cells=None, num_steps=None, f32=False,
         search="grid", device="cuda"):
    dev = runner_device(device)
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)
    u_p, u_s, closure = get_global_rbf(cfg, grid, w0, num_primary,
                                       num_secondary, retrain=retrain,
                                       search=search, device=dev)
    suffix = "" if search == "grid" else f"_{search}"
    return run_manifold(cfg, grid, w0, u_p, u_s, closure, mu1, mu2,
                        f32=f32, label=f"POD-RBF-global{suffix}",
                        save_prefix=f"pod_rbf_global{suffix}",
                        warm_q1=training_warm_q1(cfg, grid, w0, u_p,
                                                 device=dev),
                        device=dev)


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--num-primary", type=int, default=10)
    p.add_argument("--num-secondary", type=int, default=140)
    p.add_argument("--retrain", action="store_true")
    p.add_argument("--search", default="grid", choices=list(SEARCHES),
                   help="hyper-parameter search strategy")
    a = p.parse_args()
    main(a.mu1, a.mu2, a.num_primary, a.num_secondary, a.retrain,
         a.num_cells, a.num_steps, a.f32, a.search, a.device)
