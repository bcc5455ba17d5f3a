"""POD-GP HPROM: a Matérn GP closure + an ECSW sampled mesh (reference
run_POD_GP_HPROM_ecsw.py / _multilevel.py).

Offline: the GP fit on the projected training pairs (--retrain, or when
pod_gp_model.npz is missing; every --per-mode variant reads and writes
that one file, as the JAX runner does, so a variant's fit replaces the
last one's), then the closure training matrix and NNLS / ECM weights
with the boundary ring at bc_w (--compute-ecsw, or when
ecsw_weights_gp_{method}.npy is missing). Online: the manifold LSPG ROM
on the sampled mesh at (mu1, mu2) against the cached FOM.

    python -m finitedifference_tpu_torch.runners.run_pod_gp_hprom
        [--device cpu] [--retrain] [--compute-ecsw]
        [--per-mode none|scales|full|variational] [--noise 1e-6]
"""

import os
import time

from finitedifference_tpu_torch.closures.gp import gp_closure
from finitedifference_tpu_torch.runners.common import (
    base_parser,
    closure_ecsw_weights,
    default_config,
    make_problem,
    res_path,
    run_manifold,
    runner_device,
    split_training,
)
from finitedifference_tpu_torch.training.gp_train import (
    PER_MODE,
    load_gp,
    save_gp,
    train_gp,
)

MODEL_PATH = "pod_gp_model.npz"
WEIGHT_METHODS = ("nnls", "scipy_nnls", "ecm")


def main(mu1=5.19, mu2=0.026, num_primary=10, num_secondary=140,
         weights_method="nnls", compute_ecsw=False, bc_w=10.0,
         retrain=False, subsample=1, noise=1e-6, num_cells=None,
         num_steps=None, f32=False, per_mode="none", num_inducing=64,
         device="cuda"):
    dev = runner_device(device)
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)
    u_p, u_s, q_p, q_s = split_training(cfg, grid, w0,
                                        num_primary + num_secondary,
                                        num_primary, num_secondary,
                                        device=dev)
    model_path = res_path(cfg, MODEL_PATH)
    if retrain or not os.path.exists(model_path):
        # subsample trades the cubic-cost fit for accuracy; the 250^2
        # recipe fits the full ~1.1k-pair set at noise 1e-6
        t0 = time.time()
        model = train_gp(q_p[::subsample], q_s[::subsample],
                         noise=noise, per_mode=per_mode,
                         num_inducing=num_inducing, device=dev,
                         verbose=True)
        print(f"gp fit time: {time.time() - t0:.2f}s "
              f"({q_p[::subsample].shape[0]} pairs, per_mode={per_mode})")
        save_gp(model, model_path)
    else:
        model = load_gp(model_path, device=dev)
    closure = gp_closure(model)

    weights = closure_ecsw_weights(
        cfg, grid, w0, u_p, u_s, closure,
        weights_path=res_path(cfg, f"ecsw_weights_gp_{weights_method}.npy"),
        method=weights_method, bc_w=bc_w, compute=compute_ecsw,
        device=dev)
    print(f"N_e = {int((weights > 0).sum())}")
    return run_manifold(cfg, grid, w0, u_p, u_s, closure, mu1, mu2,
                        f32=f32, weights_full=weights, label="POD-GP-HPROM",
                        save_prefix="pod_gp_hprom", device=dev)


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--num-primary", type=int, default=10)
    p.add_argument("--num-secondary", type=int, default=140)
    p.add_argument("--weights-method", default="nnls",
                   choices=list(WEIGHT_METHODS))
    p.add_argument("--compute-ecsw", action="store_true")
    p.add_argument("--bc-w", type=float, default=10.0)
    p.add_argument("--retrain", action="store_true")
    p.add_argument("--subsample", type=int, default=1)
    p.add_argument("--noise", type=float, default=1e-6)
    p.add_argument("--per-mode", default="none", choices=list(PER_MODE),
                   help="GP output-mode treatment on --retrain: 'none' = "
                        "one shared kernel (the recorded recipe), "
                        "'scales' = shared eigenbasis with an exact "
                        "amp/noise per mode, 'full' = one ARD GP per "
                        "secondary mode, 'variational' = sparse GP with "
                        "learned inducing points")
    p.add_argument("--num-inducing", type=int, default=64,
                   help="inducing-point count for --per-mode variational")
    a = p.parse_args()
    main(a.mu1, a.mu2, a.num_primary, a.num_secondary, a.weights_method,
         a.compute_ecsw, a.bc_w, a.retrain, a.subsample, a.noise,
         a.num_cells, a.num_steps, a.f32, a.per_mode, a.num_inducing,
         a.device)
