"""POD-ANN (RNM) manifold PROM, no hyper-reduction (reference
run_RNM.py): w = U_p q + U_s N(q), N trained by training/rnm_train.

Offline (--retrain, or when rnm_model.pt is missing): the MLP regression
on every projected training pair (the 9 training trajectories, not
subsampled), its best checkpoint saved as a torch state dict with the
JAX package's sidecar rnm_model.pt.json. Online: the manifold LSPG ROM
at (mu1, mu2) against the cached FOM.

    python -m finitedifference_tpu_torch.runners.run_rnm [--device cpu]
        [--retrain] [--epochs 5000]
"""

import os
import time

from finitedifference_tpu_torch.closures.ann import init_rnm, rnm_closure
from finitedifference_tpu_torch.runners.common import (
    base_parser,
    default_config,
    make_problem,
    res_path,
    run_manifold,
    runner_device,
    split_training,
)
from finitedifference_tpu_torch.training.monitor import load_checkpoint
from finitedifference_tpu_torch.training.rnm_train import train_rnm

MODEL_PATH = "rnm_model.pt"


def get_rnm_closure(cfg, grid, w0, num_primary, num_secondary,
                    model_path=None, epochs=5000, retrain=False,
                    device=None):
    """(u_p, u_s, closure): the POD blocks and the RNM closure, trained on
    `device` when `retrain` is set or no model file exists, else loaded
    from it (in the checkpoint's dtype)."""
    if model_path is None:
        model_path = res_path(cfg, MODEL_PATH)
    # the MLP regression is cheap (unlike cubic-cost kernel fits):
    # use all projected pairs
    u_p, u_s, q_p, q_s = split_training(cfg, grid, w0,
                                        num_primary + num_secondary,
                                        num_primary, num_secondary,
                                        max_pairs=0, device=device)
    if retrain or not os.path.exists(model_path):
        t0 = time.time()
        module, _ = train_rnm(
            q_p, q_s, epochs=epochs, batch_size=cfg.batch_size,
            train_frac=cfg.train_frac, patience=500, seed=cfg.seed,
            model_path=model_path, verbose=True, device=device)
        print(f"rnm fit time: {time.time() - t0:.2f}s "
              f"({q_p.shape[0]} pairs)")
    else:
        module = load_checkpoint(model_path,
                                 init_rnm(num_primary, num_secondary,
                                          device=device))
    return u_p, u_s, rnm_closure(module)


def main(mu1=4.75, mu2=0.02, num_primary=10, num_secondary=140,
         epochs=5000, retrain=False, num_cells=None, num_steps=None,
         f32=False, device="cuda"):
    dev = runner_device(device)
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)
    u_p, u_s, closure = get_rnm_closure(cfg, grid, w0, num_primary,
                                        num_secondary, epochs=epochs,
                                        retrain=retrain, device=dev)
    return run_manifold(cfg, grid, w0, u_p, u_s, closure, mu1, mu2,
                        f32=f32, label="RNM", save_prefix="rnm",
                        device=dev)


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--num-primary", type=int, default=10)
    p.add_argument("--num-secondary", type=int, default=140)
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--retrain", action="store_true")
    a = p.parse_args()
    main(a.mu1, a.mu2, a.num_primary, a.num_secondary, a.epochs,
         a.retrain, a.num_cells, a.num_steps, a.f32, a.device)
