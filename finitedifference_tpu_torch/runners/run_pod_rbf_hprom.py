"""POD-RBF HPROM: global or kNN interpolation + an ECSW sampled mesh
(reference run_POD_RBF_global_HPROM_*.py / run_POD_RBF_HPROM*.py).

Offline (--compute-ecsw, or when the weight file is missing): the closure
training matrix from the mu=(4.25, 0.0225) trajectory on the device, each
snapshot's coordinates fitted through the decoder, then NNLS / ECM
weights with the boundary ring at bc_w, saved to
ecsw_weights_rbf_{variant}_{method}.npy. Online: the manifold LSPG ROM on
the sampled mesh.

    python -m finitedifference_tpu_torch.runners.run_pod_rbf_hprom
        [--device cpu] [--compute-ecsw] [--variant global|knn]
        [--weights-method nnls|scipy_nnls|ecm]
"""

from finitedifference_tpu_torch.closures.rbf import (
    fit_knn_rbf,
    knn_rbf_closure,
)
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
from finitedifference_tpu_torch.runners.run_pod_rbf_global import (
    get_global_rbf,
)

VARIANTS = ("global", "knn")
WEIGHT_METHODS = ("nnls", "scipy_nnls", "ecm")


def main(mu1=5.19, mu2=0.026, num_primary=10, num_secondary=140,
         variant="global", weights_method="nnls", compute_ecsw=False,
         bc_w=10.0, epsilon=0.01, neighbors=100,
         num_cells=None, num_steps=None, f32=False, device="cuda"):
    dev = runner_device(device)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; use one of "
                         f"{VARIANTS}")
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)

    if variant == "global":
        u_p, u_s, closure = get_global_rbf(cfg, grid, w0, num_primary,
                                           num_secondary, device=dev)
    else:
        u_p, u_s, q_p, q_s = split_training(
            cfg, grid, w0, num_primary + num_secondary, num_primary,
            num_secondary, device=dev)
        model = fit_knn_rbf(q_p, q_s, epsilon,
                            min(neighbors, q_p.shape[0]), device=dev)
        closure = knn_rbf_closure(model)

    weights = closure_ecsw_weights(
        cfg, grid, w0, u_p, u_s, closure,
        weights_path=res_path(
            cfg, f"ecsw_weights_rbf_{variant}_{weights_method}.npy"),
        method=weights_method, bc_w=bc_w, compute=compute_ecsw,
        device=dev)
    print(f"N_e = {int((weights > 0).sum())}")
    return run_manifold(cfg, grid, w0, u_p, u_s, closure, mu1, mu2,
                        f32=f32, weights_full=weights,
                        label=f"POD-RBF-HPROM-{variant}",
                        save_prefix=f"pod_rbf_hprom_{variant}", device=dev)


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--num-primary", type=int, default=10)
    p.add_argument("--num-secondary", type=int, default=140)
    p.add_argument("--variant", default="global", choices=list(VARIANTS))
    p.add_argument("--weights-method", default="nnls",
                   choices=list(WEIGHT_METHODS))
    p.add_argument("--compute-ecsw", action="store_true")
    p.add_argument("--bc-w", type=float, default=10.0)
    p.add_argument("--epsilon", type=float, default=0.01)
    p.add_argument("--neighbors", type=int, default=100)
    a = p.parse_args()
    main(a.mu1, a.mu2, a.num_primary, a.num_secondary, a.variant,
         a.weights_method, a.compute_ecsw, a.bc_w, a.epsilon, a.neighbors,
         a.num_cells, a.num_steps, a.f32, a.device)
