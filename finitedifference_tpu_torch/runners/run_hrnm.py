"""HRNM: the POD-ANN manifold ROM with ECSW / ECM hyper-reduction
(reference run_HRNM_ecm.py / run_HRNM_ecsw_joshua.py, bc_w=10).

The RNM closure of run_rnm (rnm_model.pt, trained first when missing),
then, with --compute-ecsw or when ecsw_weights_rnm_{method}.npy is
missing, the closure training matrix from the mu=(4.25, 0.0225)
trajectory and NNLS / ECM weights with the boundary ring at bc_w.
Online: the manifold LSPG ROM on the sampled mesh.

    python -m finitedifference_tpu_torch.runners.run_hrnm [--device cpu]
        [--compute-ecsw] [--weights-method nnls|scipy_nnls|ecm]
"""

from finitedifference_tpu_torch.runners.common import (
    base_parser,
    closure_ecsw_weights,
    default_config,
    make_problem,
    res_path,
    run_manifold,
    runner_device,
)
from finitedifference_tpu_torch.runners.run_rnm import get_rnm_closure

WEIGHT_METHODS = ("nnls", "scipy_nnls", "ecm")


def main(mu1=5.19, mu2=0.026, num_primary=10, num_secondary=140,
         weights_method="nnls", compute_ecsw=False, bc_w=10.0,
         num_cells=None, num_steps=None, f32=False, device="cuda"):
    dev = runner_device(device)
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)
    u_p, u_s, closure = get_rnm_closure(cfg, grid, w0, num_primary,
                                        num_secondary, device=dev)
    weights = closure_ecsw_weights(
        cfg, grid, w0, u_p, u_s, closure,
        weights_path=res_path(cfg, f"ecsw_weights_rnm_{weights_method}.npy"),
        method=weights_method, bc_w=bc_w, compute=compute_ecsw,
        device=dev)
    print(f"N_e = {int((weights > 0).sum())}")
    prefix = "hrnm" if weights_method == "nnls" \
        else f"hrnm_{weights_method}"
    return run_manifold(cfg, grid, w0, u_p, u_s, closure, mu1, mu2,
                        f32=f32, weights_full=weights, label="HRNM",
                        save_prefix=prefix, device=dev)


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--num-primary", type=int, default=10)
    p.add_argument("--num-secondary", type=int, default=140)
    p.add_argument("--weights-method", default="nnls",
                   choices=list(WEIGHT_METHODS))
    p.add_argument("--compute-ecsw", action="store_true")
    p.add_argument("--bc-w", type=float, default=10.0)
    a = p.parse_args()
    main(a.mu1, a.mu2, a.num_primary, a.num_secondary, a.weights_method,
         a.compute_ecsw, a.bc_w, a.num_cells, a.num_steps, a.f32, a.device)
