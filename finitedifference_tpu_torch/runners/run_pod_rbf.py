"""POD-RBF PROM with k-nearest-neighbour interpolation (reference
run_POD_RBF.py / run_POD_RBF_nearest_neighbours.py: eps=0.01, k=100),
or with the (epsilon, k, ridge) search (--search).

    python -m finitedifference_tpu_torch.runners.run_pod_rbf [--device cpu]
        [--epsilon 0.01 --neighbors 100] [--search]
"""

from finitedifference_tpu_torch.closures.rbf import (
    fit_knn_rbf,
    knn_rbf_closure,
)
from finitedifference_tpu_torch.runners.common import (
    base_parser,
    default_config,
    make_problem,
    run_manifold,
    runner_device,
    split_training,
)
from finitedifference_tpu_torch.training.rbf_train import (
    train_knn_rbf_search,
)


def main(mu1=4.75, mu2=0.02, num_primary=10, num_secondary=140,
         epsilon=0.01, neighbors=100, kernel="gaussian", search=False,
         num_cells=None, num_steps=None, f32=False, device="cuda"):
    dev = runner_device(device)
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)
    u_p, u_s, q_p, q_s = split_training(cfg, grid, w0,
                                        num_primary + num_secondary,
                                        num_primary, num_secondary,
                                        device=dev)
    if search:
        # the (epsilon, k, ridge) search instead of the reference's
        # hardcoded eps=0.01, k=100 (run_POD_RBF.py:60-69)
        model, log = train_knn_rbf_search(q_p, q_s, kernel=kernel,
                                          seed=cfg.seed, device=dev)
        print(f"knn search best: {log['best']}")
    else:
        neighbors = min(neighbors, q_p.shape[0])
        model = fit_knn_rbf(q_p, q_s, epsilon, neighbors, kernel=kernel,
                            device=dev)
    return run_manifold(cfg, grid, w0, u_p, u_s, knn_rbf_closure(model),
                        mu1, mu2, f32=f32, label="POD-RBF",
                        save_prefix="pod_rbf", device=dev)


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--num-primary", type=int, default=10)
    p.add_argument("--num-secondary", type=int, default=140)
    p.add_argument("--epsilon", type=float, default=0.01)
    p.add_argument("--neighbors", type=int, default=100)
    p.add_argument("--kernel", default="gaussian")
    p.add_argument("--search", action="store_true",
                   help="search (epsilon, k, ridge) instead of using the "
                        "reference's hardcoded values")
    a = p.parse_args()
    main(a.mu1, a.mu2, a.num_primary, a.num_secondary, a.epsilon,
         a.neighbors, a.kernel, a.search, a.num_cells, a.num_steps,
         a.f32, a.device)
