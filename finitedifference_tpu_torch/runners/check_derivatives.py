"""Derivative (gradient) checks: finite-difference vs analytic closure
Jacobians with the classic error-vs-epsilon slope (role of the
reference's check_derivative_dynamic*.py and
check_rbf_derivatives_vs_finite_difference.py).

    python -m finitedifference_tpu_torch.runners.check_derivatives
        [--device cpu] [--kernel gaussian] [--seed 0]

For each closure the FD error || (f(y+h d) - f(y))/h - J d || should
decay with slope ~1 in h (slope ~2 for central differences) until
roundoff; a flat curve means a wrong Jacobian. Counterpart of
runners/check_derivatives.py: the same four closures (global RBF, kNN
RBF, GP, RNM), fitted and evaluated on `device` (the card unless asked
for the CPU), the same floors and verdicts.
"""

import argparse

import numpy as np
import torch

from finitedifference_tpu_torch.device import to_host
from finitedifference_tpu_torch.runners.common import runner_device


def slope_check(predict, jacobian, y, seed=0, hs=None, central=True):
    if hs is None:
        hs = np.logspace(-1, -7, 13)
    rng = np.random.default_rng(seed)
    d = rng.normal(size=y.shape[0])
    d /= np.linalg.norm(d)
    dj = torch.as_tensor(d, dtype=y.dtype, device=y.device)
    jac_d = to_host(jacobian(y) @ dj)
    errs = []
    for h in hs:
        if central:
            fd = (to_host(predict(y + h * dj))
                  - to_host(predict(y - h * dj))) / (2 * h)
        else:
            fd = (to_host(predict(y + h * dj)) - to_host(predict(y))) / h
        errs.append(np.linalg.norm(fd - jac_d))
    errs = np.asarray(errs)
    # fitted slope over the decaying region (skip roundoff tail)
    k = max(3, int(len(hs) * 0.5))
    slope = np.polyfit(np.log(hs[:k]), np.log(errs[:k] + 1e-300), 1)[0]
    return hs, errs, slope


def main(kernel="gaussian", seed=0, verbose=True, device="cuda"):
    from finitedifference_tpu_torch.closures.ann import init_rnm, rnm_closure
    from finitedifference_tpu_torch.closures.gp import fit_gp, gp_closure
    from finitedifference_tpu_torch.closures.rbf import (
        fit_global_rbf,
        fit_knn_rbf,
        global_rbf_closure,
        knn_rbf_closure,
    )

    dev = runner_device(device)
    rng = np.random.default_rng(seed)
    q_p = rng.uniform(-1, 1, size=(80, 4))
    a = rng.normal(size=(4, 6))
    q_s = np.sin(q_p @ a)
    y = torch.as_tensor(q_p[7] + 0.013, device=dev)

    results = {}
    for name, closure, floor in [
        (f"rbf_global_{kernel}",
         global_rbf_closure(fit_global_rbf(q_p, q_s, 0.8, kernel=kernel,
                                           device=dev)),
         1e-9),
        (f"rbf_knn_{kernel}",
         knn_rbf_closure(fit_knn_rbf(q_p, q_s, 0.8, 16, kernel=kernel,
                                     device=dev)),
         1e-9),
        ("gp", gp_closure(fit_gp(q_p, q_s, num_steps=100, device=dev)),
         1e-9),
        # the RNM net computes in float32 (reference torch default), so
        # central differences floor near sqrt-ish of f32 eps
        ("rnm", rnm_closure(init_rnm(4, 6, device=dev)), 1e-3),
    ]:
        hs, errs, slope = slope_check(closure.predict, closure.jacobian, y)
        ok = slope > 1.5 or errs.min() < floor
        results[name] = (slope, errs.min(), ok)
        if verbose:
            print(f"{name:24s} slope={slope:5.2f} "
                  f"min err={errs.min():.2e}  "
                  f"{'OK' if ok else 'SUSPECT'}")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kernel", default="gaussian")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to fit and evaluate (default: the CUDA "
                        "device)")
    a = p.parse_args()
    main(a.kernel, a.seed, device=a.device)
