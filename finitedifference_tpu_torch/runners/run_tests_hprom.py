"""Regression/benchmark driver for the hyper-reduced family (reference
run_tests_HPROM.py): HPROM / HRNM / POD-RBF-HPROM / POD-GP-HPROM at the 3
canonical test points -> rom_results_hprom.npz.

    python -m finitedifference_tpu_torch.runners.run_tests_hprom
        [--device cpu] [--models hprom hrnm ...] [--num-cells 50]

Counterpart of runners/run_tests_hprom.py, as run_tests is of
runners/run_tests.py: the same models, keys and file, each point a fresh
runner process, --device in place of --platform.
"""

import os

import numpy as np

from finitedifference_tpu_torch.config import TEST_POINTS
from finitedifference_tpu_torch.runners.common import run_point_subproc
from finitedifference_tpu_torch.runners.run_tests import (
    common_args,
    driver_parser,
)

SCRIPT_BY_MODEL = {
    "hprom": ("run_hprom.py", ()),
    "hrnm": ("run_hrnm.py", ()),
    "pod_rbf_hprom": ("run_pod_rbf_hprom.py", ()),
    "pod_gp_hprom": ("run_pod_gp_hprom.py", ()),
    # kNN-RBF hyper-reduced variant (reference run_POD_RBF_HPROM*.py)
    "pod_rbf_hprom_knn": ("run_pod_rbf_hprom.py", ("--variant", "knn")),
    # ECM-weighted families (reference run_HPROM_ecm.py / run_HRNM_ecm.py)
    "hprom_ecm": ("run_hprom.py", ("--weights-method", "ecm")),
    "hrnm_ecm": ("run_hrnm.py", ("--weights-method", "ecm")),
    # device-FISTA-screened multilevel NNLS weights
    # (reference run_HPROM_ecsw_multilevel.py's joblib fan-out)
    "hprom_multilevel": ("run_hprom.py", ("--weights-method",
                                          "multilevel")),
    # sequential batched NNLS (fine run_HRNM_ecsw_joshua_sequential.py)
    "hprom_sequential": ("run_hprom.py", ("--weights-method",
                                          "sequential")),
}


def main(models=("hprom", "hrnm", "pod_rbf_hprom", "pod_gp_hprom"),
         out="rom_results_hprom.npz", num_cells=None, num_steps=None,
         f32=False, redo=False, device="cuda", retries=2):
    results = dict(np.load(out, allow_pickle=True)) \
        if os.path.exists(out) else {}
    if redo:
        stale = {f"{m}_{mu[0]}_{mu[1]}"
                 for m in models for mu in TEST_POINTS}
        results = {k: v for k, v in results.items() if k not in stale}
    common = common_args(num_cells, num_steps, f32, device)
    for mu in TEST_POINTS:
        for name in models:
            key = f"{name}_{mu[0]}_{mu[1]}"
            if key in results:
                print(f"skipping {key} (done)")
                continue
            print(f"=== {name} at mu = {mu} ===", flush=True)
            script, extra = SCRIPT_BY_MODEL[name]
            elapsed, err = run_point_subproc(script, mu, (*extra, *common),
                                             retries=retries)
            if elapsed is None:
                print(f"  {key} FAILED after retries; continuing")
                continue
            results[key] = np.array([elapsed, err])
            np.savez(out, **results)
    print(f"results accumulated in {out}")
    return results


if __name__ == "__main__":
    a = driver_parser(__doc__, ("hprom", "hrnm", "pod_rbf_hprom",
                                "pod_gp_hprom"),
                      "rom_results_hprom.npz").parse_args()
    main(tuple(a.models), a.out, a.num_cells, a.num_steps, a.f32,
         a.redo, a.device)
