"""Regression/benchmark driver over the 3 canonical test points
(reference run_tests.py: FOM + PROM-family at (5.19,0.026), (4.56,0.019),
(4.75,0.02), accumulated into rom_results.npz, skip-if-done).

    python -m finitedifference_tpu_torch.runners.run_tests [--device cpu]
        [--models prom rnm pod_rbf pod_rbf_global] [--num-cells 50]

Counterpart of runners/run_tests.py: the same models, keys and file, each
point a fresh `python -m finitedifference_tpu_torch.runners.<runner>`
process (runners/common.run_point_subproc) under the --warm protocol,
with --device passed on in place of --platform.
"""

import argparse
import os

import numpy as np

from finitedifference_tpu_torch.config import TEST_POINTS
from finitedifference_tpu_torch.runners.common import run_point_subproc

SCRIPT_BY_MODEL = {
    "prom": ("run_prom.py", ()),
    "rnm": ("run_rnm.py", ()),
    "pod_rbf": ("run_pod_rbf.py", ()),
    # kNN-RBF with the repo's own (epsilon, k) grid search rather
    # than the reference's hardcoded eps=0.01, k=100
    "pod_rbf_searched": ("run_pod_rbf.py", ("--search",)),
    "pod_rbf_global": ("run_pod_rbf_global.py", ()),
}


def common_args(num_cells=None, num_steps=None, f32=False, device="cuda"):
    """The flags every point of a driver passes on to its runner."""
    common = ["--warm", "--device", device]
    if num_cells:
        common += ["--num-cells", str(num_cells)]
    if num_steps:
        common += ["--num-steps", str(num_steps)]
    if f32:
        common += ["--f32"]
    return common


def main(models=("prom", "rnm", "pod_rbf", "pod_rbf_global"),
         out="rom_results.npz", num_cells=None, num_steps=None,
         f32=False, redo=False, device="cuda", retries=2):
    """Pure orchestrator: every measurement (FOM included) runs in a
    fresh subprocess with the --warm protocol, so the recorded timings
    are warm-program wall-clocks."""
    results = dict(np.load(out, allow_pickle=True)) \
        if os.path.exists(out) else {}
    if redo:
        stale = {f"{m}_{mu[0]}_{mu[1]}"
                 for m in ("fom", *models) for mu in TEST_POINTS}
        results = {k: v for k, v in results.items() if k not in stale}
    common = common_args(num_cells, num_steps, f32, device)
    for mu in TEST_POINTS:
        key_fom = f"fom_{mu[0]}_{mu[1]}"
        if key_fom not in results or not np.isfinite(results[key_fom][0]):
            elapsed, _ = run_point_subproc("run_fom.py", mu, tuple(common),
                                           retries=retries)
            if elapsed is not None:
                results[key_fom] = np.array([elapsed, 0.0])
                np.savez(out, **results)
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


def driver_parser(desc, models, out):
    """The drivers' flags: the JAX drivers', --device in place of
    --platform."""
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--models", nargs="+", default=list(models))
    p.add_argument("--out", default=out)
    p.add_argument("--num-cells", type=int, default=None)
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--redo", action="store_true",
                   help="re-run the selected models even if recorded")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where each runner runs (default: the CUDA device)")
    return p


if __name__ == "__main__":
    a = driver_parser(__doc__, ("prom", "rnm", "pod_rbf", "pod_rbf_global"),
                      "rom_results.npz").parse_args()
    main(tuple(a.models), a.out, a.num_cells, a.num_steps, a.f32,
         a.redo, a.device)
