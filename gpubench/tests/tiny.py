"""A tiny benchmark written to a temporary directory: configurations,
traffic mixes and a spec at CPU-test sizes, found by the harness in the
directory's place of the real ones."""

import json
import os

from gpubench.harness import HERE, Bench

FINE = {
    "name": "tiny_fine", "num_cells": 16, "domain": [0.0, 100.0, 0.0, 100.0],
    "dt": 0.05, "num_steps": 6, "mu1_range": [4.25, 5.5],
    "mu2_range": [0.015, 0.03], "w0": 1.0, "newton_cutoff": 1e-12,
    "newton_max_its": 100, "state_dtype": "float64",
    "snaps_dtype": "float64",
}
COARSE = {
    "name": "tiny_coarse", "num_cells": 12, "domain": [0.0, 100.0, 0.0, 100.0],
    "dt": 0.05, "num_steps": 8, "mu1_range": [4.25, 5.5],
    "mu2_range": [0.015, 0.03], "w0": 1.0, "newton_cutoff": 1e-12,
    "state_dtype": "float64",
    "offline": {"samples_per_mu": 3, "num_modes": 6,
                "ecsw_mu": [4.25, 0.0225], "ecsw_lag": 3, "ecsw_stride": 2,
                "ring_weight": 50.0, "nnls_rel_err": 0.0001},
    "gauss_newton": {"relnorm_cutoff": 1e-5, "min_delta": 0.1,
                     "unroll_its": 3, "solve_iters": 24},
}


FOM_LIMITS = {"state_err": 1e-6, "step_res": 1e-6, "newton_gap": 0.05}


def fom_traffic(seg=0, overlap=0, limits=FOM_LIMITS):
    return {"driver": "fom_trajectory", "loop": "closed", "clients": 1,
            "points_per_request": 1, "strata": 4,
            "trace_requests": 1, "check": {"sample": 1, "among_first": 2},
            "solver": {"seg": seg, "seg_overlap": overlap,
                       "diag_block": 4},
            "limits": dict(limits)}


def hprom_traffic(limits=(1e-6, 0.05)):
    return {"driver": "hprom_trajectory", "loop": "closed", "clients": 1,
            "points_per_request": 3, "strata": 3,
            "trace_requests": 2, "check": {"sample": 1, "among_first": 2},
            "limits": {"red_err": limits[0]}}


def write(root, fom_limits=FOM_LIMITS, hprom_limits=(1e-6, 0.05)):
    """Writes the tiny benchmark under `root`; returns (spec, bench)."""
    for kind in ("configs", "workloads"):
        os.makedirs(os.path.join(root, kind), exist_ok=True)

    def put(kind, name, obj):
        with open(os.path.join(root, kind, name + ".json"), "w") as f:
            json.dump(obj, f)

    put("configs", "tiny_fine", FINE)
    put("configs", "tiny_coarse", COARSE)
    put("workloads", "tiny_exact", fom_traffic(limits=fom_limits))
    put("workloads", "tiny_seg", fom_traffic(3, 2, limits=fom_limits))
    put("workloads", "tiny_hprom", hprom_traffic(hprom_limits))
    with open(os.path.join(HERE, os.pardir, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"] = [
        {"name": "tiny_exact", "config": "tiny_fine",
         "traffic": "tiny_exact", "chips": 1, "why": "test"},
        {"name": "tiny_seg", "config": "tiny_fine", "traffic": "tiny_seg",
         "chips": 1, "why": "test"},
        {"name": "tiny_hprom", "config": "tiny_coarse",
         "traffic": "tiny_hprom", "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    return spec, Bench([root, HERE])
