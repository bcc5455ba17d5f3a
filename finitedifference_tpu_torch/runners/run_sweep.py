"""(mu1, mu2) parameter sweep on one card (the JAX runner's vmapped,
device-sharded sweep; the reference's equivalent is a serial loop over
runners, run_tests.py:38).

    python -m finitedifference_tpu_torch.runners.run_sweep [--device cpu]
        [--model fom|prom|hprom]

The port runs on one card, so there is no device mesh: --no-shard is
accepted and changes nothing, as the JAX runner shards only over more
than one device. After the timed run each point is compared with its
cached FOM trajectory in the snapshot folder, where there is one.
"""

import argparse
import os
import time

import numpy as np
import torch

from finitedifference_tpu_torch.device import to_host
from finitedifference_tpu_torch.parallel.sweep import (
    sweep_fom,
    sweep_hprom,
    sweep_lspg,
)
from finitedifference_tpu_torch.rom import prepare_hprom
from finitedifference_tpu_torch.runners.common import (
    default_config,
    default_ls,
    get_or_build_basis,
    make_problem,
    res_path,
    runner_device,
    warm_enabled,
)
from finitedifference_tpu_torch.snapshots import (
    param_to_snap_fn,
    relative_error_pct,
)

MODELS = ("fom", "prom", "hprom")


def main(n_mu1=3, n_mu2=3, model="fom", num_modes=95, num_cells=None,
         num_steps=None, f32=True, shard=True, engine="skewed",
         device="cuda"):
    dev = runner_device(device)
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; use one of {MODELS}")
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)
    dtype = torch.float32 if f32 else torch.float64

    mu1s = np.linspace(*cfg.mu1_range, n_mu1)
    mu2s = np.linspace(*cfg.mu2_range, n_mu2)
    mus = np.array([[m1, m2] for m1 in mu1s for m2 in mu2s])
    n_real = mus.shape[0]
    print(f"sweep: {n_real} points ({mus.shape[0]} padded) on 1 "
          f"device(s), model={model}")

    w0j = torch.as_tensor(w0, dtype=dtype, device=dev)
    basis = None            # the reduced models' full-state decoder
    if model == "fom":
        def run():
            return sweep_fom(grid, w0j, cfg.dt, cfg.num_steps, mus,
                             engine=engine, snaps_dtype=torch.float32)
    else:
        basis_h = get_or_build_basis(cfg, grid, w0, num_modes, device=dev)
        basis = torch.as_tensor(basis_h, device=dev)
    if model == "hprom":
        weights = np.load(res_path(cfg, "ecsw_weights_lspg.npy"))
        smesh, sw, basis_aug = prepare_hprom(grid, weights, basis)
        y0 = torch.as_tensor(basis_h.T @ w0, dtype=dtype, device=dev)
        print(f"N_e = {int((weights > 0).sum())}")

        def run():
            return sweep_hprom(grid, smesh, sw.to(dtype), y0,
                               basis_aug.to(dtype), cfg.dt, cfg.num_steps,
                               mus, **default_ls(dev))
    elif model == "prom":
        basis_d = basis.to(dtype)

        def run():
            return sweep_lspg(grid, w0j, cfg.dt, cfg.num_steps, mus,
                              basis_d, **default_ls(dev))

    if warm_enabled():
        float(run().sum())
    t0 = time.time()
    out = run()
    float(out.sum())          # waits for the device
    elapsed = time.time() - t0
    total_steps = n_real * cfg.num_steps
    print(f"sweep wall-clock: {elapsed:.2f} s "
          f"({total_steps / elapsed:.1f} aggregate timesteps/s, "
          f"{elapsed / n_real:.3f} s/point)")

    for (m1, m2), traj in zip(mus, out):
        fn = param_to_snap_fn([float(m1), float(m2)],
                              snap_folder=cfg.snap_folder)
        if not os.path.exists(fn):
            continue
        if basis is not None:
            traj = basis @ traj.to(basis.dtype)
        hdm = np.load(fn)[:, :cfg.num_steps + 1]
        print(f"point ({float(m1):.4g}, {float(m2):.4g}): error vs the "
              f"cached FOM {relative_error_pct(to_host(traj), hdm):.4f}%")
    return elapsed


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-mu1", type=int, default=3)
    p.add_argument("--n-mu2", type=int, default=3)
    p.add_argument("--model", default="fom", choices=list(MODELS))
    p.add_argument("--num-modes", type=int, default=95)
    p.add_argument("--num-cells", type=int, default=None)
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--no-shard", action="store_true",
                   help="accepted for the JAX runner's flags; one card "
                        "runs unsharded either way")
    p.add_argument("--engine", default="skewed",
                   choices=["standard", "skewed"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default: the CUDA device; fails "
                        "at once without one)")
    a = p.parse_args()
    main(a.n_mu1, a.n_mu2, a.model, a.num_modes, a.num_cells, a.num_steps,
         not a.f64, not a.no_shard, a.engine, a.device)
