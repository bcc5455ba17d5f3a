"""(mu1, mu2) parameter sweep (the JAX runner's vmapped, device-sharded
sweep; the reference's equivalent is a serial loop over runners,
run_tests.py:38).

    python -m finitedifference_tpu_torch.runners.run_sweep [--device cpu]
        [--model fom|prom|hprom] [--no-shard]

With more than one visible card the batch is padded to a multiple of the
card count and sharded over one NCCL rank a card (parallel/mesh.spawn,
parallel/sweep's mesh=), as the JAX runner shards over len(jax.devices());
--no-shard runs it on one card. On one card, or with --device cpu, it runs
unsharded. After the timed run each point is compared with its cached FOM
trajectory in the snapshot folder, where there is one.
"""

import argparse
import os
import time

import numpy as np
import torch

from finitedifference_tpu_torch.device import to_host
from finitedifference_tpu_torch.parallel.mesh import (
    SPAWN_TIMEOUT,
    spawn,
    world_rank,
)
from finitedifference_tpu_torch.parallel.sweep import (
    make_sweep_mesh,
    pad_to_multiple,
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


def _sweep(mus, n_real, model, num_modes, cfg, f32, engine, dev,
           mesh=None, report=True):
    """The timed sweep of `mus` on `dev` (its block of the batch on each
    rank of `mesh`); prints the rate and the errors when `report`.
    Returns (seconds, the sweep's output)."""
    grid, w0 = make_problem(cfg)
    dtype = torch.float32 if f32 else torch.float64
    w0j = torch.as_tensor(w0, dtype=dtype, device=dev)
    basis = None            # the reduced models' full-state decoder
    if model == "fom":
        def run():
            return sweep_fom(grid, w0j, cfg.dt, cfg.num_steps, mus,
                             mesh=mesh, engine=engine,
                             snaps_dtype=torch.float32)
    else:
        basis_h = get_or_build_basis(cfg, grid, w0, num_modes, device=dev)
        basis = torch.as_tensor(basis_h, device=dev)
    if model == "hprom":
        weights = np.load(res_path(cfg, "ecsw_weights_lspg.npy"))
        smesh, sw, basis_aug = prepare_hprom(grid, weights, basis)
        y0 = torch.as_tensor(basis_h.T @ w0, dtype=dtype, device=dev)
        if report:
            print(f"N_e = {int((weights > 0).sum())}")

        def run():
            return sweep_hprom(grid, smesh, sw.to(dtype), y0,
                               basis_aug.to(dtype), cfg.dt, cfg.num_steps,
                               mus, mesh=mesh, **default_ls(dev))
    elif model == "prom":
        basis_d = basis.to(dtype)

        def run():
            return sweep_lspg(grid, w0j, cfg.dt, cfg.num_steps, mus,
                              basis_d, mesh=mesh, **default_ls(dev))

    if warm_enabled():
        float(run().sum())
    t0 = time.time()
    out = run()
    float(out.sum())          # waits for the device
    elapsed = time.time() - t0
    if not report:
        return elapsed, out
    total_steps = n_real * cfg.num_steps
    print(f"sweep wall-clock: {elapsed:.2f} s "
          f"({total_steps / elapsed:.1f} aggregate timesteps/s, "
          f"{elapsed / n_real:.3f} s/point)")

    for (m1, m2), traj in zip(mus[:n_real], out[:n_real]):
        fn = param_to_snap_fn([float(m1), float(m2)],
                              snap_folder=cfg.snap_folder)
        if not os.path.exists(fn):
            continue
        if basis is not None:
            traj = basis @ traj.to(basis.dtype)
        hdm = np.load(fn)[:, :cfg.num_steps + 1]
        print(f"point ({float(m1):.4g}, {float(m2):.4g}): error vs the "
              f"cached FOM {relative_error_pct(to_host(traj), hdm):.4f}%")
    return elapsed, out


def _sweep_rank(mus, n_real, model, num_modes, cfg, f32, engine):
    """One rank of the sharded sweep; rank 0 reports."""
    mesh = make_sweep_mesh()
    return _sweep(mus, n_real, model, num_modes, cfg, f32, engine,
                  mesh.device, mesh, report=world_rank() == 0)


def _run_sharded(n_ranks, mus, n_real, model, num_modes, cfg, f32, engine,
                 device="cuda", timeout=SPAWN_TIMEOUT):
    """The sweep over `n_ranks` ranks (parallel/mesh.spawn), one a card
    over NCCL (gloo ranks with device="cpu"): rank 0's (seconds, output
    on the CPU)."""
    return spawn(_sweep_rank, n_ranks, mus, n_real, model, num_modes, cfg,
                 f32, engine, device=device, timeout=timeout)


def main(n_mu1=3, n_mu2=3, model="fom", num_modes=95, num_cells=None,
         num_steps=None, f32=True, shard=True, engine="skewed",
         device="cuda"):
    dev = runner_device(device)
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; use one of {MODELS}")
    cfg = default_config(num_cells, num_steps)

    mu1s = np.linspace(*cfg.mu1_range, n_mu1)
    mu2s = np.linspace(*cfg.mu2_range, n_mu2)
    mus = np.array([[m1, m2] for m1 in mu1s for m2 in mu2s])
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    sharded = shard and n_dev > 1
    if sharded:
        mus, n_real = pad_to_multiple(mus, n_dev)
    else:
        n_real = mus.shape[0]
    print(f"sweep: {n_real} points ({mus.shape[0]} padded) on {n_dev} "
          f"device(s), model={model}", flush=True)
    if not sharded:
        return _sweep(mus, n_real, model, num_modes, cfg, f32, engine,
                      dev)[0]
    if model != "fom":
        # built (or checked) once here; the ranks load it
        grid, w0 = make_problem(cfg)
        get_or_build_basis(cfg, grid, w0, num_modes, device=dev)
    return _run_sharded(n_dev, mus, n_real, model, num_modes, cfg, f32,
                        engine)[0]


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
                   help="run on one card even when more are visible (one "
                        "card, or --device cpu, runs unsharded anyway)")
    p.add_argument("--engine", default="skewed",
                   choices=["standard", "skewed"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default: the CUDA device; fails "
                        "at once without one)")
    a = p.parse_args()
    main(a.n_mu1, a.n_mu2, a.model, a.num_modes, a.num_cells, a.num_steps,
         not a.f64, not a.no_shard, a.engine, a.device)
