"""FOM snapshot generation at one (mu1, mu2) (reference run_fom.py), on
the card (the skewed engine with the wavefront kernel) or, with
--device cpu, on the CPU (the standard engine).

    python -m finitedifference_tpu_torch.runners.run_fom [--device cpu]
        [--spatial-shard N]

--spatial-shard N runs the skewed engine with its grid rows sharded over
N ranks (parallel/spatial.sharded_skewed_fom): on the card one rank a
card over NCCL, so N may not exceed the visible cards; with --device cpu
N gloo ranks on the CPU. Rank 0 prints the protocol lines and saves the
snapshots.
"""

import os
import time

import numpy as np
import torch

from finitedifference_tpu_torch.device import to_host
from finitedifference_tpu_torch.fom import (
    inviscid_burgers_implicit2d,
    inviscid_burgers_implicit2d_skewed,
)
from finitedifference_tpu_torch.parallel.mesh import (
    make_mesh,
    spawn,
    world_rank,
)
from finitedifference_tpu_torch.parallel.spatial import sharded_skewed_fom
from finitedifference_tpu_torch.runners.common import (
    base_parser,
    default_config,
    make_problem,
    runner_device,
    warm_enabled,
)
from finitedifference_tpu_torch.snapshots import param_to_snap_fn

ENGINES = ("standard", "skewed")


def _sharded_rank(mu1, mu2, cfg, f32, n):
    """One rank of --spatial-shard: the timed sharded trajectory; rank 0
    reports and saves it."""
    mesh = make_mesh((n,), ("sp",))
    grid, w0 = make_problem(cfg)
    dtype = torch.float32 if f32 else torch.float64
    w0_d = torch.as_tensor(w0, dtype=dtype, device=mesh.device)

    def solve():
        snaps, its = sharded_skewed_fom(mesh, grid, w0_d, float(cfg.dt),
                                        cfg.num_steps, mu1, mu2)
        float(snaps.sum())   # waits for the device
        return snaps, its

    if warm_enabled():
        solve()
    t0 = time.time()
    snaps, its = solve()
    elapsed = time.time() - t0
    if world_rank() == 0:
        _report(cfg, mu1, mu2, elapsed, its, to_host(snaps))
    return elapsed


def _report(cfg, mu1, mu2, elapsed, its, snaps):
    rate = cfg.num_steps / elapsed
    print(f"Elapsed FOM time: {elapsed:.3e} s "
          f"({rate:.2f} timesteps/s, {int(its)} Newton its)")
    print("Relative error: 0.00%")   # protocol line of the report parsers

    fn = param_to_snap_fn([mu1, mu2], snap_folder=cfg.snap_folder)
    os.makedirs(cfg.snap_folder, exist_ok=True)
    np.save(fn, snaps)
    print(f"Saved {fn}", flush=True)


def main(mu1=4.75, mu2=0.02, num_cells=None, num_steps=None, f32=False,
         engine=None, device="cuda", spatial_shard=0):
    cfg = default_config(num_cells, num_steps)
    if spatial_shard:
        dev_type = torch.device(device).type
        n_cards = torch.cuda.device_count()
        if dev_type == "cuda" and spatial_shard > n_cards:
            raise SystemExit(
                f"--spatial-shard {spatial_shard}: only {n_cards} CUDA "
                f"devices visible (NCCL runs one rank a card; --device cpu "
                f"runs {spatial_shard} gloo ranks on the CPU)")
        runner_device(device)
        print(f"spatial sharding: {spatial_shard}-way row shards "
              f"({'nccl' if dev_type == 'cuda' else 'gloo'}, {dev_type})",
              flush=True)
        elapsed = spawn(_sharded_rank, spatial_shard, mu1, mu2, cfg, f32,
                        spatial_shard, device=dev_type)
        return elapsed, 0.0
    dev = runner_device(device)
    grid, w0 = make_problem(cfg)
    dtype = torch.float32 if f32 else torch.float64
    if engine is None:
        engine = "skewed" if dev.type == "cuda" else "standard"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
    w0_d = torch.as_tensor(w0, dtype=dtype, device=dev)

    def solve():
        if engine == "skewed":
            res = inviscid_burgers_implicit2d_skewed(
                grid, w0_d, float(cfg.dt), cfg.num_steps, mu1, mu2)
        else:
            res = inviscid_burgers_implicit2d(
                grid, w0_d, cfg.dt, cfg.num_steps, mu1, mu2)
        float(res.snaps.sum())   # waits for the device
        return res

    if warm_enabled():
        solve()
    t0 = time.time()
    res = solve()
    elapsed = time.time() - t0
    _report(cfg, mu1, mu2, elapsed, res.total_newton_its,
            to_host(res.snaps))
    return elapsed, 0.0


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--engine", default=None, choices=list(ENGINES))
    p.add_argument("--spatial-shard", type=int, default=0, metavar="N",
                   help="run the skewed engine with its rows sharded over "
                        "N ranks: one a card over NCCL, or N gloo ranks "
                        "with --device cpu")
    args = p.parse_args()
    main(args.mu1, args.mu2, args.num_cells, args.num_steps, args.f32,
         args.engine, args.device, args.spatial_shard)
