"""FOM snapshot generation at one (mu1, mu2) (reference run_fom.py), on
the card (the skewed engine with the wavefront kernel) or, with
--device cpu, on the CPU (the standard engine).

    python -m finitedifference_tpu_torch.runners.run_fom [--device cpu]
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
from finitedifference_tpu_torch.runners.common import (
    base_parser,
    default_config,
    make_problem,
    runner_device,
    warm_enabled,
)
from finitedifference_tpu_torch.snapshots import param_to_snap_fn

ENGINES = ("standard", "skewed")


def main(mu1=4.75, mu2=0.02, num_cells=None, num_steps=None, f32=False,
         engine=None, device="cuda"):
    dev = runner_device(device)
    cfg = default_config(num_cells, num_steps)
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
    snaps = to_host(res.snaps)
    rate = cfg.num_steps / elapsed
    print(f"Elapsed FOM time: {elapsed:.3e} s "
          f"({rate:.2f} timesteps/s, {int(res.total_newton_its)} Newton its)")
    print("Relative error: 0.00%")   # protocol line of the report parsers

    fn = param_to_snap_fn([mu1, mu2], snap_folder=cfg.snap_folder)
    os.makedirs(cfg.snap_folder, exist_ok=True)
    np.save(fn, snaps)
    print(f"Saved {fn}")
    return elapsed, 0.0


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--engine", default=None, choices=list(ENGINES))
    args = p.parse_args()
    main(args.mu1, args.mu2, args.num_cells, args.num_steps, args.f32,
         args.engine, args.device)
