"""LSPG PROM with a global POD basis (reference run_prom.py): 95-mode
rSVD basis from the 9 training trajectories, Gauss-Newton LSPG at an
out-of-sample (mu1, mu2), error vs the cached FOM.

    python -m finitedifference_tpu_torch.runners.run_prom [--device cpu]
        [--engine generic|pallas [--unroll-its N]]
"""

import time

import torch

from finitedifference_tpu_torch.rom import lspg_prom, reconstruct
from finitedifference_tpu_torch.rom_factored import (
    pallas_prom,
    precompute_prom_pallas,
)
from finitedifference_tpu_torch.runners.common import (
    base_parser,
    default_config,
    default_ls,
    get_or_build_basis,
    make_problem,
    report,
    runner_device,
    warm_enabled,
)
from finitedifference_tpu_torch.snapshots import load_or_compute_snaps

ENGINES = ("generic", "pallas")


def main(mu1=4.75, mu2=0.02, num_modes=95, load_basis=True,
         num_cells=None, num_steps=None, f32=False, engine="generic",
         device="cuda", unroll_its=0):
    dev = runner_device(device)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
    if unroll_its and engine != "pallas":
        raise ValueError("--unroll-its runs the pallas engine's masked "
                         "Gauss-Newton loop; add --engine pallas")
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)
    dtype = torch.float32 if f32 else torch.float64

    basis = get_or_build_basis(cfg, grid, w0, num_modes,
                               load_basis=load_basis, device=dev)
    print(f"Running ROM of size {num_modes} for mu1={mu1}, mu2={mu2}")

    w0_d = torch.as_tensor(w0, dtype=dtype, device=dev)
    basis_d = torch.as_tensor(basis, dtype=dtype, device=dev)

    if engine == "pallas":
        # the streaming full-grid Gauss-Newton engine (f32; csrc/gn_full.cu
        # on the card): one pass over the basis per GN iteration; with
        # unroll_its > 0, that many masked iterations a step and no
        # read-back until the end of the trajectory
        vu_p, vv_p, dmask, tile_rows = precompute_prom_pallas(
            grid, torch.as_tensor(basis, device=dev))
        y0 = torch.as_tensor(basis.T @ w0, dtype=torch.float32, device=dev)

        def solve():
            return pallas_prom(grid, vu_p, vv_p, dmask, y0, float(cfg.dt),
                               cfg.num_steps, mu1, mu2, tile_rows=tile_rows,
                               unroll_its=unroll_its)
    else:
        ls_kw = default_ls(dev)

        def solve():
            return lspg_prom(grid, w0_d, cfg.dt, cfg.num_steps, mu1, mu2,
                             basis_d, **ls_kw)

    def timed():
        res = solve()
        return res.red_coords.cpu(), res.total_gn_its

    # timed to the reduced coords on the host; the reconstruction below
    # stays outside the timer (warm protocol)
    if warm_enabled():
        timed()
    t0 = time.time()
    red, total_its = timed()
    elapsed = time.time() - t0
    rom_snaps = reconstruct(basis_d, red.to(dev, dtype))
    print(f"Total GN iterations: {int(total_its)}")

    hdm = load_or_compute_snaps([mu1, mu2], grid,
                                torch.as_tensor(w0, device=dev), cfg.dt,
                                cfg.num_steps, snap_folder=cfg.snap_folder)
    return report("ROM", rom_snaps, hdm, elapsed, (mu1, mu2),
                  save_prefix="rom" + cfg.res_suffix)


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--num-modes", type=int, default=95)
    p.add_argument("--no-load-basis", action="store_true")
    p.add_argument("--engine", default="generic", choices=list(ENGINES),
                   help="pallas = the streaming full-grid Gauss-Newton "
                        "engine (f32; the gn_full kernel on the card)")
    p.add_argument("--unroll-its", type=int, default=0,
                   help="with --engine pallas: N masked Gauss-Newton "
                        "iterations a step (the first included) and one "
                        "read-back a trajectory; 0 (default) stops each "
                        "step by the reference's rules, reading back once "
                        "an iteration")
    a = p.parse_args()
    main(a.mu1, a.mu2, a.num_modes, not a.no_load_basis,
         a.num_cells, a.num_steps, a.f32, a.engine, a.device, a.unroll_its)
