"""HPROM: LSPG on an ECSW/ECM sampled mesh (reference run_HPROM.py,
run_HPROM_ecsw_joshua.py, run_HPROM_ecm.py, run_HPROM_ecsw_multilevel.py
— selected by --weights-method).

Offline (--compute-ecsw): training matrix from the mu=(4.25, 0.0225)
trajectory (snapshots 3:T:10 vs 0:T-3:10) on the device, interior NNLS /
ECM weights with fixed boundary-ring weight bc_w=50, saved to
ecsw_weights_lspg.npy. Online: sampled-mesh Gauss-Newton LSPG.

    python -m finitedifference_tpu_torch.runners.run_hprom [--device cpu]
        [--compute-ecsw] [--weights-method nnls|scipy_nnls|ecm|multilevel|
        sequential] [--engine generic|tensor|factored|pallas]
"""

import os
import time

import numpy as np
import torch

from finitedifference_tpu_torch.device import resolve_device
from finitedifference_tpu_torch.ecsw import (
    compute_ecsw_weights,
    ecsw_training_matrix,
    multilevel_nnls_weights,
    sequential_nnls_weights,
)
from finitedifference_tpu_torch.rom import ecsw_hprom, prepare_hprom, \
    reconstruct
from finitedifference_tpu_torch.rom_factored import (
    factored_hprom,
    pallas_hprom,
    precompute_factored_blocks,
    precompute_pallas_system,
)
from finitedifference_tpu_torch.rom_tensor import (
    precompute_hprom_tensors,
    tensor_hprom,
)
from finitedifference_tpu_torch.runners.common import (
    base_parser,
    default_config,
    default_ls,
    get_or_build_basis,
    make_problem,
    report,
    res_path,
    runner_device,
    warm_enabled,
)
from finitedifference_tpu_torch.snapshots import load_or_compute_snaps

WEIGHTS_PATH = "ecsw_weights_lspg.npy"
WEIGHT_METHODS = ("nnls", "scipy_nnls", "ecm", "multilevel", "sequential")
ENGINES = ("generic", "tensor", "factored", "pallas")


def hprom_weights_path(cfg, weights_method: str) -> str:
    """Per-method weight artifact: the NNLS default keeps the historical
    `ecsw_weights_lspg.npy` name; every other method gets its own file so
    an ECM/multilevel/sequential run never silently reuses NNLS weights
    (the reference keeps one runner script — and one artifact — per
    method: run_HPROM_ecsw_joshua.py / run_HPROM_ecm.py / ...)."""
    stem = WEIGHTS_PATH if weights_method == "nnls" \
        else WEIGHTS_PATH.replace(".npy", f"_{weights_method}.npy")
    return res_path(cfg, stem)


def build_hprom_weights(cfg, grid, basis, weights_method, bc_w,
                        mu_train=(4.25, 0.0225), snap_stride=10,
                        verbose=False, device=None, **kw):
    """ECSW/ECM weight field for the linear HPROM from the reference's
    single training trajectory (snapshots 3:T:stride vs 0:T-3:stride,
    run_HPROM_ecsw_joshua.py:55-111). The training matrix is built on
    `device` (the CUDA device when None); the NNLS methods solve on the
    host, ECM sketches on the device, multilevel screens on the device."""
    device = resolve_device(device)
    snaps = load_or_compute_snaps(list(mu_train), grid,
                                  torch.ones(grid.state_dim,
                                             dtype=torch.float64,
                                             device=device),
                                  cfg.dt, cfg.num_steps,
                                  snap_folder=cfg.snap_folder)
    t = cfg.num_steps
    print(f"Generating ECSW training block for mu = {list(mu_train)}")
    snaps = torch.as_tensor(snaps, device=device)
    c = ecsw_training_matrix(
        grid, snaps[:, 3:t:snap_stride], snaps[:, 0:t - 3:snap_stride],
        torch.as_tensor(basis, device=device), mu_train[0], mu_train[1],
        cfg.dt)
    del snaps
    t0 = time.time()
    if weights_method == "multilevel":
        # level-1 support screening as ONE batched device FISTA (the
        # analogue of the reference's joblib fan-out,
        # run_HPROM_ecsw_multilevel.py:89-120)
        weights = multilevel_nnls_weights(c, grid, num_subdomains=12,
                                          bc_w=bc_w, level1="fista",
                                          rel_err_thresh=1e-4,
                                          verbose=verbose, **kw)
    elif weights_method == "sequential":
        weights = sequential_nnls_weights(c, grid, bc_w=bc_w,
                                          rel_err_thresh=1e-4,
                                          verbose=verbose, **kw)
    else:
        if weights_method == "ecm":
            # fixed-rank sketch: adaptive 1e-8 probes on the 250^2
            # (61k x 4.75k) training matrix are costly, and the cubature
            # must match the training residuals about as tightly as the
            # NNLS stop (1e-4): at 1e-2 the linear sampled Gauss-Newton
            # drifts (the JAX runner's defaults)
            kw.setdefault("ecm_rank", 800)
            kw.setdefault("ecm_tolerance", 1e-4)
        weights = compute_ecsw_weights(c, grid, bc_w=bc_w,
                                       method=weights_method,
                                       rel_err_thresh=1e-4,
                                       verbose=verbose, **kw)
    print(f"weight solve time: {time.time() - t0:.2f}s")
    return weights


def main(mu1=5.19, mu2=0.026, num_modes=95, compute_ecsw=False,
         weights_method="nnls", bc_w=50.0, num_cells=None, num_steps=None,
         f32=False, weights_path=None, engine="generic", gn_unroll=0,
         device="cuda"):
    dev = runner_device(device)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
    if weights_method not in WEIGHT_METHODS:
        raise ValueError(f"unknown weights method {weights_method!r}; use "
                         f"one of {WEIGHT_METHODS}")
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)
    if weights_path is None:
        weights_path = hprom_weights_path(cfg, weights_method)
    dtype = torch.float32 if f32 else torch.float64
    basis = get_or_build_basis(cfg, grid, w0, num_modes, device=dev)

    if compute_ecsw or not os.path.exists(weights_path):
        weights = build_hprom_weights(cfg, grid, basis, weights_method,
                                      bc_w, device=dev)
        np.save(weights_path, weights)
    else:
        weights = np.load(weights_path)
    print(f"N_e = {int((weights > 0).sum())}")

    basis_t = torch.as_tensor(basis, device=dev)
    mesh, sw, basis_aug = prepare_hprom(grid, weights, basis_t)
    y0 = torch.as_tensor(basis.T @ w0, dtype=dtype, device=dev)
    sw_d, ba_d = sw.to(dtype), basis_aug.to(dtype)

    if engine == "tensor":
        tens = precompute_hprom_tensors(grid, mesh, sw_d, ba_d, cfg.dt)

        def solve():
            return tensor_hprom(grid, mesh, sw_d, y0, tens, cfg.dt,
                                cfg.num_steps, mu1, mu2,
                                unroll_its=gn_unroll, ls_method="normal")
    elif engine == "factored":
        blocks = precompute_factored_blocks(mesh, ba_d)

        def solve():
            return factored_hprom(grid, mesh, sw_d, y0, blocks, cfg.dt,
                                  cfg.num_steps, mu1, mu2,
                                  unroll_its=gn_unroll, ls_method="normal")
    elif engine == "pallas":
        # one sampled Gauss-Newton system kernel call per iteration
        # (f32; csrc/gn_sampled.cu on the card)
        blocks = precompute_factored_blocks(mesh, ba_d)
        p6p, wgt_p = precompute_pallas_system(blocks, sw_d)

        def solve():
            return pallas_hprom(grid, mesh, p6p, wgt_p, y0, float(cfg.dt),
                                cfg.num_steps, mu1, mu2,
                                unroll_its=gn_unroll, ls_method="normal")
    else:
        ls_kw = default_ls(dev)

        def solve():
            return ecsw_hprom(grid, mesh, sw_d, y0, ba_d, cfg.dt,
                              cfg.num_steps, mu1, mu2, **ls_kw)

    def timed():
        res = solve()
        return res.red_coords.cpu(), res.total_gn_its

    # timed to the reduced coords on the host; the reconstruction stays
    # outside the timer (warm protocol)
    if warm_enabled():
        timed()
    t0 = time.time()
    red, total_its = timed()
    elapsed = time.time() - t0
    rom_snaps = reconstruct(basis_t, red.to(dev, torch.float64))
    print(f"Total GN iterations: {int(total_its)}")

    hdm = load_or_compute_snaps([mu1, mu2], grid,
                                torch.as_tensor(w0, device=dev), cfg.dt,
                                cfg.num_steps, snap_folder=cfg.snap_folder)
    prefix = "hprom" if weights_method == "nnls" \
        else f"hprom_{weights_method}"
    # suffix non-default resolutions so a 50^2/750^2 run never clobbers
    # the canonical 250^2 *_snaps_*.npy artifacts
    return report("HPROM", rom_snaps, hdm, elapsed, (mu1, mu2),
                  save_prefix=prefix + cfg.res_suffix)


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--num-modes", type=int, default=95)
    p.add_argument("--compute-ecsw", action="store_true")
    p.add_argument("--weights-method", default="nnls",
                   choices=list(WEIGHT_METHODS))
    p.add_argument("--bc-w", type=float, default=50.0)
    p.add_argument("--engine", default="generic", choices=list(ENGINES),
                   help="tensor: quadratic-form reduced-space stepper "
                        "(rom_tensor.py); factored: stencil-block stepper "
                        "(rom_factored.py); pallas: the factored system "
                        "in one kernel call per GN iteration")
    p.add_argument("--gn-unroll", type=int, default=0,
                   help="tensor/factored/pallas engines: fixed unrolled "
                        "GN iterations (0 keeps the dynamic loop)")
    a = p.parse_args()
    main(a.mu1, a.mu2, a.num_modes, a.compute_ecsw, a.weights_method,
         a.bc_w, a.num_cells, a.num_steps, a.f32, engine=a.engine,
         gn_unroll=a.gn_unroll, device=a.device)
