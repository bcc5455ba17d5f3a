"""Shared runner plumbing (PyTorch): device, basis build-or-load, reporting.

Counterpart of runners/common.py. Runners are thin argparse CLIs over the
library with the JAX runners' artifact protocol, so the two packages
read each other's files:
- basis{res_suffix}.npy and sigma{res_suffix}.npy (the POD basis and its
  singular values);
- ecsw_weights_lspg[_method]{res_suffix}.npy (the HPROM weight fields);
- param_snaps{res_suffix}/mu1_X+mu2_Y.npy (cached FOM trajectories);
- {prefix}_snaps_mu1_X_mu2_Y.npy (a runner's reconstructed trajectory).
Everything runs on the CUDA device unless the caller asks for the CPU
(`--device cpu`, `device="cpu"`); without a card, asking for it raises
at once (device.default_device). Precision is pinned when the package is
imported (precision.py), so there is no setup step.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from finitedifference_tpu_torch.config import DEFAULT_CONFIG
from finitedifference_tpu_torch.device import default_device
from finitedifference_tpu_torch.grid import grid_from_config
from finitedifference_tpu_torch.pod import pod
from finitedifference_tpu_torch.snapshots import (
    collect_snapshots,
    relative_error_pct,
)


def runner_device(device="cuda") -> torch.device:
    """The device a runner was asked for: "cuda" (the card; raises
    without one) or "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        default_device()
    elif dev.type != "cpu":
        raise ValueError(f"unknown device {device!r}; use 'cuda' or 'cpu'")
    return dev


def default_ls(device) -> dict:
    """Gauss-Newton least-squares kwargs for the device.

    On the card: normal equations (a Gram and a Cholesky solve) in the
    state's dtype — every LSPG system here is J@V = V + O(dt) with
    near-orthonormal V, so squaring the condition number costs a few
    digits of a very small number, and the H100 has FP64, so an f64 state
    keeps an f64 solve (the JAX package solves in f32 on a TPU, where f64
    QR was ~30x slower). On the CPU: tall-skinny QR in the run precision
    (reference-faithful), as in the JAX package."""
    if torch.device(device).type == "cpu":
        return {"ls_dtype": None, "ls_method": "qr"}
    return {"ls_dtype": None, "ls_method": "normal"}


def make_problem(cfg):
    """(grid, w0): the grid of `cfg` and the uniform initial state, a
    float64 host array as in the JAX runners."""
    grid = grid_from_config(cfg)
    w0 = np.ones(grid.state_dim)
    return grid, w0


def default_config(num_cells: int | None = None,
                   num_steps: int | None = None):
    cfg = DEFAULT_CONFIG
    if num_cells:
        cfg = cfg.with_cells(num_cells)
    if num_steps:
        cfg = dataclasses.replace(cfg, num_steps=num_steps)
    return cfg


def res_path(cfg, path: str) -> str:
    """Per-resolution artifact filename: 'x.npy' -> 'x_50x50.npy' at
    non-default resolutions, so a 12^2 model or weight file never
    shadows the 250^2 one (BurgersConfig.res_suffix)."""
    stem, ext = os.path.splitext(path)
    return f"{stem}{cfg.res_suffix}{ext}"


def get_or_build_basis(cfg, grid, w0, num_modes: int,
                       path: str = None, method: str = "rsvd",
                       load_basis: bool = True, device=None) -> np.ndarray:
    """basis.npy protocol (reference run_prom.py:44-120): load if present,
    else collect the 9 training trajectories, POD them, save the basis
    and its singular values. Non-default resolutions get their own file.

    The FOMs and the POD run on `device` (the CUDA device when None),
    whatever the size of the snapshot set: 9 x 501 x 125,000 float64
    values at 250^2 (4.5 GB) fit the card. Returns a float64 host array.
    """
    if path is None:
        path = res_path(cfg, "basis.npy")

    if load_basis and os.path.exists(path):
        full = np.load(path, allow_pickle=True)
        if full.shape[1] >= num_modes:
            return full[:, :num_modes]
        print(f"{path} has {full.shape[1]} modes < {num_modes}; rebuilding")

    device = default_device() if device is None else torch.device(device)
    w0 = torch.as_tensor(w0, device=device)
    snaps = collect_snapshots(cfg.mu_samples(), grid, w0, cfg.dt,
                              cfg.num_steps, snap_folder=cfg.snap_folder)
    t0 = time.time()
    snaps = torch.as_tensor(snaps, device=device)
    basis, sigma = pod(snaps, num_modes=num_modes, method=method,
                       random_state=cfg.seed)
    basis = sync(basis)
    print(f"POD ({method}, {num_modes} modes): {time.time() - t0:.3e} s")
    del snaps
    np.save(path, basis)
    np.save(path.replace("basis", "sigma"), sync(sigma))
    return basis


def report(name: str, rom_snaps, hdm_snaps, elapsed: float, mu,
           save_prefix: str | None = None):
    """Final error print + snapshot save, mirroring every reference
    runner's epilogue (e.g. run_prom.py:104-126)."""
    rom_snaps = sync(rom_snaps)
    rel = relative_error_pct(rom_snaps, sync(hdm_snaps))
    print(f"Elapsed {name} time: {elapsed:.3e} s")
    print(f"Relative error: {rel:.2f}%")
    if save_prefix:
        fn = f"{save_prefix}_snaps_mu1_{mu[0]:.2f}_mu2_{mu[1]:.3f}.npy"
        np.save(fn, rom_snaps)
        print(f"Snapshot saved as {fn}")
    return elapsed, rel


def sync(x):
    """A host NumPy array of x; a tensor on the card is waited for and
    copied."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def warm_enabled() -> bool:
    """Warm-timing protocol: run the online solve once untimed, then time
    a second run. Toggled by the runners' --warm flag via FDTPU_WARM,
    shared with the JAX runners, so drivers can set it uniformly across
    subprocesses."""
    return os.environ.get("FDTPU_WARM", "") == "1"


def base_parser(desc: str) -> argparse.ArgumentParser:
    """The JAX runners' common flags, with --device in place of
    --platform."""
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--mu1", type=float, default=5.19)
    p.add_argument("--mu2", type=float, default=0.026)
    p.add_argument("--num-cells", type=int, default=None)
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--f32", action="store_true",
                   help="run the online state in float32")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default: the CUDA device; fails "
                        "at once without one)")

    class _SetWarm(argparse.Action):
        def __call__(self, parser, ns, values, option_string=None):
            os.environ["FDTPU_WARM"] = "1"
            setattr(ns, self.dest, True)

    p.add_argument("--warm", nargs=0, default=False, action=_SetWarm,
                   help="warm-timing protocol: run once untimed, report "
                        "the second run's time")
    return p
