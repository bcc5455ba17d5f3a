"""Snapshot cache: the param -> file protocol (PyTorch).

Counterpart of finitedifference_tpu/snapshots.py, with the same file
names (`param_snaps/mu1_{v}+mu2_{v}.npy`, byte-identical to the
reference's, hypernet2D.py:3081-3145) and the same .npy layout
(2n, num_steps+1), so the two packages read each other's cache.
"""

from __future__ import annotations

import glob
import logging
import os
import time
from typing import Sequence

import numpy as np
import torch

from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.grid import Grid2D


def param_to_snap_fn(mu: Sequence[float], snap_folder: str = "param_snaps",
                     suffix: str = ".npy") -> str:
    """`param_snaps/mu1_{mu1}+mu2_{mu2}.npy` (reference hypernet2D.py:3081)."""
    parts = [f"mu{i + 1}_{m}" for i, m in enumerate(mu)]
    return os.path.join(snap_folder, "+".join(parts)) + suffix


def get_saved_params(snap_folder: str = "param_snaps") -> set:
    return set(glob.glob(os.path.join(snap_folder, "*")))


def _numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def load_or_compute_snaps(mu, grid: Grid2D, w0, dt, num_steps,
                          snap_folder: str = "param_snaps",
                          snaps_dtype=None) -> np.ndarray:
    """Load cached FOM snapshots, else run the implicit FOM and cache.

    Returns a (2n, num_steps+1) ndarray, float64 unless `snaps_dtype`
    (a torch or numpy dtype) narrows the *stored* trajectory; the Newton
    solve runs at w0's precision. The FOM runs where w0 lies: on a CUDA
    device the skewed engine with the wavefront kernel, on the CPU the
    plain implicit stepper. A cache shorter than num_steps is recomputed;
    a longer one is sliced.
    """
    from finitedifference_tpu_torch.fom import (
        inviscid_burgers_implicit2d,
        inviscid_burgers_implicit2d_skewed,
    )

    os.makedirs(snap_folder, exist_ok=True)
    snap_fn = param_to_snap_fn(mu, snap_folder=snap_folder)
    if snap_fn in get_saved_params(snap_folder=snap_folder):
        cached = np.load(snap_fn)
        if cached.shape[1] >= num_steps + 1:
            cached = cached[:, : num_steps + 1]
            expected = _numpy_dtype(snaps_dtype if snaps_dtype is not None
                                    else np.float64)
            if cached.dtype != expected:
                print(f"WARNING: cached snapshot {snap_fn} is "
                      f"{cached.dtype} but the caller expects "
                      f"{expected.name} — delete the file to recompute "
                      f"at full precision")
            return cached
        print(f"cached snapshot {snap_fn} has {cached.shape[1] - 1} steps "
              f"< requested {num_steps} — recomputing")

    w0 = as_tensor(w0)
    sd = snaps_dtype
    if sd is not None and not isinstance(sd, torch.dtype):
        sd = torch.from_numpy(np.zeros(0, np.dtype(sd))).dtype
    t0 = time.time()
    stepper = inviscid_burgers_implicit2d_skewed \
        if w0.device.type == "cuda" else inviscid_burgers_implicit2d
    res = stepper(grid, w0, float(dt), num_steps, float(mu[0]),
                  float(mu[1]), snaps_dtype=sd)
    snaps = res.snaps.cpu().numpy()
    print(f"Computed FOM snaps for mu1={mu[0]}, mu2={mu[1]} in "
          f"{time.time() - t0:.3e} s ({int(res.total_newton_its)} Newton its)")
    if res.max_final_relnorm is not None:
        worst = float(res.max_final_relnorm)
        # keyed on the stored snapshots' dtype, as the JAX package does
        cutoff = 1e-12 if snaps.dtype == np.float64 else 1e-6
        if worst > cutoff:
            print(f"WARNING: some Newton step exited unconverged "
                  f"(worst final relative residual {worst:.2e} > {cutoff:g})")
    # atomic publish: readers only ever see complete trajectories
    tmp_fn = f"{snap_fn}.tmp.{os.getpid()}.npy"
    np.save(tmp_fn, snaps)
    os.replace(tmp_fn, snap_fn)
    return snaps


def collect_snapshots(mu_list, grid: Grid2D, w0, dt, num_steps,
                      snap_folder: str = "param_snaps",
                      allow_missing: bool = False) -> np.ndarray:
    """Stack snapshot matrices for a list of mu points -> (2n, (T+1) * len).

    allow_missing=True skips points without a cached snapshot instead of
    computing them, and logs each to missing_snapshots.log."""
    cols = []
    for mu in mu_list:
        if allow_missing:
            fn = param_to_snap_fn(mu, snap_folder=snap_folder)
            if not os.path.exists(fn):
                logger = logging.getLogger(
                    "finitedifference_tpu_torch.snapshots")
                if not logger.handlers:
                    logger.addHandler(
                        logging.FileHandler("missing_snapshots.log"))
                    logger.setLevel(logging.WARNING)
                logger.warning("missing snapshot for mu=%s (%s)", mu, fn)
                print(f"warning: missing snapshot for mu={mu}; skipping")
                continue
        cols.append(load_or_compute_snaps(mu, grid, w0, dt, num_steps,
                                          snap_folder=snap_folder))
    if not cols:
        raise FileNotFoundError(
            f"no snapshots available in {snap_folder} for {mu_list}")
    return np.hstack(cols)


def compute_error(rom_snaps, hdm_snaps):
    """Per-timestep relative error + mean (reference hypernet2D.py:3074),
    including its normalisation by ||rom|| rather than ||hdm||."""
    sq_rom = np.sqrt(np.square(rom_snaps).sum(axis=0))
    sq_err = np.sqrt(np.square(rom_snaps - hdm_snaps).sum(axis=0))
    rel_err = sq_err / sq_rom
    return rel_err, rel_err.mean()


def relative_error_pct(rom_snaps, hdm_snaps) -> float:
    """The canonical end-to-end metric 100*||hdm-rom||_F/||hdm||_F."""
    return float(
        100.0 * np.linalg.norm(hdm_snaps - rom_snaps)
        / np.linalg.norm(hdm_snaps)
    )
