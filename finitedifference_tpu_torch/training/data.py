"""Snapshot dataset utilities (PyTorch package).

Counterpart of finitedifference_tpu/training/data.py (the reference's
train_utils.py:87-127): the training μ grid, a row-wise random split and
the aggregated training snapshot matrix. Host NumPy, as in the JAX
package; the FOMs behind an uncached snapshot run where w0 lies
(snapshots.load_or_compute_snaps: a host array goes to the card).
"""

from __future__ import annotations

import numpy as np

from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.snapshots import load_or_compute_snaps


def get_snapshot_params(cfg):
    """The 3x3 (mu1, mu2) training grid (reference
    train_autoencoder.py:63-72)."""
    return cfg.mu_samples()


def random_split(data: np.ndarray, frac: float, rng: np.random.Generator):
    """Row-wise random split (reference train_utils.py:87-95)."""
    n = data.shape[0]
    num1 = int(n * frac)
    perm = rng.permutation(n)
    shuffled = data[perm]
    return shuffled[:num1], shuffled[num1:]


def load_training_data(cfg, grid: Grid2D, w0, *, subtract_ref: bool = True,
                       snap_folder: str | None = None):
    """Aggregate the 9 training trajectories into a sample matrix.

    Returns (snaps_T, ref): snaps_T is (n_samples, 2n) with the reference
    state (first snapshot) optionally subtracted — the centering used by
    the reference AE/RNM training (train_utils.py:118-127, which also
    drops each trajectory's final column).
    """
    folder = snap_folder or cfg.snap_folder
    cols = []
    for mu in cfg.mu_samples():
        s = load_or_compute_snaps(mu, grid, w0, cfg.dt, cfg.num_steps,
                                  snap_folder=folder)
        cols.append(s[:, :-1])
    snaps = np.hstack(cols)
    ref = snaps[:, 0].copy()
    if subtract_ref:
        snaps = snaps - ref[:, None]
    return snaps.T, ref
