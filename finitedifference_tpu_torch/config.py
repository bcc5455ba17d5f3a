"""Problem configuration.

The reference keeps its constants as module globals in
BurgersFD_CleanCoarse/config.py:8-27 (DT, NUM_STEPS, NUM_CELLS, ranges,
seeds) and then re-hardcodes many of them inside runners. Here there is a
single frozen dataclass; every runner and solver takes a config instance.

A copy of finitedifference_tpu/config.py: importing that module runs the
JAX package's __init__, which imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BurgersConfig:
    """Definition of the parameterized 2D inviscid Burgers HDM.

    Defaults mirror the reference coarse workbench
    (BurgersFD_CleanCoarse/config.py:19-27): 250x250 cells on (0,100)^2,
    dt=0.05, 500 implicit steps, mu1 in [4.25, 5.5], mu2 in [0.015, 0.03],
    a 3x3 training grid of (mu1, mu2) samples, w(x, 0) = 1.
    """

    num_cells_x: int = 250
    num_cells_y: int = 250
    x_low: float = 0.0
    x_up: float = 100.0
    y_low: float = 0.0
    y_up: float = 100.0
    dt: float = 0.05
    num_steps: int = 500

    mu1_range: Tuple[float, float] = (4.25, 5.5)
    mu2_range: Tuple[float, float] = (0.015, 0.03)
    samples_per_mu: int = 3

    # training hyper-parameters (reference config.py:8-10)
    batch_size: int = 16
    train_frac: float = 0.9
    seed: int = 1234557

    snap_folder: str = "param_snaps"

    @property
    def n_cells(self) -> int:
        return self.num_cells_x * self.num_cells_y

    @property
    def state_dim(self) -> int:
        """dim(w) = 2 * Nx * Ny: u and v stacked, each flattened x-fastest."""
        return 2 * self.n_cells

    def mu_samples(self):
        """The training grid of (mu1, mu2) points.

        Mirrors get_snapshot_params (reference train_autoencoder.py:63-72):
        a samples_per_mu x samples_per_mu tensor grid, mu1-major.
        """
        import numpy as np

        mu1s = np.linspace(*self.mu1_range, self.samples_per_mu)
        mu2s = np.linspace(*self.mu2_range, self.samples_per_mu)
        return [[float(m1), float(m2)] for m1 in mu1s for m2 in mu2s]

    @property
    def res_suffix(self) -> str:
        """'' at the DEFAULT resolution, else '_{nx}x{ny}'. Keyed off the
        dataclass defaults — not the current instance — so chained
        with_cells calls and runner artifact paths agree on what
        'canonical' means (ADVICE r2). One helper backs both the snapshot
        folder and runners.common.res_path."""
        base = type(self)()
        if (self.num_cells_x == base.num_cells_x
                and self.num_cells_y == base.num_cells_y):
            return ""
        return f"_{self.num_cells_x}x{self.num_cells_y}"

    def with_cells(self, n: int) -> "BurgersConfig":
        """Resolution variant. The reference keeps one directory tree per
        resolution (BurgersFD_CleanCoarse/Fine/TestAE), each with its own
        param_snaps/; here the snapshot cache moves to a per-resolution
        folder instead, so 250^2 and 750^2 trajectories for the same mu
        never collide on the filename-only protocol."""
        new = dataclasses.replace(self, num_cells_x=n, num_cells_y=n)
        folder = self.snap_folder
        if self.res_suffix and folder.endswith(self.res_suffix):
            folder = folder[: -len(self.res_suffix)]   # un-suffix first
        return dataclasses.replace(new, snap_folder=folder + new.res_suffix)


DEFAULT_CONFIG = BurgersConfig()

# The three canonical out-of-sample test points used by the reference's
# regression drivers (run_tests.py:9-10).
TEST_POINTS = ((5.19, 0.026), (4.56, 0.019), (4.75, 0.02))
