"""The offline model of a full-grid PROM configuration: a POD basis alone,
made with plain code of the benchmark's own (no ECSW weights, which the
PROM does not use): the training trajectories by the plain implicit FOM
(burgers.newton_trajectory) in float64 over the training grid
(offline.training_points), then the method of snapshots
(offline.pod_basis).

The basis is a function of the configuration alone. `load_or_build`
keeps it in a directory named by a hash of the configuration's file
(offline.cache_dir), so only the first run of a checkout builds it.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from gpubench.reference import burgers, offline


def build(cfg: dict, device, log=print) -> np.ndarray:
    """The (2n, k) float64 POD basis as a NumPy array."""
    prob = burgers.problem_from_config(cfg)
    steps = cfg["num_steps"]
    mus = offline.training_points(cfg)
    t0 = time.perf_counter()
    snaps = torch.empty((len(mus), steps + 1, 2 * prob.n_cells),
                        dtype=torch.float64, device=device)

    def keep(i, u, v):
        snaps[:, i] = torch.cat((u.reshape(len(mus), -1),
                                 v.reshape(len(mus), -1)), 1)

    its = burgers.newton_trajectory(prob, mus, steps, dtype=torch.float64,
                                    device=device, cutoff=cfg["newton_cutoff"],
                                    max_its=cfg["newton_max_its"],
                                    on_step=keep)
    log(f"offline: {len(mus)} training trajectories, Newton its {its}, "
        f"{time.perf_counter() - t0:.1f} s")
    num_modes = cfg["offline"]["num_modes"]
    basis = offline.pod_basis(snaps.reshape(-1, snaps.shape[-1]), num_modes)
    del snaps
    log(f"offline: POD, {num_modes} modes, "
        f"{time.perf_counter() - t0:.1f} s")
    return basis.cpu().numpy()


def load_or_build(cfg: dict, directory: str, device):
    """The basis from `directory`, built there first if absent, as a
    float64 tensor on `device`."""
    path = os.path.join(directory, "basis.npy")
    if not os.path.exists(path):
        os.makedirs(directory, exist_ok=True)
        basis = build(cfg, device, log=lambda m: print(m, file=sys.stderr))
        with open(path + ".part", "wb") as f:
            np.save(f, basis)
        os.replace(path + ".part", path)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
    return torch.as_tensor(np.load(path), device=device)
