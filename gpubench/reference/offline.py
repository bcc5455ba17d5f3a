"""The offline model of a hyper-reduced configuration, made with plain code
of the benchmark's own: the training trajectories by the plain implicit
FOM (burgers.newton_trajectory), a POD basis by the method of snapshots,
and ECSW weights from the training matrix of one trajectory by the frozen
Lawson-Hanson NNLS (nnls.nnls_gram), the recipe of the reference's
run_HPROM_ecsw_joshua.py.

The model is a function of the configuration alone. `load_or_build`
keeps it in a directory named by a hash of the configuration's file, so
only the first run of a checkout builds it.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from gpubench.reference import burgers
from gpubench.reference.nnls import nnls_gram


def training_points(cfg: dict):
    """The samples x samples training grid of (mu1, mu2), mu1-major."""
    off = cfg["offline"]
    m1 = np.linspace(*cfg["mu1_range"], off["samples_per_mu"])
    m2 = np.linspace(*cfg["mu2_range"], off["samples_per_mu"])
    return [(float(a), float(b)) for a in m1 for b in m2]


def pod_basis(snaps, num_modes: int):
    """Leading left singular vectors of the snapshot rows `snaps` (m, N):
    the eigenvectors of the m x m Gram, mapped back and orthonormalised
    by one QR; each mode's largest entry is made positive."""
    gram = snaps @ snaps.T
    lam, vec = torch.linalg.eigh(gram)
    lam, vec = lam.flip(0)[:num_modes], vec.flip(1)[:, :num_modes]
    u = (snaps.T @ vec) / torch.sqrt(lam)[None, :]
    q, r = torch.linalg.qr(u)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    idx = torch.argmax(q.abs(), dim=0)
    return q * torch.sign(q[idx, torch.arange(num_modes)])[None, :]


def training_matrix(prob, snaps, prev, basis, mu):
    """C (pairs * k, n): for each snapshot pair and mode the cell-wise
    work r_u (J V)_u + r_v (J V)_v of the residual r(w; w_prev) at mu."""
    n, k = prob.n_cells, basis.shape[1]
    force = burgers.forcing(prob, [mu], basis.dtype, basis.device)
    bu = basis[:n].T.reshape(k, prob.ny, prob.nx)
    bv = basis[n:].T.reshape(k, prob.ny, prob.nx)
    hx = 0.5 * prob.dt / prob.dx
    hy = 0.5 * prob.dt / prob.dy
    rows = []
    for w, wp in zip(snaps, prev):
        u, v = w[:n].reshape(1, prob.ny, prob.nx), \
            w[n:].reshape(1, prob.ny, prob.nx)
        up, vp = wp[:n].reshape(1, prob.ny, prob.nx), \
            wp[n:].reshape(1, prob.ny, prob.nx)
        ru, rv = burgers.residual(u, v, up, vp, force, prob)
        uu = u * bu
        vv = v * bv
        cross = v * bu + u * bv
        ju = bu + hx * (uu - burgers._west(uu)) \
            + 0.5 * hy * (cross - burgers._south(cross))
        jv = bv + hy * (vv - burgers._south(vv)) \
            + 0.5 * hx * (cross - burgers._west(cross))
        rows.append((ju * ru + jv * rv).reshape(k, n))
    return torch.cat(rows)


def ring_mask(prob) -> np.ndarray:
    """True on the cells of the boundary ring, which take the fixed
    weight."""
    m = np.zeros((prob.ny, prob.nx), dtype=bool)
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = True
    return m.ravel()


def build(cfg: dict, device, log=print):
    """(basis (2n, k) float64, weights (n,) float64) as NumPy arrays."""
    prob = burgers.problem_from_config(cfg)
    off = cfg["offline"]
    steps = cfg["num_steps"]
    mus = training_points(cfg)
    t0 = time.perf_counter()
    snaps = torch.empty((len(mus), steps + 1, 2 * prob.n_cells),
                        dtype=torch.float64, device=device)

    def keep(i, u, v):
        snaps[:, i] = torch.cat((u.reshape(len(mus), -1),
                                 v.reshape(len(mus), -1)), 1)

    its = burgers.newton_trajectory(prob, mus, steps, dtype=torch.float64,
                                    device=device, cutoff=cfg["newton_cutoff"],
                                    on_step=keep)
    log(f"offline: {len(mus)} training trajectories, Newton its {its}, "
        f"{time.perf_counter() - t0:.1f} s")
    basis = pod_basis(snaps.reshape(-1, snaps.shape[-1]), off["num_modes"])
    log(f"offline: POD, {off['num_modes']} modes, "
        f"{time.perf_counter() - t0:.1f} s")
    near = np.argmin([abs(a - off["ecsw_mu"][0]) + abs(b - off["ecsw_mu"][1])
                      for a, b in mus])
    train = snaps[int(near)]
    del snaps
    lag, stride = off["ecsw_lag"], off["ecsw_stride"]
    c = training_matrix(prob, train[lag:steps:stride],
                        train[0:steps - lag:stride], basis,
                        tuple(off["ecsw_mu"]))
    del train
    ring = ring_mask(prob)
    ci = c[:, torch.as_tensor(~ring, device=device)].cpu().numpy()
    del c
    log(f"offline: training matrix {ci.shape}, "
        f"{time.perf_counter() - t0:.1f} s")
    w_int, _, _ = nnls_gram(ci, ci.sum(axis=1),
                            rel_err_thresh=off["nnls_rel_err"])
    weights = np.full(prob.n_cells, float(off["ring_weight"]))
    weights[~ring] = w_int
    log(f"offline: NNLS, {int((w_int > 0).sum())} interior cells, "
        f"{time.perf_counter() - t0:.1f} s")
    return basis.cpu().numpy(), weights


def cache_dir(root: str, name: str, cfg_path: str) -> str:
    with open(cfg_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(root, ".cache", f"{name}-{digest}")


def load_or_build(cfg: dict, directory: str, device):
    """The offline model from `directory`, built there first if absent.
    Returns (basis, weights) as float64 tensors on `device`."""
    paths = [os.path.join(directory, f) for f in ("basis.npy",
                                                  "weights.npy")]
    if not all(os.path.exists(p) for p in paths):
        os.makedirs(directory, exist_ok=True)
        arrays = build(cfg, device, log=lambda m: print(m, file=sys.stderr))
        for p, a in zip(paths, arrays):
            with open(p + ".part", "wb") as f:
                np.save(f, a)
            os.replace(p + ".part", p)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1)
    return tuple(torch.as_tensor(np.load(p), device=device) for p in paths)
