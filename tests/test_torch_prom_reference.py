"""The benchmark's plain full-grid LSPG reference (gpubench/reference/
prom.py) and its basis-only offline build (gpubench/reference/
pod_offline.py) on the CPU, and the port's full-grid PROM engine
(rom_factored.pallas_prom, the plain version of its system on the CPU)
held against the reference.

Tolerances, each from where its error comes from:
- the reference against the NumPy oracle (scipy's sparse Jacobian,
  numpy's lstsq), both float64 and both least squares: 1e-10 relative,
  rounding of two orders of operations; equal Gauss-Newton counts.
- pallas_prom in float64 against the reference: the normal equations by
  Cholesky against lstsq by QR, both float64, differ by the Gram's
  condition number times the float64 epsilon: 1e-12 per step's reduced
  coordinates (2.7e-16 - 5.3e-16 read); equal counts.
- pallas_prom in float32 against the float64 reference: float32 basis
  rows and products (the Gram reduced in float64), 5e-6 per step
  (1.6e-7 - 4.5e-7 read); equal counts, since no stop decision here lies
  within float32 rounding of its threshold.
- unroll_its 3 agrees with the unmasked reference while no step takes a
  fourth update, which the test checks of the reference first.
"""

import collections
import os

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch import rom_factored as rf
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.runners import run_prom as trun_prom
from gpubench.reference import burgers, offline, pod_offline, prom

import oracle  # noqa: E402  (tests/, on the path under pytest)
import oracle_rom  # noqa: E402

F32, F64 = torch.float32, torch.float64
DT = 0.05
CFG = {"name": "tiny_prom", "num_cells": 24,
       "domain": [0.0, 100.0, 0.0, 100.0], "dt": DT, "num_steps": 20,
       "mu1_range": [4.25, 5.5], "mu2_range": [0.015, 0.03], "w0": 1.0,
       "newton_cutoff": 1e-12, "newton_max_its": 100,
       "offline": {"samples_per_mu": 3, "num_modes": 8}}
GN = dict(max_its=20, relnorm_cutoff=1e-5, min_delta=0.1)


def rel_steps(got, want):
    """The largest relative 2-norm error of a step's reduced coordinates."""
    got, want = got.to(F64), want.to(F64)
    return float((torch.linalg.vector_norm(got - want, dim=0)
                  / torch.linalg.vector_norm(want, dim=0)).max())


@pytest.fixture(scope="module")
def basis():
    """8 POD modes of the 3x3 training trajectories at 24^2, 20 steps."""
    return torch.as_tensor(pod_offline.build(CFG, "cpu", log=lambda m: None))


@pytest.fixture(scope="module")
def mus():
    """Three out-of-sample points of the box, from a seed."""
    rng = np.random.default_rng(20)
    lo, hi = np.array([4.25, 0.015]), np.array([5.5, 0.03])
    return [tuple(float(x) for x in lo + rng.uniform(size=2) * (hi - lo))
            for _ in range(3)]


def reference(basis, mu, steps=CFG["num_steps"]):
    prob = burgers.problem_from_config(CFG)
    return prom.lspg_trajectory(prob, basis, mu, steps,
                                max_its=GN["max_its"],
                                cutoff=GN["relnorm_cutoff"],
                                min_delta=GN["min_delta"])


def test_the_reference_matches_the_numpy_oracle():
    """On a 10 x 8 grid (x and y told apart), 5 modes of one FOM
    trajectory: the same reduced trajectory and Gauss-Newton count."""
    nx, ny, steps, k, mu = 10, 8, 8, 5, (4.9, 0.021)
    ops, xc = oracle.make_problem(nx=nx, ny=ny)
    w0 = np.ones(2 * nx * ny)
    snaps = oracle.implicit_trajectory(w0, [4.5, 0.025], DT, 12, ops, xc)
    v = np.linalg.svd(snaps, full_matrices=False)[0][:, :k]
    want, want_its = oracle_rom.lspg_trajectory(w0, list(mu), DT, steps,
                                                ops, xc, v)
    prob = burgers.Problem(nx=nx, ny=ny, dt=DT)
    got, its = prom.lspg_trajectory(prob, torch.as_tensor(v), mu, steps)
    assert rel_steps(got, torch.as_tensor(want)) < 1e-10
    assert int(its.sum()) == want_its
    assert its.shape == (steps,) and int(its.min()) >= 1


def test_the_basis_only_build_is_the_pod_of_the_training_trajectories(
        tmp_path, basis):
    """pod_offline.build: offline.pod_basis of the plain FOM's float64
    trajectories at offline.training_points; load_or_build caches it."""
    prob = burgers.problem_from_config(CFG)
    mus = offline.training_points(CFG)
    rows = []
    burgers.newton_trajectory(
        prob, mus, CFG["num_steps"], dtype=F64, device="cpu",
        cutoff=CFG["newton_cutoff"],
        on_step=lambda i, u, v: rows.append(torch.cat(
            (u.reshape(len(mus), -1), v.reshape(len(mus), -1)), 1)))
    snaps = torch.stack(rows, 1).reshape(-1, 2 * prob.n_cells)
    want = offline.pod_basis(snaps, CFG["offline"]["num_modes"])
    assert torch.equal(basis, want)
    assert torch.allclose(basis.T @ basis, torch.eye(8, dtype=F64),
                          atol=1e-12)
    d = str(tmp_path / "cache")
    first = pod_offline.load_or_build(CFG, d, "cpu")
    assert os.path.exists(os.path.join(d, "basis.npy"))
    assert torch.equal(first, want)
    assert torch.equal(pod_offline.load_or_build(CFG, d, "cpu"), want)


@pytest.mark.parametrize("dtype,unroll_its,tol", [
    (F64, 0, 1e-12), (F64, 3, 1e-12), (F32, 0, 5e-6), (F32, 3, 5e-6)],
    ids=["f64-exact", "f64-unroll3", "f32-exact", "f32-unroll3"])
def test_pallas_prom_matches_the_reference(basis, mus, dtype, unroll_its,
                                           tol):
    grid = Grid2D(nx=24, ny=24, x_up=100.0, y_up=100.0)
    vu_p, vv_p, dmask, tr = rf.precompute_prom_pallas(grid, basis,
                                                      dtype=dtype)
    y0 = (basis.T @ torch.ones(basis.shape[0], dtype=F64)).to(dtype)
    steps = CFG["num_steps"]
    for mu in mus:
        want, want_its = reference(basis, mu)
        if unroll_its:
            assert int(want_its.max()) <= unroll_its
        got = rf.pallas_prom(grid, vu_p, vv_p, dmask, y0, DT, steps, *mu,
                             unroll_its=unroll_its, tile_rows=tr, **GN)
        assert got.red_coords.dtype == dtype
        assert rel_steps(got.red_coords, want) < tol, mu
        assert got.total_gn_its == int(want_its.sum())
        assert got.max_step_its == int(want_its.max())
        if unroll_its:
            assert got.gn_evals == unroll_its * steps
        else:
            # each step: one system an update and one to see it stop
            assert got.gn_evals == got.total_gn_its + steps


def test_the_reference_takes_a_third_update_in_some_steps(basis, mus):
    """The masked mode is held to the reference on steps of two and of
    three updates, not on two alone."""
    seen = collections.Counter()
    for mu in mus:
        seen.update(reference(basis, mu)[1].tolist())
    assert seen[2] > 0 and seen[3] > 0


def test_the_most_updates_a_step_took_meets_a_short_budget(basis, mus):
    """ROMResult.max_step_its: a budget of 2 masked systems, short of the
    steps that take 3 updates, reads 2 (a step took its last update
    unchecked); a budget of 4 reads the reference's 3, in one read-back
    with the total."""
    grid = Grid2D(nx=24, ny=24, x_up=100.0, y_up=100.0)
    vu_p, vv_p, dmask, tr = rf.precompute_prom_pallas(grid, basis,
                                                      dtype=F64)
    y0 = basis.T @ torch.ones(basis.shape[0], dtype=F64)
    mu = next(m for m in mus if int(reference(basis, m)[1].max()) == 3)
    for unroll_its, most in ((2, 2), (4, 3)):
        got = rf.pallas_prom(grid, vu_p, vv_p, dmask, y0, DT,
                             CFG["num_steps"], *mu, unroll_its=unroll_its,
                             tile_rows=tr, **GN)
        assert got.max_step_its == most


def test_run_prom_reaches_the_masked_loop(tmp_path, monkeypatch):
    """run_prom --engine pallas --unroll-its 3 runs pallas_prom's masked
    loop: three systems a step; --unroll-its without the pallas engine is
    refused."""
    monkeypatch.chdir(tmp_path)
    seen = []

    def watched(*args, **kwargs):
        res = rf.pallas_prom(*args, **kwargs)
        seen.append((kwargs["unroll_its"], args[6], res.gn_evals))
        return res

    monkeypatch.setattr(trun_prom, "pallas_prom", watched)
    monkeypatch.setenv("FDTPU_WARM", "0")
    trun_prom.main(5.19, 0.026, num_modes=6, load_basis=False,
                   num_cells=12, num_steps=8, engine="pallas",
                   device="cpu", unroll_its=3)
    assert seen == [(3, 8, 24)]
    with pytest.raises(ValueError, match="--engine pallas"):
        trun_prom.main(5.19, 0.026, num_cells=12, num_steps=8,
                       device="cpu", unroll_its=3)
