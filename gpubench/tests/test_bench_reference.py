"""The plain references and the offline-model generator against the port's
CPU path at tiny sizes (CPU). The tests may import both; the references
import nothing of the port."""

import numpy as np
import pytest
import torch

from gpubench.reference import burgers, hprom, offline
from gpubench.reference.nnls import nnls_gram
from gpubench.tests import tiny

F64 = torch.float64


def _port_fom(n, steps, mu, **kw):
    from finitedifference_tpu_torch.fom import \
        inviscid_burgers_implicit2d_skewed
    from finitedifference_tpu_torch.grid import Grid2D

    g = Grid2D(nx=n, ny=n)
    return inviscid_burgers_implicit2d_skewed(
        g, torch.ones(g.state_dim, dtype=F64), 0.05, steps, *mu, **kw)


def _ref_fom(n, steps, mu, **kw):
    snaps = []
    its = burgers.newton_trajectory(
        burgers.Problem(nx=n, ny=n, dt=0.05), [mu], steps, dtype=F64,
        device="cpu", on_step=lambda i, u, v: snaps.append(
            torch.cat((u[0].reshape(-1), v[0].reshape(-1)))), **kw)
    return torch.stack(snaps, 1), its[0]


@pytest.mark.parametrize("mu", [(4.25, 0.015), (5.19, 0.026), (5.5, 0.03)])
def test_exact_fom_matches_the_port(mu):
    """Every snapshot to rounding, and the same Newton updates."""
    res = _port_fom(18, 6, mu)
    want, its = _ref_fom(18, 6, mu)
    assert its == res.total_newton_its
    rel = float((res.snaps - want).norm() / want.norm())
    assert rel < 1e-14, rel


@pytest.mark.parametrize("n_seg,overlap", [(8, 5), (3, 2)])
def test_segmented_fom_matches_the_port(n_seg, overlap):
    """The overlapping-segment solve, segments over the diagonal axis
    padded to 128: the same inexact Newton, step for step."""
    mu = (5.3, 0.017)
    res = _port_fom(100, 3, mu, seg=n_seg, seg_overlap=overlap)
    want, its = _ref_fom(100, 3, mu, n_seg=n_seg, overlap=overlap)
    assert its == res.total_newton_its
    rel = float((res.snaps - want).norm() / want.norm())
    assert rel < 1e-14, rel
    # the segments really cut the solve: it is not the exact one
    prob = burgers.Problem(nx=100, ny=100, dt=0.05)
    g = torch.Generator().manual_seed(1)
    u, v = (1 + 4 * torch.rand((1, 100, 100), generator=g, dtype=F64)
            for _ in range(2))
    ru, rv = (torch.randn((1, 100, 100), generator=g, dtype=F64)
              for _ in range(2))
    a = burgers.TriangularSolve(prob, 1, F64, "cpu")(u, v, ru, rv)
    b = burgers.TriangularSolve(prob, 1, F64, "cpu", n_seg=n_seg,
                                overlap=overlap)(u, v, ru, rv)
    assert float((a[0] - b[0]).abs().max()) > 1e-6


def test_triangular_solve_inverts_the_jacobian():
    """J (solve(r)) = r for random fields, batched."""
    from finitedifference_tpu_torch.grid import Grid2D
    from finitedifference_tpu_torch.ops.stencil import apply_jacobian

    prob = burgers.Problem(nx=11, ny=7, dt=0.05)
    g = torch.Generator().manual_seed(3)
    u, v = (1 + 4 * torch.rand((2, 7, 11), generator=g, dtype=F64)
            for _ in range(2))
    ru, rv = (torch.randn((2, 7, 11), generator=g, dtype=F64)
              for _ in range(2))
    du, dv = burgers.TriangularSolve(prob, 2, F64, "cpu")(u, v, ru, rv)
    for b in range(2):
        ju, jv = apply_jacobian(u[b], v[b], du[b], dv[b], 0.05,
                                Grid2D(nx=11, ny=7))
        assert torch.allclose(ju, ru[b], atol=1e-13)
        assert torch.allclose(jv, rv[b], atol=1e-13)


def _model(tmp_path):
    cfg = tiny.COARSE
    return cfg, offline.load_or_build(cfg, str(tmp_path / "model"), "cpu")


def test_hprom_matches_the_port(tmp_path):
    """The reduced trajectories of three mu points and their Gauss-Newton
    updates, against the port's traj_hprom_batch on the same model."""
    from finitedifference_tpu_torch import rom_factored as rf
    from finitedifference_tpu_torch.grid import Grid2D
    from finitedifference_tpu_torch.rom import prepare_hprom

    cfg, (basis, weights) = _model(tmp_path)
    prob = burgers.problem_from_config(cfg)
    mus = [(4.3, 0.016), (5.0, 0.024), (5.45, 0.029)]
    grid = Grid2D(nx=prob.nx, ny=prob.ny)
    mesh, sw, ba = prepare_hprom(grid, weights, basis)
    p6p, wgt_p = rf.precompute_pallas_system(
        rf.precompute_factored_blocks(mesh, ba), sw, dtype=F64)
    y0 = basis.T @ torch.ones(grid.state_dim, dtype=F64)
    red, its = rf.traj_hprom_batch(grid, mesh, p6p, wgt_p, y0, 0.05, 8, mus)
    want, want_its = hprom.hprom_trajectories(prob, basis, weights, mus, 8)
    assert torch.equal(its.long(), want_its)
    rel = float((red - want).norm() / want.norm())
    assert rel < 1e-12, rel


def test_pod_basis_spans_the_port_pod(tmp_path):
    """The method-of-snapshots basis against the port's exact SVD of the
    same snapshots: the same subspace, mode by mode up to sign."""
    from finitedifference_tpu_torch.pod import pod

    g = torch.Generator().manual_seed(0)
    snaps = torch.randn((40, 300), generator=g, dtype=F64) \
        * torch.logspace(0, -3, 40, dtype=F64)[:, None]
    mine = offline.pod_basis(snaps, 8)
    theirs, _ = pod(snaps.T, num_modes=8, method="svd")
    dots = (mine * theirs).sum(0).abs()
    assert torch.allclose(dots, torch.ones(8, dtype=F64), atol=1e-10)
    assert torch.allclose(mine.T @ mine, torch.eye(8, dtype=F64),
                          atol=1e-12)


def test_weights_match_the_port_ecsw(tmp_path):
    """The training matrix and the NNLS weights against the port's
    ecsw_training_matrix and compute_ecsw_weights, on the same snapshots
    and basis: the matrix to rounding, the frozen NNLS bit for bit, and
    both weight fields to the NNLS stop."""
    from finitedifference_tpu_torch import ecsw
    from finitedifference_tpu_torch.grid import Grid2D

    cfg, (basis, weights) = _model(tmp_path)
    prob = burgers.problem_from_config(cfg)
    snaps = torch.empty((cfg["num_steps"] + 1, 2 * prob.n_cells),
                        dtype=F64)

    def keep(i, u, v):
        snaps[i] = torch.cat((u.reshape(-1), v.reshape(-1)))

    mu = tuple(cfg["offline"]["ecsw_mu"])
    burgers.newton_trajectory(prob, [mu], cfg["num_steps"], dtype=F64,
                              device="cpu", on_step=keep)
    lag, stride = cfg["offline"]["ecsw_lag"], cfg["offline"]["ecsw_stride"]
    t = cfg["num_steps"]
    c = offline.training_matrix(prob, snaps[lag:t:stride],
                                snaps[0:t - lag:stride], basis, mu)
    grid = Grid2D(nx=prob.nx, ny=prob.ny)
    c_port = ecsw.ecsw_training_matrix(grid, snaps[lag:t:stride].T,
                                       snaps[0:t - lag:stride].T, basis,
                                       *mu, 0.05)
    assert torch.allclose(c, c_port, rtol=1e-12, atol=1e-14)
    ring = offline.ring_mask(prob)
    ci = c[:, torch.as_tensor(~ring)].numpy()
    d = ci.sum(axis=1)
    mine = nnls_gram(ci, d, rel_err_thresh=1e-4)[0]
    assert np.array_equal(mine, ecsw.nnls_gram(ci, d, rel_err_thresh=1e-4)[0])
    # the port's recipe sums the columns in another order, and at this
    # size near-ties can pick another column: both weight fields must
    # reproduce the training sums to the NNLS stop, 1e-4
    w_port = ecsw.compute_ecsw_weights(c_port, grid, bc_w=50.0,
                                       rel_err_thresh=1e-4)
    full = c.numpy()
    target = full.sum(axis=1)
    for w in (w_port, weights.numpy()):
        assert np.all(w[ring] == 50.0) and np.all(w >= 0)
        fit = full[:, ~ring] @ w[~ring] + full[:, ring].sum(axis=1)
        assert np.linalg.norm(fit - target) < 1e-4 * np.linalg.norm(
            full[:, ~ring].sum(axis=1))


@pytest.mark.cuda
@pytest.mark.parametrize("n_seg", [0, 8])
def test_graph_replay_matches_the_eager_solve(cuda_device, n_seg):
    """On the card the reference's solve replays a CUDA graph: the same
    numbers as the eager loop, for the exact and the segmented solve."""
    prob = burgers.Problem(nx=200, ny=200, dt=0.05)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    u, v = (1 + 4 * torch.rand((2, 200, 200), generator=g, dtype=F64,
                               device=cuda_device) for _ in range(2))
    ru, rv = (torch.randn((2, 200, 200), generator=g, dtype=F64,
                          device=cuda_device) for _ in range(2))
    kw = dict(n_seg=n_seg, overlap=16) if n_seg else {}
    eager = burgers.TriangularSolve(prob, 2, F64, cuda_device, graph=False,
                                    **kw)(u, v, ru, rv)
    solve = burgers.TriangularSolve(prob, 2, F64, cuda_device, graph=True,
                                    **kw)
    for _ in range(2):
        replay = solve(u, v, ru, rv)
        assert all(torch.equal(a, b) for a, b in zip(eager, replay))
