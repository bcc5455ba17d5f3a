"""The port's driver entry points, twins of __graft_entry__.py.

entry(): one implicit Crank-Nicolson Newton step of the 250x250 2D
Burgers HDM (the reference coarse workbench's hot path,
hypernet2D.py:72-131). It returns (step, example_args), step(w, mu1,
mu2) being fom.newton_step(..., max_its=20).w, the example a float32
uniform state at μ = (4.75, 0.02), on the card unless `device` asks for
the CPU. On the card each Newton iteration's linear solve is one launch
of the wavefront kernel on the (ny, nx) fields behind
ops/wavefront.solve_jacobian_wavefront (csrc/wavefront.cu, B2; counter
cuda_wavefront.UNSKEWED_LAUNCHES).

dryrun_multichip(n): one multi-rank step of each sharded path over n
ranks (parallel/mesh.spawn) on small shapes, each held against its
unsharded twin: the (dp, sp) FOM step (parameter batch over dp, rows over
sp), a data-parallel closure-training step, the row-sharded skewed
trajectory and the sample-sharded HPROM.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from finitedifference_tpu_torch import optim
from finitedifference_tpu_torch.closures.ann import init_rnm, rnm_apply
from finitedifference_tpu_torch.config import BurgersConfig
from finitedifference_tpu_torch.device import resolve_device
from finitedifference_tpu_torch.fom import (
    inviscid_burgers_implicit2d,
    inviscid_burgers_implicit2d_skewed,
    newton_step,
)
from finitedifference_tpu_torch.grid import Grid2D, grid_from_config
from finitedifference_tpu_torch.ops.stencil import (
    inflow_bc_term,
    source_term,
)
from finitedifference_tpu_torch.parallel.mesh import (
    local_mesh,
    make_mesh,
    psum,
    spawn,
    world_rank,
)
from finitedifference_tpu_torch.parallel.spatial import (
    sharded_skewed_fom,
    sharded_sweep_fom_step,
)
from finitedifference_tpu_torch.parallel.sweep import sharded_factored_hprom
from finitedifference_tpu_torch.pod import pod
from finitedifference_tpu_torch.rom import prepare_hprom
from finitedifference_tpu_torch.rom_factored import (
    factored_hprom,
    precompute_factored_blocks,
)


def entry(device=None):
    """(step, example_args) of the 250x250 Newton step (module
    docstring)."""
    cfg = BurgersConfig()              # 250x250, dt=0.05
    grid = grid_from_config(cfg)
    device = resolve_device(device)

    def step(w, mu1, mu2):
        return newton_step(w, mu1, mu2, cfg.dt, grid, max_its=20).w

    w0 = grid.initial_state(dtype=torch.float32, device=device)
    example_args = (w0,
                    torch.tensor(4.75, dtype=torch.float32, device=device),
                    torch.tensor(0.02, dtype=torch.float32, device=device))
    return step, example_args


def _factor(n: int) -> tuple[int, int]:
    """(dp, sp) with sp the largest factor of n not above sqrt(n)."""
    sp = 1
    for f in range(int(np.sqrt(n)), 0, -1):
        if n % f == 0:
            sp = f
            break
    return n // sp, sp


def _dryrun_ranks(n: int) -> dict:
    """One rank of dryrun_multichip: every phase, asserting JAX's
    tolerances; returns rank 0's numbers."""
    def close(got, want, rtol, atol, what):
        got, want = got.double().cpu(), want.double().cpu()
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(
                f"{what}: max abs diff {float((got - want).abs().max())}")
        return float((got - want).abs().max())

    dp, sp = _factor(n)
    mesh = make_mesh((dp, sp), ("dp", "sp"))
    dev = mesh.device
    out = {"dp": dp, "sp": sp}

    # ---- sharded solver step: parameter batch over dp, rows over sp ----
    dtype = torch.float32
    ny, nx = ((64 + sp - 1) // sp) * sp, 64   # >= 64^2, ny % sp == 0
    batch = 2 * dp
    grid = Grid2D(nx=nx, ny=ny, x_up=100.0, y_up=100.0)
    dt = 0.05
    mus = np.linspace(4.25, 5.5, batch)
    src = torch.stack([source_term(grid, 0.02, dt, dtype=dtype, device=dev)
                       for _ in range(batch)])
    lbc = torch.stack([inflow_bc_term(grid, float(m), dt, dtype=dtype,
                                      device=dev) for m in mus])
    up = torch.ones((batch, ny, nx), dtype=dtype, device=dev)
    vp = torch.ones_like(up)
    kw = dict(num_sweeps=8, max_its=5, relnorm_cutoff=1e-5)
    u, v = sharded_sweep_fom_step(mesh, grid, dt, **kw)(up, vp, src, lbc)
    if world_rank() == 0:
        # parity, not finiteness: the same step on a 1x1 mesh (no halo,
        # sums of one term)
        u1, v1 = sharded_sweep_fom_step(local_mesh(("dp", "sp")), grid, dt,
                                        **kw)(up, vp, src, lbc)
        out["step_err"] = max(close(u, u1, 1e-5, 1e-6, "dp x sp FOM step u"),
                              close(v, v1, 1e-5, 1e-6, "dp x sp FOM step v"))

    # ---- data-parallel closure-training step over dp -------------------
    module = init_rnm(4, 8, dtype=dtype, device=dev)
    params = tuple(p.detach() for p in module.parameters())
    state = optim.adam_init(params)
    bsz = 4 * dp
    x = torch.ones((bsz, 4), dtype=dtype, device=dev)
    y = torch.zeros((bsz, 8), dtype=dtype, device=dev)
    rows = slice(mesh.rank("dp") * 4, (mesh.rank("dp") + 1) * 4)
    live = tuple(p.clone().requires_grad_() for p in params)
    loss = F.mse_loss(rnm_apply(live, x[rows]), y[rows])
    grads = torch.autograd.grad(loss, live)
    # the mean over dp of the ranks' mean losses and gradients is the
    # whole batch's (equal blocks)
    grads = tuple(psum(g, mesh, "dp") / dp for g in grads)
    loss = psum(loss.detach(), mesh, "dp") / dp
    updates, state = optim.adam_update(grads, state, 1e-3)
    params = tuple(p + u_ for p, u_ in zip(params, updates))
    if not (bool(torch.isfinite(loss))
            and all(bool(torch.isfinite(p).all()) for p in params)):
        raise AssertionError(f"dp training step: loss {float(loss)}, or "
                             f"parameters not finite")
    out["train_loss"] = float(loss)

    # ---- row-sharded SKEWED engine over every rank ---------------------
    flat = make_mesh((n,), ("sp",))
    skgrid = Grid2D(nx=64, ny=64, x_up=100.0, y_up=100.0)
    skw0 = torch.ones(skgrid.state_dim, dtype=dtype, device=dev)
    sk_snaps, sk_its = sharded_skewed_fom(flat, skgrid, skw0, dt, 3, 4.75,
                                          0.02)
    sk_ref = inviscid_burgers_implicit2d_skewed(skgrid, skw0, dt, 3, 4.75,
                                                0.02)
    out["skewed_err"] = close(sk_snaps, sk_ref.snaps, 2e-5, 1e-5,
                              "sharded skewed FOM")
    if sk_its != sk_ref.total_newton_its:
        raise AssertionError(f"sharded skewed FOM: {sk_its} Newton its, "
                             f"unsharded {sk_ref.total_newton_its}")
    out["skewed_its"] = sk_its

    # ---- sample-axis-sharded HPROM over every rank ---------------------
    w0h = torch.ones(skgrid.state_dim, dtype=dtype, device=dev)
    traj = inviscid_burgers_implicit2d(skgrid, w0h, dt, 10, 4.25,
                                       0.0225).snaps
    basis, _ = pod(traj, num_modes=5, method="svd")
    rng = np.random.default_rng(0)
    weights = np.zeros(skgrid.n_cells)
    weights[rng.choice(skgrid.n_cells, 160, replace=False)] = 1.0
    smesh, sw, basis_aug = prepare_hprom(skgrid, weights, basis)
    y0h = basis.T @ w0h
    res = sharded_factored_hprom(skgrid, smesh, sw, y0h, basis_aug, dt, 6,
                                 4.75, 0.02, mesh=flat, ls_method="normal")
    href = factored_hprom(skgrid, smesh, sw, y0h,
                          precompute_factored_blocks(smesh, basis_aug), dt,
                          6, 4.75, 0.02, ls_method="normal")
    out["hprom_err"] = close(res.red_coords, href.red_coords, 2e-4, 1e-5,
                             "sharded factored HPROM")
    if res.total_gn_its != href.total_gn_its:
        raise AssertionError(f"sharded HPROM: {res.total_gn_its} GN its, "
                             f"unsharded {href.total_gn_its}")
    out["hprom_gn_its"] = res.total_gn_its
    return out


def dryrun_multichip(n_devices: int, device=None,
                     backend: str | None = None,
                     timeout: float = 600.0) -> dict:
    """One multi-rank step of each sharded path over `n_devices` ranks
    (module docstring), each against its unsharded twin at the JAX
    package's tolerances; raises on a mismatch.

    n_devices factors into (dp, sp) as squarely as possible. The ranks
    run on the card (device None; NCCL, a card a rank, unless
    backend="gloo" lets them share one) or on the CPU (device="cpu",
    gloo). Returns rank 0's numbers: the mesh, the errors, the Newton and
    Gauss-Newton counts and the training loss."""
    device = resolve_device(device)
    return spawn(_dryrun_ranks, n_devices, n_devices, device=device.type,
                 backend=backend, timeout=timeout)
