"""Tensorized ECSW HPROM: the whole online problem in reduced space
(PyTorch).

Counterpart of finitedifference_tpu/rom_tensor.py. The 2D Burgers CN
residual is QUADRATIC in the state, so on a fixed sampled mesh with a
linear basis V the sampled residual is an exact quadratic form in the
reduced coords y:

    r(y; yp) = Vs (y - yp) + (dt/4) * (rowdot(H y, y) + rowdot(H yp, yp))
               - src - lbc
    J(y) V   = Vs + (dt/2) * (H y)

with Vs = V at the sampled self rows and H the (2*n_s, k, k) symmetric
bilinear flux tensor, H[:, :, j] = (2/dt) * (J_N(V e_j) V). The online
Gauss-Newton is then dense matrix products on (2*n_s, k) arrays, with the
stopping rules of rom.ecsw_hprom (identical trajectories, tested). H is
2*n_s*k*k values: 109 MB in f32 on the 250^2 bench mesh (1508 cells, 95
modes), streamed once per Gauss-Newton iteration. No kernel of its own:
the products go to cuBLAS in full f32 (precision.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.sampled import (
    SampledMesh,
    sampled_inflow_bc,
    sampled_jacobian_times_basis,
    sampled_source,
)
from finitedifference_tpu_torch.rom import ROMResult
from finitedifference_tpu_torch.rom_factored import (
    _gauss_newton,
    _reduced_solver,
    _time_loop,
)


class HPROMTensors(NamedTuple):
    """Precomputed, ECSW-weighted online operators."""
    vs: torch.Tensor          # (2*n_s, k)    weighted V at sampled self rows
    h: torch.Tensor           # (2*n_s, k, k) weighted bilinear flux tensor
    basis_aug: torch.Tensor   # (2*n_z, k)    unweighted (decode for output)


def precompute_hprom_tensors(grid: Grid2D, mesh: SampledMesh,
                             sample_weights, basis_aug,
                             dt) -> HPROMTensors:
    """Build (Vs, H) once per mesh and basis, one sampled Jacobian-basis
    product per basis column, on the basis's device in its dtype."""
    basis_aug = as_tensor(basis_aug)
    dtype, device = basis_aug.dtype, basis_aug.device
    k = basis_aug.shape[1]
    n_z = mesh.n_aug
    vs = torch.cat((basis_aug[:n_z][mesh.pos_self],
                    basis_aug[n_z:][mesh.pos_self]))          # (2*n_s, k)
    h = torch.stack([(sampled_jacobian_times_basis(basis_aug[:, j],
                                                   basis_aug, dt, grid, mesh)
                      - vs) * (2.0 / dt) for j in range(k)], dim=2)
    sw = as_tensor(sample_weights, device).to(dtype)
    wgt = torch.cat((sw, sw))
    return HPROMTensors(vs=wgt[:, None] * vs, h=wgt[:, None, None] * h,
                        basis_aug=basis_aug)


def tensor_hprom(grid: Grid2D, mesh, sample_weights, y0,
                 tensors: HPROMTensors, dt, num_steps, mu1, mu2, *,
                 max_its: int = 20, relnorm_cutoff: float = 1e-5,
                 min_delta: float = 0.1, unroll_its: int = 0,
                 ls_method: str = "normal") -> ROMResult:
    """HPROM time loop on the precomputed tensors, in y0's dtype.

    unroll_its > 0 runs that many masked Gauss-Newton iterations per step
    instead of the dynamic loop (iterations past the stop freeze y).
    ls_method "normal" (Cholesky) or "cg" (24 CG steps) solves the normal
    equations of each iteration.
    """
    vs, h = tensors.vs, tensors.h
    y0 = as_tensor(y0, vs.device)
    dtype = y0.dtype
    if ls_method == "fused":
        raise ValueError("tensor_hprom takes ls_method 'normal' or 'cg'")
    solve_ls = _reduced_solver(ls_method)
    half_dt, quarter_dt = 0.5 * dt, 0.25 * dt
    src = sampled_source(mesh, grid, mu2, dt, dtype)
    lbc = sampled_inflow_bc(mesh, grid, mu1, dt, dtype)
    w_src = as_tensor(sample_weights, vs.device).to(dtype) * (src + lbc)
    c_mu = torch.cat((-w_src, torch.zeros_like(w_src)))     # (2*n_s,)
    n2, k = vs.shape
    h_flat = h.reshape(n2 * k, k)

    def scalars(y):
        """G(y) = H . y and Vs y, carried from step to step."""
        return (h_flat @ y).reshape(n2, k), vs @ y

    def residual(y, gy, vy, c_p):
        return vy + quarter_dt * (gy @ y) + c_p

    def step(yp, sp):
        gyp, vyp = sp
        c_p = -vyp + quarter_dt * (gyp @ yp) + c_mu
        init_norm = torch.linalg.vector_norm(residual(yp, gyp, vyp, c_p))

        def system(y):
            gy, vy = scalars(y)
            f = residual(y, gy, vy, c_p)
            jv = vs + half_dt * gy
            return solve_ls(jv.T @ jv, jv.T @ -f), \
                torch.linalg.vector_norm(f)

        return _gauss_newton(yp, init_norm, system, it0=0,
                             unrolled=unroll_its > 0, n_iters=unroll_its,
                             max_its=max_its, relnorm_cutoff=relnorm_cutoff,
                             min_delta=min_delta)

    return _time_loop(y0, num_steps, step, scalars)
