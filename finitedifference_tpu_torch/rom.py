"""Online ROM time-steppers (PyTorch).

Counterpart of finitedifference_tpu/rom.py: the LSPG PROM on the full
grid (reference inviscid_burgers_implicit2D_LSPG, hypernet2D.py:133-200)
and the ECSW HPROM on a sampled mesh (inviscid_burgers_ecsw_fixed,
hypernet2D.py:202-273). Each is a Python loop over time steps around the
generic Gauss-Newton of solvers.py, on the device of the basis.

`make_manifold_stepper` / `manifold_rom` run the same Gauss-Newton over a
nonlinear decoder (the closure ROMs, closures/).

Conventions match the reference: the initial condition is projected
(y0 = V^T w0, w0 <- V y0); the reduced coordinates of all num_steps+1
times are returned with the total Gauss-Newton iteration count, and full
snapshots are reconstructed on demand (one matmul).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.sampled import (
    augmented_state_indices,
    build_sampled_mesh,
    sampled_inflow_bc,
    sampled_jacobian_times_basis,
    sampled_residual,
    sampled_source,
)
from finitedifference_tpu_torch.ops.stencil import (
    burgers_residual_flat,
    inflow_bc_term,
    jacobian_times_basis,
    source_term,
)
from finitedifference_tpu_torch.precision import hi_matmul
from finitedifference_tpu_torch.solvers import gauss_newton


class ROMResult(NamedTuple):
    red_coords: torch.Tensor     # (k, num_steps+1)
    total_gn_its: int
    # Gauss-Newton system evaluations, the stopping checks included: the
    # number of kernel launches of the kernel engines (rom_factored);
    # None where the engine does not count them
    gn_evals: Optional[int] = None
    # the most Gauss-Newton updates any one time step took (rom_factored's
    # engines); None where the engine does not count them
    max_step_its: Optional[int] = None


def _run_lspg(y0, w0_dec, num_steps, make_res, decode, dec_jac, jac_apply,
              weights, extrapolate_guess, gn_kw) -> ROMResult:
    """The time loop shared by lspg_prom and ecsw_hprom."""
    ys = torch.empty((num_steps + 1, y0.shape[0]), dtype=y0.dtype,
                     device=y0.device)
    ys[0] = y0
    yp, ym, wp, its = y0, y0, w0_dec, 0
    for i in range(num_steps):
        # linear predictor 2 y_n - y_{n-1} (opt-in): the GN init_norm, and
        # so the reference's relative stopping rule, is taken AT the guess
        yg = 2.0 * yp - ym if extrapolate_guess else yp
        out = gauss_newton(decode, dec_jac, make_res(wp), jac_apply, yg,
                           weights=weights, w0=wp, **gn_kw)
        ym, yp = yp, out.y
        wp = decode(out.y)
        its += out.num_its
        ys[i + 1] = out.y
    return ROMResult(red_coords=ys.T, total_gn_its=its)


def lspg_prom(grid: Grid2D, w0, dt, num_steps, mu1, mu2, basis,
              *, max_its: int = 20, relnorm_cutoff: float = 1e-5,
              min_delta: float = 0.1, ls_dtype=None,
              ls_method: str = "qr",
              extrapolate_guess: bool = False) -> ROMResult:
    """LSPG PROM with a linear POD basis (reference
    inviscid_burgers_implicit2D_LSPG, hypernet2D.py:133-200).

    Per GN iteration: the full-grid residual and J@V stencils, then the
    tall-skinny least-squares solve (`ls_method`)."""
    basis = as_tensor(basis)
    w0 = torch.as_tensor(w0, device=basis.device)
    dtype, device = w0.dtype, w0.device
    y0 = basis.T @ w0
    src = source_term(grid, mu2, dt, dtype=dtype, device=device)
    lbc = inflow_bc_term(grid, mu1, dt, dtype=dtype, device=device)

    def make_res(wp):
        return lambda w: burgers_residual_flat(w, wp, mu1, mu2, dt, grid,
                                               src, lbc)

    return _run_lspg(
        y0, hi_matmul(basis, y0), num_steps, make_res,
        decode=lambda y: hi_matmul(basis, y),
        dec_jac=lambda y, w: basis,
        jac_apply=lambda w, v: jacobian_times_basis(w, v, dt, grid),
        weights=None, extrapolate_guess=extrapolate_guess,
        gn_kw=dict(max_its=max_its, relnorm_cutoff=relnorm_cutoff,
                   min_delta=min_delta, ls_dtype=ls_dtype,
                   ls_method=ls_method))


def reconstruct(basis, red_coords) -> torch.Tensor:
    """Full-state snapshots from reduced coordinates: (2n, T+1)."""
    basis = as_tensor(basis)
    return hi_matmul(basis, as_tensor(red_coords, basis.device))


def ecsw_hprom(grid: Grid2D, mesh, sample_weights, y0, basis_aug, dt,
               num_steps, mu1, mu2, *, max_its: int = 20,
               relnorm_cutoff: float = 1e-5,
               min_delta: float = 0.1, ls_dtype=None,
               ls_method: str = "qr",
               extrapolate_guess: bool = False) -> ROMResult:
    """HPROM: LSPG on the ECSW sampled mesh (reference
    inviscid_burgers_ecsw_fixed, hypernet2D.py:202-273).

    mesh:           ops.sampled.SampledMesh of the nonzero-weight cells.
    sample_weights: (n_s,) positive ECSW weights at the sampled cells,
                    duplicated over the u and v rows.
    y0:             initial reduced coords, basis.T @ w0 with the *full*
                    basis (the caller projects).
    basis_aug:      (2*n_z, k) basis gathered at augmented rows.
    """
    basis_aug = as_tensor(basis_aug)
    y0 = torch.as_tensor(y0, device=basis_aug.device)
    dtype = basis_aug.dtype
    src = sampled_source(mesh, grid, mu2, dt, dtype)
    lbc = sampled_inflow_bc(mesh, grid, mu1, dt, dtype)
    sw = torch.as_tensor(sample_weights, device=basis_aug.device)
    wgt = torch.cat((sw, sw)).to(dtype)

    def make_res(wp):
        return lambda w: sampled_residual(w, wp, mu1, mu2, dt, grid, mesh,
                                          src, lbc)

    return _run_lspg(
        y0, hi_matmul(basis_aug, y0), num_steps, make_res,
        decode=lambda y: hi_matmul(basis_aug, y),
        dec_jac=lambda y, w: basis_aug,
        jac_apply=lambda w, v: sampled_jacobian_times_basis(
            w, v, dt, grid, mesh),
        weights=wgt, extrapolate_guess=extrapolate_guess,
        gn_kw=dict(max_its=max_its, relnorm_cutoff=relnorm_cutoff,
                   min_delta=min_delta, ls_dtype=ls_dtype,
                   ls_method=ls_method))


def make_manifold_stepper(grid: Grid2D, decode, dec_jac, dt, num_steps,
                          *, dtype, mesh=None,
                          sample_weights=None, max_its: int = 20,
                          relnorm_cutoff: float = 1e-5,
                          min_delta: float = 0.1, ls_dtype=None,
                          ls_method: str = "qr",
                          line_search: bool = False,
                          decode_and_jac=None):
    """The online program of `manifold_rom`:
    `run(y0, mu1, mu2) -> (red_coords (k, num_steps+1), total_gn_its)`.

    (mu1, mu2) are run-time arguments, as in the JAX package, so one
    stepper serves every test point. The state lives on y0's device in
    `dtype`; with a SampledMesh, decode/dec_jac act on the augmented
    sampled rows and the residual is ECSW-weighted by sample_weights.
    Each step is a Gauss-Newton solve from the previous coordinates, with
    the previous decoded state carried as w0.
    """
    gn_kw = dict(max_its=max_its, relnorm_cutoff=relnorm_cutoff,
                 min_delta=min_delta, ls_dtype=ls_dtype,
                 ls_method=ls_method, line_search=line_search,
                 decode_and_jac=decode_and_jac)

    def run(y0, mu1, mu2):
        y0 = as_tensor(y0, dtype=dtype)
        device = y0.device
        mu1 = torch.as_tensor(mu1, dtype=dtype, device=device)
        mu2 = torch.as_tensor(mu2, dtype=dtype, device=device)
        if mesh is None:
            src = source_term(grid, mu2, dt, dtype=dtype, device=device)
            lbc = inflow_bc_term(grid, mu1, dt, dtype=dtype, device=device)

            def make_res(wp):
                return lambda w: burgers_residual_flat(
                    w, wp, mu1, mu2, dt, grid, src, lbc)

            def jac_apply(w, v):
                return jacobian_times_basis(w, v, dt, grid)
            wgt = None
        else:
            src = sampled_source(mesh, grid, mu2, dt, dtype)
            lbc = sampled_inflow_bc(mesh, grid, mu1, dt, dtype)

            def make_res(wp):
                return lambda w: sampled_residual(
                    w, wp, mu1, mu2, dt, grid, mesh, src, lbc)

            def jac_apply(w, v):
                return sampled_jacobian_times_basis(w, v, dt, grid, mesh)
            sw = torch.as_tensor(sample_weights, device=device)
            wgt = torch.cat((sw, sw)).to(dtype)

        ys = torch.empty((num_steps + 1, y0.shape[0]), dtype=dtype,
                         device=device)
        ys[0] = y0
        yp, wp, its = y0, decode(y0), 0
        for i in range(num_steps):
            out = gauss_newton(decode, dec_jac, make_res(wp), jac_apply,
                               yp, weights=wgt, w0=wp, **gn_kw)
            yp = out.y
            wp = decode(yp)
            its += out.num_its
            ys[i + 1] = yp
        return ys.T, its

    return run


def manifold_rom(grid: Grid2D, y0, decode, dec_jac, dt, num_steps,
                 mu1, mu2, *, mesh=None, sample_weights=None,
                 max_its: int = 20, relnorm_cutoff: float = 1e-5,
                 min_delta: float = 0.1, ls_dtype=None,
                 ls_method: str = "qr",
                 line_search: bool = False,
                 decode_and_jac=None) -> ROMResult:
    """Generic LSPG ROM over a (possibly nonlinear) decoder.

    One stepper covers the reference's RNM/HRNM, POD-RBF PROM/HPROM,
    POD-GP HPROM and AE-LSPG: the variant is entirely in (decode,
    dec_jac). decode/dec_jac act on the full state when mesh is None, or
    on the augmented sampled rows when a SampledMesh and sample_weights
    are given (closures.manifold_decoder over gathered bases).
    """
    y0 = as_tensor(y0)
    run = make_manifold_stepper(
        grid, decode, dec_jac, dt, num_steps, dtype=y0.dtype,
        mesh=mesh, sample_weights=sample_weights, max_its=max_its,
        relnorm_cutoff=relnorm_cutoff, min_delta=min_delta,
        ls_dtype=ls_dtype, ls_method=ls_method, line_search=line_search,
        decode_and_jac=decode_and_jac)
    red, its = run(y0, mu1, mu2)
    return ROMResult(red_coords=red, total_gn_its=its)


def prepare_hprom(grid: Grid2D, weights_full, basis):
    """Host-side setup for ecsw_hprom from a full-grid weight field.

    weights_full: (n_cells,) ECSW weights (zeros = unsampled).
    Returns (mesh, sample_weights, basis_aug) on the basis's device;
    sample_weights are float64, as the weight field is.
    """
    basis = as_tensor(basis)
    if isinstance(weights_full, torch.Tensor):
        weights_full = weights_full.detach().cpu().numpy()
    weights_full = np.asarray(weights_full)
    sample_inds = np.where(weights_full != 0)[0]
    mesh = build_sampled_mesh(grid, sample_inds, device=basis.device)
    sample_weights = torch.as_tensor(weights_full[sample_inds],
                                     device=basis.device)
    idx = augmented_state_indices(mesh, grid.n_cells)
    basis_aug = basis[idx, :]
    return mesh, sample_weights, basis_aug
