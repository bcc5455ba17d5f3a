"""Skewed-coordinate representation of the Burgers HDM (PyTorch).

Counterpart of finitedifference_tpu/ops/skewed.py. The wavefront solve
wants fields in anti-diagonal (skewed) layout S[d, r] = X[r, d - r].
Converting per solve costs a large gather, so the whole time integration
stays in skewed coordinates, where the upwind stencil maps to contiguous
shifts:

    west  (r, c-1)  ->  S[d-1, r]      (shift along the diagonal axis)
    south (r-1, c)  ->  S[d-1, r-1]    (shift along both axes)

and the zero ghost cells fall out of the zero padding outside the valid
anti-diagonal band. Skew/unskew happens once per trajectory.

Arrays are padded to (nd_pad, ny_pad), the same padding as the JAX
package, so skewed arrays compare one-to-one; slots outside the valid
band hold zeros and every residual is masked back to the band.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.cuda_skewed import (
    ResidualWorkspace,
    step_constant_cuda,
    update_residual_cuda,
)
from finitedifference_tpu_torch.ops.cuda_wavefront import (
    solve_skewed_cuda,
    solve_skewed_seg_cuda,
)
from finitedifference_tpu_torch.utils import profiling


def skew(x: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """(..., ny, nx) -> (..., ny+nx-1, ny) with S[d, r] = X[r, d-r].

    Out-of-range entries are zero.
    """
    d = torch.arange(ny + nx - 1, device=x.device)[:, None]
    r = torch.arange(ny, device=x.device)[None, :]
    c = d - r
    valid = (c >= 0) & (c < nx)
    gathered = x[..., r, c.clamp(0, nx - 1)]  # (..., ndiag, ny)
    return torch.where(valid, gathered, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def unskew(s: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Inverse of `skew`: (..., ny+nx-1, ny) -> (..., ny, nx)."""
    r = torch.arange(ny, device=s.device)[:, None]
    c = torch.arange(nx, device=s.device)[None, :]
    return s[..., r + c, r]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SkewedLayout(NamedTuple):
    """Static geometry of the padded skewed representation."""
    nx: int
    ny: int
    nd_pad: int
    ny_pad: int

    @property
    def ndiag(self) -> int:
        return self.ny + self.nx - 1


def make_layout(grid: Grid2D, block: int = 128) -> SkewedLayout:
    ndiag = grid.ny + grid.nx - 1
    return SkewedLayout(
        nx=grid.nx, ny=grid.ny,
        nd_pad=_round_up(ndiag, block),
        ny_pad=_round_up(grid.ny, 128),
    )


def _band(lay: SkewedLayout, device=None) -> torch.Tensor:
    """(nd_pad, ny_pad) boolean mask of the valid anti-diagonal band."""
    d = torch.arange(lay.nd_pad, device=device)[:, None]
    r = torch.arange(lay.ny_pad, device=device)[None, :]
    return (r < lay.ny) & (d - r >= 0) & (d - r < lay.nx)


def valid_mask(lay: SkewedLayout, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return _band(lay, device).to(dtype)


def to_skewed(x, lay: SkewedLayout) -> torch.Tensor:
    """(ny, nx) -> padded (nd_pad, ny_pad)."""
    s = skew(x, lay.ny, lay.nx)
    return F.pad(s, (0, lay.ny_pad - lay.ny, 0, lay.nd_pad - lay.ndiag))


def from_skewed(s, lay: SkewedLayout) -> torch.Tensor:
    """padded (..., nd_pad, ny_pad) -> (..., ny, nx)."""
    return unskew(s[..., :lay.ndiag, :lay.ny], lay.ny, lay.nx)


def shift_prev_diag(s) -> torch.Tensor:
    """S[d, r] -> S[d-1, r]: the WEST neighbor in skewed space."""
    return F.pad(s, (0, 0, 1, 0))[..., :-1, :]


def shift_prev_diag_row(s) -> torch.Tensor:
    """S[d, r] -> S[d-1, r-1]: the SOUTH neighbor in skewed space."""
    return F.pad(s, (1, 0, 1, 0))[..., :-1, :-1]


def skewed_source(lay: SkewedLayout, grid: Grid2D, mu2, dt, dtype,
                  device=None):
    """dt * 0.02 * exp(mu2 * xc[c]) at c = d - r, zero off-band."""
    d = torch.arange(lay.nd_pad, device=device)[:, None]
    r = torch.arange(lay.ny_pad, device=device)[None, :]
    c = (d - r).clamp(0, lay.nx - 1)
    xc = grid.xc(dtype=dtype, device=device)[c]
    mu2 = torch.as_tensor(mu2, dtype=dtype, device=device)
    return torch.as_tensor(dt, dtype=dtype, device=device) * 0.02 \
        * torch.exp(mu2 * xc) * valid_mask(lay, dtype, device)


def skewed_inflow_bc(lay: SkewedLayout, grid: Grid2D, mu1, dt, dtype,
                     device=None):
    """0.5*dt*mu1^2/dx on the c=0 cells, i.e. the d == r diagonal."""
    d = torch.arange(lay.nd_pad, device=device)[:, None]
    r = torch.arange(lay.ny_pad, device=device)[None, :]
    mask = ((d == r) & (r < lay.ny)).to(dtype)
    mu1 = torch.as_tensor(mu1, dtype=dtype, device=device)
    return 0.5 * torch.as_tensor(dt, dtype=dtype, device=device) \
        * mu1 * mu1 / grid.dx * mask


def skewed_residual(u, v, up, vp, dt, grid: Grid2D, lay: SkewedLayout,
                    src_sk, lbc_sk, valid):
    """CN residual entirely in skewed space -> (ru, rv), masked to the
    band. Equals skew(burgers_residual(...)) (tested)."""
    half_dt = 0.5 * dt
    fu = 0.5 * (u * u + up * up)
    fv = 0.5 * (v * v + vp * vp)
    fuv = 0.5 * (u * v + up * vp)

    def ddx(f):
        return (f - shift_prev_diag(f)) / grid.dx

    def ddy(f):
        return (f - shift_prev_diag_row(f)) / grid.dy

    ru = u - up + half_dt * (ddx(fu) + ddy(fuv)) - src_sk - lbc_sk
    rv = v - vp + half_dt * (ddy(fv) + ddx(fuv))
    return ru * valid, rv * valid


def _half_flux(u, v, dt, grid: Grid2D):
    """Current-state half of the CN residual: u + 0.5*dt*(ddx(0.5 u^2)
    + ddy(0.5 u v)) and the v analogue (no mask, no constants)."""
    half_dt = 0.5 * dt
    fu = 0.5 * u * u
    fv = 0.5 * v * v
    fuv = 0.5 * u * v

    def ddx(f):
        return (f - shift_prev_diag(f)) / grid.dx

    def ddy(f):
        return (f - shift_prev_diag_row(f)) / grid.dy

    au = u + half_dt * (ddx(fu) + ddy(fuv))
    av = v + half_dt * (ddy(fv) + ddx(fuv))
    return au, av


def skewed_step_constant(up, vp, dt, grid: Grid2D, src_sk, lbc_sk,
                         valid):
    """Per-STEP constant of the CN residual and the residual at the
    previous state, in one pass.

    The residual splits as r(u, v) = half(u, v) + cp(up, vp), where the
    cp half (previous-state fluxes, source, inflow BC) is constant across
    a step's Newton iterations. Returns (cp_u, cp_v, r0_u, r0_v) with cp
    pre-masked and r0 = r(up, vp), the Newton init_norm residual.
    """
    au, av = _half_flux(up, vp, dt, grid)
    # -up + 0.5*dt*(prev fluxes) = (au - up) - up = au - 2*up
    cp_u = (au - 2.0 * up - src_sk - lbc_sk) * valid
    cp_v = (av - 2.0 * vp) * valid
    r0_u = au * valid + cp_u
    r0_v = av * valid + cp_v
    return cp_u, cp_v, r0_u, r0_v


def skewed_residual_iter(u, v, cp_u, cp_v, dt, grid: Grid2D, valid):
    """Per-iteration CN residual from the step constant; the same values
    as skewed_residual (tested)."""
    au, av = _half_flux(u, v, dt, grid)
    return au * valid + cp_u, av * valid + cp_v


def norm2(ru, rv):
    """The Newton loop's residual norm sqrt(sum ru^2 + sum rv^2)."""
    return torch.sqrt(torch.sum(ru * ru) + torch.sum(rv * rv))


def skewed_step_constant_norm_ref(up, vp, dt, grid: Grid2D, src_sk, lbc_sk,
                                  valid):
    """skewed_step_constant and the norm of r0, as plain expressions in the
    inputs' dtype and on their device: (cp_u, cp_v, r0_u, r0_v,
    init_norm)."""
    cp_u, cp_v, r0_u, r0_v = skewed_step_constant(up, vp, dt, grid, src_sk,
                                                  lbc_sk, valid)
    return cp_u, cp_v, r0_u, r0_v, norm2(r0_u, r0_v)


def residual_workspace(lay: SkewedLayout, dtype, device):
    """The scratch that skewed_step_constant_norm and skewed_update_residual
    take for fields of `lay` in `dtype` on `device`: make one a run and pass
    it to every call. None on the CPU, whose plain versions need none; on
    every other device the residual kernel's (ops/cuda_skewed
    .ResidualWorkspace)."""
    if torch.device(device).type == "cpu":
        return None
    return ResidualWorkspace(lay, dtype, device)


def skewed_step_constant_norm(up, vp, dt, grid: Grid2D, lay: SkewedLayout,
                              src_sk, lbc_sk, valid, *, workspace):
    """A step's constant, its residual at (up, vp) and that residual's norm
    on padded skewed inputs: CPU tensors take
    skewed_step_constant_norm_ref, every other device one launch of the
    residual kernel (ops/cuda_skewed.step_constant_cuda, scratch in
    `workspace`, from residual_workspace), which raises on what it cannot
    run."""
    if up.device.type == "cpu":
        return skewed_step_constant_norm_ref(up, vp, dt, grid, src_sk,
                                             lbc_sk, valid)
    return step_constant_cuda(up, vp, dt, grid, lay, src_sk, lbc_sk,
                              workspace=workspace)


def skewed_update_residual_ref(u, v, du, dv, cp_u, cp_v, dt, grid: Grid2D,
                               valid, *, init_norm, rn_prev, cutoff):
    """One Newton update as plain expressions in the inputs' dtype and on
    their device: u' = u - du, v' = v - dv (none when du is None), the
    residual at (u', v') from the step constant, its norm rn and the stop
    test rn / init_norm < cutoff, or rn > 0.99 * rn_prev (left out when
    rn_prev is None). Returns (u', v', ru, rv, rn, stop)."""
    if du is not None:
        u = u - du
        v = v - dv
    ru, rv = skewed_residual_iter(u, v, cp_u, cp_v, dt, grid, valid)
    rn = norm2(ru, rv)
    stop = rn / init_norm < cutoff
    if rn_prev is not None:
        stop = stop | (rn > 0.99 * rn_prev)
    return u, v, ru, rv, rn, stop


def skewed_update_residual(u, v, du, dv, cp_u, cp_v, dt, grid: Grid2D,
                           lay: SkewedLayout, valid, *, init_norm, rn_prev,
                           cutoff, workspace):
    """One Newton update on padded skewed inputs (skewed_update_residual_
    ref): CPU tensors take the plain version, every other device one
    launch of the residual kernel (ops/cuda_skewed.update_residual_cuda,
    scratch in `workspace`, from residual_workspace), which raises on what
    it cannot run. Each launch counts one `fom.fused_residuals` while a
    recording is on (utils/profiling)."""
    if u.device.type == "cpu":
        return skewed_update_residual_ref(u, v, du, dv, cp_u, cp_v, dt, grid,
                                          valid, init_norm=init_norm,
                                          rn_prev=rn_prev, cutoff=cutoff)
    out = update_residual_cuda(u, v, du, dv, cp_u, cp_v, dt, grid, lay,
                               init_norm=init_norm, rn_prev=rn_prev,
                               cutoff=cutoff, workspace=workspace)
    profiling.count("fom.fused_residuals")
    return out


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """x[r] -> x[r-1] along the last axis, zero at r=0."""
    return F.pad(x, (1, 0))[..., :-1]


def solve_skewed_ref(su, sv, sfu, sfv, dt, grid: Grid2D,
                     lay: SkewedLayout):
    """Plain triangular solve on padded skewed inputs: a Python loop over
    the nd_pad diagonals, in the inputs' dtype and on their device.
    Entries off the band come out as exactly 0.

    Diagonal d reads diagonal d-1 at row r (west) and r-1 (south); the
    carry before diagonal 0 is zero.
    """
    kx = 0.5 * dt / grid.dx
    ky = 0.5 * dt / grid.dy
    valid = _band(lay, su.device)
    b11 = 1.0 + kx * su + 0.5 * ky * sv
    b12 = 0.5 * ky * su
    b21 = 0.5 * kx * sv
    b22 = 1.0 + ky * sv + 0.5 * kx * su
    det = b11 * b22 - b12 * b21

    sdu = torch.empty_like(sfu)
    sdv = torch.empty_like(sfv)
    du_p = dv_p = u_p = v_p = torch.zeros_like(su[0])
    for d in range(lay.nd_pad):
        u_s, v_s = _shift_down(u_p), _shift_down(v_p)    # south neighbors
        du_s, dv_s = _shift_down(du_p), _shift_down(dv_p)
        rhs_u = sfu[d] + kx * u_p * du_p + 0.5 * ky * (v_s * du_s
                                                       + u_s * dv_s)
        rhs_v = sfv[d] + 0.5 * kx * (v_p * du_p + u_p * dv_p) \
            + ky * v_s * dv_s
        du_p = torch.where(valid[d], (b22[d] * rhs_u - b12[d] * rhs_v)
                           / det[d], 0.0)
        dv_p = torch.where(valid[d], (b11[d] * rhs_v - b21[d] * rhs_u)
                           / det[d], 0.0)
        sdu[d] = du_p
        sdv[d] = dv_p
        u_p, v_p = su[d], sv[d]
    return sdu, sdv


def solve_skewed(su, sv, sfu, sfv, dt, grid: Grid2D, lay: SkewedLayout):
    """Triangular solve on padded skewed inputs (nd_pad, ny_pad): CPU
    tensors take solve_skewed_ref, every other device the wavefront
    kernel, which raises on what it cannot run."""
    if su.device.type == "cpu":
        return solve_skewed_ref(su, sv, sfu, sfv, dt, grid, lay)
    return solve_skewed_cuda(su, sv, sfu, sfv, dt, grid, lay)


def segment_length(lay: SkewedLayout, n_seg: int) -> int:
    """Diagonals owned by each of `n_seg` segments: ceil(nd_pad / n_seg)."""
    if n_seg < 1:
        raise ValueError(f"n_seg must be >= 1, got {n_seg}")
    return -(-lay.nd_pad // n_seg)


def solve_skewed_seg_ref(su, sv, sfu, sfv, dt, grid: Grid2D,
                         lay: SkewedLayout, *, n_seg: int, overlap: int):
    """Plain overlapping-segment solve on padded skewed inputs, in the
    inputs' dtype and on their device.

    Segment g owns diagonals [g*seg_len, (g+1)*seg_len) and starts from a
    zero carry at diagonal g*seg_len - overlap (diagonals below 0 are
    masked, so segment 0 is exact); its warm-up diagonals are discarded.
    The coupling between diagonals is contractive, so the truncation
    error is ~rho^overlap. One loop of seg_len + overlap steps runs all
    segments at once on (n_seg, ny_pad) slabs. Entries off the band are
    exactly 0; n_seg=1, overlap=0 is solve_skewed_ref.
    """
    if overlap < 0:
        raise ValueError(f"overlap must be >= 0, got {overlap}")
    seg_len = segment_length(lay, n_seg)
    kx = 0.5 * dt / grid.dx
    ky = 0.5 * dt / grid.dy
    device = su.device
    valid = _band(lay, device)
    start = torch.arange(n_seg, device=device) * seg_len
    zero = torch.zeros((), dtype=su.dtype, device=device)

    sdu = torch.empty_like(sfu)
    sdv = torch.empty_like(sfv)
    du_p = dv_p = u_p = v_p = torch.zeros((n_seg, lay.ny_pad),
                                          dtype=su.dtype, device=device)
    for j in range(seg_len + overlap):
        d = start - overlap + j                      # (n_seg,)
        live = (d >= 0) & (d < lay.nd_pad)
        dc = d.clamp(0, lay.nd_pad - 1)
        band = valid[dc] & live[:, None]
        u = torch.where(live[:, None], su[dc], zero)
        v = torch.where(live[:, None], sv[dc], zero)
        b11 = 1.0 + kx * u + 0.5 * ky * v
        b12 = 0.5 * ky * u
        b21 = 0.5 * kx * v
        b22 = 1.0 + ky * v + 0.5 * kx * u
        det = b11 * b22 - b12 * b21
        u_s, v_s = _shift_down(u_p), _shift_down(v_p)
        du_s, dv_s = _shift_down(du_p), _shift_down(dv_p)
        rhs_u = sfu[dc] + kx * u_p * du_p + 0.5 * ky * (v_s * du_s
                                                        + u_s * dv_s)
        rhs_v = sfv[dc] + 0.5 * kx * (v_p * du_p + u_p * dv_p) \
            + ky * v_s * dv_s
        du_p = torch.where(band, (b22 * rhs_u - b12 * rhs_v) / det, zero)
        dv_p = torch.where(band, (b11 * rhs_v - b21 * rhs_u) / det, zero)
        own = live & (d >= start)
        sdu[d[own]] = du_p[own]
        sdv[d[own]] = dv_p[own]
        u_p, v_p = u, v
    return sdu, sdv


def solve_skewed_seg(su, sv, sfu, sfv, dt, grid: Grid2D, lay: SkewedLayout,
                     *, n_seg: int, overlap: int):
    """Overlapping-segment solve on padded skewed inputs (nd_pad, ny_pad):
    CPU tensors take solve_skewed_seg_ref, every other device the
    segmented wavefront kernel, which raises on what it cannot run."""
    if su.device.type == "cpu":
        return solve_skewed_seg_ref(su, sv, sfu, sfv, dt, grid, lay,
                                    n_seg=n_seg, overlap=overlap)
    return solve_skewed_seg_cuda(su, sv, sfu, sfv, dt, grid, lay,
                                 n_seg=n_seg, overlap=overlap)
