"""Exact wavefront solver for the implicit Burgers Jacobian (PyTorch).

Counterpart of finitedifference_tpu/ops/wavefront.py. The CN/upwind
Jacobian J(w) couples each cell only to itself, its west neighbor
(r, c-1) and its south neighbor (r-1, c), for both u and v. In
cell-lexicographic order J is block lower triangular with 2x2 diagonal
blocks, so one forward substitution solves it exactly.

The substitution runs as an anti-diagonal wavefront: all cells with
r + c = d are independent given diagonal d-1. Fields are kept in a
*skewed* layout S[d, r] = X[r, d - r] so each step is a contiguous
vector op. Per-cell blocks, with k = 0.5*dt:

    B(r,c)       = [[1 + k*u/dx + k/2*v/dy,  k/2*u/dy],
                    [k/2*v/dx,               1 + k*v/dy + k/2*u/dx]]
    West(r,c)    = [[-k*uW/dx,    0       ],
                    [-k/2*vW/dx, -k/2*uW/dx]]   (times delta at (r, c-1))
    South(r,c)   = [[-k/2*vS/dy, -k/2*uS/dy],
                    [0,          -k*vS/dy  ]]   (times delta at (r-1, c))

so  delta(r,c) = B^{-1} (f(r,c) - West*delta_W - South*delta_S).

The substitution itself, and skew/unskew, live in ops/skewed.py, where
the CPU runs it as a plain diagonal loop. On a CUDA tensor
solve_jacobian_wavefront is one launch of the hand-written kernel of
ops/cuda_wavefront.solve_unskewed_cuda, which walks the same diagonals on
the (ny, nx) fields in place, with no skew or unskew;
solve_jacobian_wavefront_ref, its plain version, skews, runs the loop and
unskews.
"""

from __future__ import annotations

import torch.nn.functional as F

from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.cuda_wavefront import solve_unskewed_cuda
# skew and unskew are part of this module's interface, as in the JAX package
from finitedifference_tpu_torch.ops.skewed import (  # noqa: F401
    from_skewed,
    make_layout,
    skew,
    solve_skewed_ref,
    to_skewed,
    unskew,
)


def solve_jacobian_wavefront(u, v, fu, fv, dt, grid: Grid2D):
    """Solve J(u, v) [du; dv] = [fu; fv] exactly.

    All inputs (ny, nx); returns (du, dv) each (ny, nx), in the inputs'
    dtype. CPU tensors take solve_jacobian_wavefront_ref; every other
    device the wavefront kernel on the fields as they are
    (solve_unskewed_cuda: one launch, contiguous inputs of one dtype,
    float32 or float64), which raises on what it cannot run.
    """
    if u.device.type == "cpu":
        return solve_jacobian_wavefront_ref(u, v, fu, fv, dt, grid)
    return solve_unskewed_cuda(u, v, fu, fv, dt, grid)


def solve_jacobian_wavefront_ref(u, v, fu, fv, dt, grid: Grid2D):
    """Plain version of solve_jacobian_wavefront: the fields skewed and
    padded once, ops/skewed.solve_skewed_ref's diagonal loop, the results
    unskewed. No diagonal padding: the loop walks any number of
    diagonals."""
    lay = make_layout(grid, block=1)
    sdu, sdv = solve_skewed_ref(*(to_skewed(x, lay) for x in (u, v, fu, fv)),
                                dt, grid, lay)
    return from_skewed(sdu, lay), from_skewed(sdv, lay)


def solve_jacobian_flat(w, f, dt, grid: Grid2D):
    """Flat-state wrapper: solve J(w) x = f with w, f of shape (2n,), of
    any strides (the fields go to the solve contiguous)."""
    u, v = grid.split_fields(w.contiguous())
    fu, fv = grid.split_fields(f.contiguous())
    du, dv = solve_jacobian_wavefront(u, v, fu, fv, dt, grid)
    return grid.merge_fields(du, dv)


def solve_jacobian_sweeps(u, v, fu, fv, dt, grid: Grid2D, num_sweeps=None):
    """Iterative triangular solve by block-Jacobi forward sweeps.

    J = B + L with L strictly (block-)lower and nilpotent of index
    nx+ny-1, so delta <- B^{-1} (f - L delta) converges exactly after
    nx+ny-1 sweeps, and geometrically (ratio ~ CFL/(1+CFL)) long before
    that. The default sweep count is enough for ~1e-14 with CFL < 1.
    """
    k = 0.5 * dt
    kx, ky = k / grid.dx, k / grid.dy

    b11 = 1.0 + kx * u + 0.5 * ky * v
    b12 = 0.5 * ky * u
    b21 = 0.5 * kx * v
    b22 = 1.0 + ky * v + 0.5 * kx * u
    det = b11 * b22 - b12 * b21

    u_w, v_w = _west(u), _west(v)
    u_s, v_s = _south(u), _south(v)

    if num_sweeps is None:
        num_sweeps = 64

    def binv(ru, rv):
        return (b22 * ru - b12 * rv) / det, (b11 * rv - b21 * ru) / det

    du, dv = binv(fu, fv)
    for _ in range(num_sweeps):
        du_w, dv_w = _west(du), _west(dv)
        du_s, dv_s = _south(du), _south(dv)
        rhs_u = fu + kx * u_w * du_w + 0.5 * ky * (v_s * du_s + u_s * dv_s)
        rhs_v = fv + 0.5 * kx * (v_w * du_w + u_w * dv_w) + ky * v_s * dv_s
        du, dv = binv(rhs_u, rhs_v)
    return du, dv


def _west(f):
    return F.pad(f, (1, 0))[..., :-1]


def _south(f):
    return F.pad(f, (0, 0, 1, 0))[..., :-1, :]
