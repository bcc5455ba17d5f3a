"""Plain reference of the full-grid LSPG PROM of the 2D inviscid Burgers
equations (the source's run_prom.py and its gauss_newton_LSPG).

From the POD basis V (2n, k) and one mu point alone: each time step takes
Gauss-Newton iterations on the full-grid Crank-Nicolson residual
r(V y; V y_prev) (burgers.residual), each solving the least-squares
problem of the residual's Jacobian applied to the basis

    dy = argmin || J(V y) V dy + r ||   (torch.linalg.lstsq),  y <- y + dy

with the source's rules checked before each update: ||r|| / ||r(y_prev)||
< cutoff, or, once an update was made, |rn_prev - rn| / rn_prev <
min_delta; at most `max_its` updates a step. Nothing is masked: each step
iterates to its own stop. J V is built by the upwind stencil in blocks of
modes, so that the intermediates of a block stay small beside J V itself.
Float32 matrix products are kept out of TF32.
"""

from __future__ import annotations

import torch

from gpubench.reference import burgers
from gpubench.reference.burgers import Problem


def jv_rows(prob: Problem, u, v, basis, out, mode_block: int = 32):
    """J(u, v) V into `out` (2n, k): u, v the (1, ny, nx) fields, V the
    (2n, k) basis; the derivative of (ru, rv) in the direction of each
    mode, a block of `mode_block` modes at a time."""
    n, k = prob.n_cells, basis.shape[1]
    hx = 0.5 * prob.dt / prob.dx
    hy = 0.5 * prob.dt / prob.dy
    for j0 in range(0, k, mode_block):
        j1 = min(k, j0 + mode_block)
        m = j1 - j0
        bu = basis[:n, j0:j1].T.reshape(m, prob.ny, prob.nx)
        bv = basis[n:, j0:j1].T.reshape(m, prob.ny, prob.nx)
        uu = u * bu
        vv = v * bv
        cross = v * bu + u * bv
        ju = bu + hx * (uu - burgers._west(uu)) \
            + 0.5 * hy * (cross - burgers._south(cross))
        jv = bv + hy * (vv - burgers._south(vv)) \
            + 0.5 * hx * (cross - burgers._west(cross))
        out[:n, j0:j1] = ju.reshape(m, n).T
        out[n:, j0:j1] = jv.reshape(m, n).T
    return out


def lspg_trajectory(prob: Problem, basis, mu, num_steps: int, *,
                    max_its: int = 20, cutoff: float = 1e-5,
                    min_delta: float = 0.1, w0: float = 1.0,
                    dtype=torch.float64, mode_block: int = 32):
    """The reduced trajectory of one mu point from w = w0, in `dtype`.

    Returns (red (k, num_steps + 1), its (num_steps,) int64 on the host):
    the reduced coordinates, y_0 = V^T w0, and each step's Gauss-Newton
    updates."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = basis.device
    basis = basis.to(dtype)
    n, k = prob.n_cells, basis.shape[1]
    shape = (1, prob.ny, prob.nx)
    force = burgers.forcing(prob, [mu], dtype, device)
    jv = torch.empty((2 * n, k), dtype=dtype, device=device)

    def fields(y):
        w = basis @ y
        return w[:n].reshape(shape), w[n:].reshape(shape)

    def residual(u, v, up, vp):
        ru, rv = burgers.residual(u, v, up, vp, force, prob)
        return torch.cat((ru.reshape(-1), rv.reshape(-1)))

    y = basis.T @ torch.full((2 * n,), w0, dtype=dtype, device=device)
    red = torch.empty((k, num_steps + 1), dtype=dtype, device=device)
    red[:, 0] = y
    its = torch.zeros(num_steps, dtype=torch.int64)
    for t in range(num_steps):
        up, vp = fields(y)
        u, v = up, vp
        r = residual(u, v, up, vp)
        init = float(torch.linalg.vector_norm(r))
        rn_prev = None
        for it in range(max_its):
            if it > 0:
                u, v = fields(y)
                r = residual(u, v, up, vp)
            rn = float(torch.linalg.vector_norm(r))
            if rn / init < cutoff:
                break
            if it > 0 and abs(rn_prev - rn) / rn_prev < min_delta:
                break
            jv_rows(prob, u, v, basis, jv, mode_block)
            dy = torch.linalg.lstsq(jv, -r[:, None]).solution[:, 0]
            y = y + dy
            its[t] += 1
            rn_prev = rn
        red[:, t + 1] = y
    return red, its
