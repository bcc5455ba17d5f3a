"""Plain reference of the ECSW hyper-reduced LSPG model (HPROM) of the 2D
inviscid Burgers equations.

From the POD basis V (2n, k), the ECSW weight field (n,) and the mu
points alone: the sampled cells are the cells of nonzero weight, and the
reduced state y gives the fields at each sampled cell and at its west and
south neighbours (zero outside the domain). Each time step takes
Gauss-Newton iterations on the weighted residual W r(V y; V y_prev):

    dy = argmin || W (J V dy + r) ||,   y <- y + dy

with the normal equations solved by `solve_iters` conjugate-gradient
steps, at most `unroll_its` updates a step, and the reference's stopping
rules checked before each update: ||W r|| / ||W r(y_prev)|| < cutoff, or,
once an update was made, |rn_prev - rn| / rn_prev < min_delta. Batched
over the mu points; nothing here reads the device back.
"""

from __future__ import annotations

import torch

from gpubench.reference.burgers import Problem


def sampled_blocks(prob: Problem, basis, weights):
    """(P (6, n_s, k), w (n_s,), cells (n_s,)) from the basis and the full
    weight field: the basis rows of u and v at each sampled cell, its west
    and its south neighbour, zero where the neighbour lies outside."""
    n, nx = prob.n_cells, prob.nx
    cells = torch.nonzero(weights != 0).reshape(-1)
    r, c = cells // nx, cells % nx
    west = torch.where(c > 0, cells - 1, cells)
    south = torch.where(r > 0, cells - nx, cells)
    has_w = (c > 0).to(basis.dtype)[:, None]
    has_s = (r > 0).to(basis.dtype)[:, None]
    vu, vv = basis[:n], basis[n:]
    p = torch.stack((vu[cells], vu[west] * has_w, vu[south] * has_s,
                     vv[cells], vv[west] * has_w, vv[south] * has_s))
    return p, weights[cells], cells


def cg(g, b, iters: int):
    """`iters` conjugate-gradient steps on g x = b, batched (B, k, k),
    (B, k); a system whose residual or curvature has underflowed stays
    where it is."""
    x = torch.zeros_like(b)
    r, p = b, b
    rs = (r * r).sum(-1)
    tiny = torch.finfo(b.dtype).tiny
    for _ in range(iters):
        gp = torch.bmm(g, p[:, :, None])[:, :, 0]
        den = (p * gp).sum(-1)
        live = (rs > tiny) & (den > tiny)
        alpha = torch.where(live, rs / torch.where(live, den, 1.0), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * gp
        rs_new = (r * r).sum(-1)
        beta = torch.where(live, rs_new / torch.where(live, rs, 1.0), 0.0)
        p = r + beta[:, None] * p
        rs = rs_new
    return x


def hprom_trajectories(prob: Problem, basis, weights, mus, num_steps: int,
                       *, unroll_its: int = 3, solve_iters: int = 24,
                       cutoff: float = 1e-5, min_delta: float = 0.1,
                       dtype=torch.float64):
    """Reduced trajectories of B mu points from w0 = 1, in `dtype`.

    Returns (red (B, k, num_steps + 1), its (B,)): the reduced
    coordinates and the Gauss-Newton updates."""
    device = basis.device
    basis = basis.to(dtype)
    p, w, cells = sampled_blocks(prob, basis, weights.to(dtype))
    k = basis.shape[1]
    mus = torch.as_tensor(mus, dtype=dtype, device=device).reshape(-1, 2)
    nb = len(mus)
    xs = prob.xc(dtype, device)[cells % prob.nx]
    force = prob.dt * 0.02 * torch.exp(mus[:, 1:2] * xs[None, :]) \
        + ((cells % prob.nx) == 0).to(dtype)[None, :] \
        * (0.5 * prob.dt * mus[:, 0:1] ** 2 / prob.dx)
    hx = 0.5 * prob.dt / prob.dx
    hy = 0.5 * prob.dt / prob.dy
    p_flat = p.reshape(6 * p.shape[1], k)

    def fields(y):
        return (y @ p_flat.T).reshape(nb, 6, -1).unbind(1)

    def residual(s, sp):
        u, uw, us, v, vw, vs = s
        pu, puw, pus, pv, pvw, pvs = sp
        fuv = 0.5 * (u * v + pu * pv)
        ru = u - pu + hx * 0.5 * ((u * u + pu * pu) - (uw * uw + puw * puw)) \
            + hy * (fuv - 0.5 * (us * vs + pus * pvs)) - force
        rv = v - pv + hy * 0.5 * ((v * v + pv * pv) - (vs * vs + pvs * pvs)) \
            + hx * (fuv - 0.5 * (uw * vw + puw * pvw))
        return ru, rv

    def system(y, sp):
        s = fields(y)
        u, uw, us, v, vw, vs = s
        ru, rv = residual(s, sp)
        zero = torch.zeros_like(u)
        # d(ru, rv) / d(u, uw, us, v, vw, vs) at each sampled cell
        cu = (1.0 + hx * u + 0.5 * hy * v, -hx * uw, -0.5 * hy * vs,
              0.5 * hy * u, zero, -0.5 * hy * us)
        cv = (0.5 * hx * v, -0.5 * hx * vw, zero,
              1.0 + hy * v + 0.5 * hx * u, -0.5 * hx * uw, -hy * vs)
        ju = torch.einsum("pbn,pnk->bnk", torch.stack(cu) * w, p)
        jv = torch.einsum("pbn,pnk->bnk", torch.stack(cv) * w, p)
        a = torch.cat((ju, jv), 1)
        rw = torch.cat((ru * w, rv * w), 1)
        g = torch.bmm(a.transpose(1, 2), a)
        b = -torch.bmm(a.transpose(1, 2), rw[:, :, None])[:, :, 0]
        return cg(g, b, solve_iters), torch.linalg.vector_norm(rw, dim=1)

    y = (basis.T @ torch.ones(basis.shape[0], dtype=dtype,
                              device=device)).expand(nb, k).clone()
    red = torch.empty((nb, num_steps + 1, k), dtype=dtype, device=device)
    red[:, 0] = y
    its = torch.zeros(nb, dtype=torch.int64, device=device)
    for t in range(num_steps):
        sp = fields(y)
        ru0, rv0 = residual(sp, sp)
        init = torch.sqrt((ru0 * w).pow(2).sum(1) + (rv0 * w).pow(2).sum(1))
        done = torch.zeros(nb, dtype=torch.bool, device=device)
        it = torch.zeros(nb, dtype=torch.int64, device=device)
        rn_prev = init
        for _ in range(unroll_its):
            dy, rn = system(y, sp)
            stag = (it > 0) & (torch.abs(rn_prev - rn) / rn_prev < min_delta)
            stop = done | (rn / init < cutoff) | stag
            y = torch.where(stop[:, None], y, y + dy)
            it += (~stop).long()
            rn_prev = torch.where(done, rn_prev, rn)
            done = stop
        its += it
        red[:, t + 1] = y
    return red.transpose(1, 2), its
