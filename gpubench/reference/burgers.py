"""Plain reference of the implicit 2D inviscid Burgers full-order model.

The semantics of SADPR/FiniteDifference (BurgersFD_CleanCoarse/Fine):
first-order upwind differences with zero ghosts at x < 0 and y < 0, the
Crank-Nicolson residual

    ru = u - up + dt/2 (Dx Fu + Dy Fuv) - src - lbc
    rv = v - vp + dt/2 (Dy Fv + Dx Fuv)

with Fu = (u^2 + up^2)/2, Fv = (v^2 + vp^2)/2, Fuv = (u v + up vp)/2,
src = dt * 0.02 * exp(mu2 * x) and lbc = dt/2 mu1^2 / dx on the x = 0
column; Newton steps until ||r|| / ||r(wp)|| < cutoff or the residual
stops falling (||r|| > 0.99 ||r_prev||), each solving J dw = r exactly.

J couples a cell to itself, its west and its south neighbour, so it is
block lower triangular with 2x2 blocks in cell order and one forward
substitution over the anti-diagonals solves it. Written here from those
equations, with none of the measured program's code: the substitution is
one small batched matrix product per anti-diagonal, dw(d) = g(d) + M(d)
[dw_south; dw_west], where g = B^-1 r and M = B^-1 N hold the cell's 2x2
block B and its neighbour couplings N. On a CUDA device the whole solve
is captured once in a CUDA graph and replayed: the same kernels, without
the host's launch cost.

The overlapping-segment solve (`n_seg` > 0) is the same substitution
started afresh from a zero carry `overlap` diagonals before each
segment's first diagonal; segments own ceil(nd_pad / n_seg) diagonals of
the diagonal axis padded to a multiple of `diag_block`.

Fields are (B, ny, nx), a batch of independent problems (one per mu
point), x the fastest axis; the state w is cat(u.ravel(), v.ravel()).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Problem:
    nx: int
    ny: int
    dt: float
    x_low: float = 0.0
    x_up: float = 100.0
    y_low: float = 0.0
    y_up: float = 100.0

    @property
    def dx(self) -> float:
        return (self.x_up - self.x_low) / self.nx

    @property
    def dy(self) -> float:
        return (self.y_up - self.y_low) / self.ny

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    def xc(self, dtype, device):
        edges = torch.linspace(self.x_low, self.x_up, self.nx + 1,
                               dtype=dtype, device=device)
        return 0.5 * (edges[1:] + edges[:-1])


def problem_from_config(cfg: dict) -> Problem:
    dom = cfg["domain"]
    return Problem(nx=cfg["num_cells"], ny=cfg["num_cells"], dt=cfg["dt"],
                   x_low=dom[0], x_up=dom[1], y_low=dom[2], y_up=dom[3])


def forcing(prob: Problem, mus, dtype, device):
    """src + lbc of each mu point: (B, ny, nx)."""
    mus = torch.as_tensor(mus, dtype=dtype, device=device).reshape(-1, 2)
    xc = prob.xc(dtype, device)
    src = prob.dt * 0.02 * torch.exp(mus[:, 1:2] * xc[None, :])
    out = src[:, None, :].expand(-1, prob.ny, -1).clone()
    out[:, :, 0] += 0.5 * prob.dt * mus[:, 0:1] ** 2 / prob.dx
    return out


def _west(f):
    return F.pad(f, (1, 0))[..., :-1]


def _south(f):
    return F.pad(f, (0, 0, 1, 0))[..., :-1, :]


def residual(u, v, up, vp, force, prob: Problem):
    """The Crank-Nicolson residual (ru, rv) of (B, ny, nx) fields."""
    h = 0.5 * prob.dt
    fu = 0.5 * (u * u + up * up)
    fv = 0.5 * (v * v + vp * vp)
    fuv = 0.5 * (u * v + up * vp)
    ru = u - up + h * ((fu - _west(fu)) / prob.dx
                       + (fuv - _south(fuv)) / prob.dy) - force
    rv = v - vp + h * ((fv - _south(fv)) / prob.dy
                       + (fuv - _west(fuv)) / prob.dx)
    return ru, rv


class TriangularSolve:
    """J(u, v) [du; dv] = [ru; rv] for a batch of B problems, by forward
    substitution over the anti-diagonals d = r + c (exact), or by the
    overlapping-segment approximation when n_seg > 0.

    Skewed layout: S[d, r] = X[r, d - r]. The west neighbour of (r, c) is
    S[d-1, r], the south one S[d-1, r-1]. Per diagonal, the carry P holds
    each problem's row of (du, dv) pairs after a zero row, so the pair of
    rows (r-1, r) of the previous diagonal, the cell's south and west
    neighbours, is one window of four values: X = [du_s, dv_s, du_w,
    dv_w]. The window that straddles two problems multiplies a zero M and
    lands on the next problem's zero row.
    """

    def __init__(self, prob: Problem, batch: int, dtype, device, *,
                 n_seg: int = 0, overlap: int = 0, diag_block: int = 128,
                 graph: bool | None = None):
        self.prob, self.batch = prob, batch
        self.dtype, self.device = dtype, torch.device(device)
        ny, nx = prob.ny, prob.nx
        nd = ny + nx - 1
        if n_seg:
            nd_pad = math.ceil(nd / diag_block) * diag_block
            seg_len = math.ceil(nd_pad / n_seg)
        else:
            n_seg, overlap, seg_len = 1, 0, nd
        self.n_seg, self.overlap, self.seg_len = n_seg, overlap, seg_len
        self.nd = nd
        steps = seg_len + overlap
        d = (torch.arange(n_seg, device=self.device)[None, :] * seg_len
             - overlap + torch.arange(steps, device=self.device)[:, None])
        # (steps, n_seg): the diagonal each segment works on at each step;
        # outside [0, nd) it is a zero carry
        self.live = (d >= 0) & (d < nd)
        self.dstep = d.clamp(0, nd - 1)
        own = (torch.arange(steps, device=self.device) >= overlap)[:, None] \
            & self.live
        # result diagonal d comes from (step, segment) of its owner
        idx = torch.nonzero(own)
        self.own_step = idx[torch.argsort(d[idx[:, 0], idx[:, 1]])]
        r = torch.arange(ny, device=self.device)
        dd = torch.arange(nd, device=self.device)[:, None]
        c = dd - r[None, :]
        self.band = (c >= 0) & (c < nx)                       # (nd, ny)
        # flat gather index of the skew; off the band, the appended zero
        self.skew_idx = torch.where(self.band, r[None, :] * nx + c.clamp(0),
                                    ny * nx)
        rr = torch.arange(ny, device=self.device)[:, None]
        cc = torch.arange(nx, device=self.device)[None, :]
        self.unskew_idx = (rr + cc) * ny + rr                 # (ny, nx)
        self.rows = n_seg * batch * (ny + 1)                 # carry rows
        if graph is None:
            graph = self.device.type == "cuda"
        self.graph = None
        if graph:
            self._capture()

    def _skew(self, x):
        """(B, ny, nx) -> (B, nd, ny)."""
        flat = F.pad(x.reshape(x.shape[0], -1), (0, 1))
        return flat[:, self.skew_idx]

    def _unskew(self, s):
        """(B, nd, ny) -> (B, ny, nx)."""
        return s.reshape(s.shape[0], -1)[:, self.unskew_idx]

    def _solve(self, u, v, ru, rv):
        p = self.prob
        kx = 0.5 * p.dt / p.dx
        ky = 0.5 * p.dt / p.dy
        su, sv, sfu, sfv = (self._skew(x) for x in (u, v, ru, rv))
        # neighbours on the previous diagonal: west S[d-1, r], south
        # S[d-1, r-1]; zero outside the band
        uw, vw = (F.pad(x, (0, 0, 1, 0))[:, :-1] for x in (su, sv))
        us, vs = (F.pad(x, (1, 0, 1, 0))[:, :-1, :-1] for x in (su, sv))
        b11 = 1.0 + kx * su + 0.5 * ky * sv
        b12 = 0.5 * ky * su
        b21 = 0.5 * kx * sv
        b22 = 1.0 + ky * sv + 0.5 * kx * su
        det = b11 * b22 - b12 * b21
        band = self.band.to(self.dtype)
        i11, i12 = b22 / det * band, -b12 / det * band
        i21, i22 = -b21 / det * band, b11 / det * band
        g = torch.stack((i11 * sfu + i12 * sfv, i21 * sfu + i22 * sfv), -1)
        # rhs = r + N [du_s, dv_s, du_w, dv_w]
        zero = torch.zeros_like(su)
        n = ((0.5 * ky * vs, 0.5 * ky * us, kx * uw, zero),
             (zero, ky * vs, 0.5 * kx * vw, 0.5 * kx * uw))
        m = torch.stack([torch.stack([ia * n[0][j] + ib * n[1][j]
                                      for j in range(4)], -1)
                         for ia, ib in ((i11, i12), (i21, i22))], -2)
        # (B, nd, ny, ...) -> per step (n_seg, B, ny + 1, ...) with the
        # zero row last: the straddling window's output row
        live = self.live.to(self.dtype)[:, :, None, None, None]
        gs = g[:, self.dstep].permute(1, 2, 0, 3, 4) * live
        ms = m[:, self.dstep].permute(1, 2, 0, 3, 4, 5) * live[..., None]
        gs = F.pad(gs, (0, 0, 0, 1)).reshape(len(gs), self.rows, 2, 1)
        ms = F.pad(ms, (0, 0, 0, 0, 0, 1)).reshape(len(ms), self.rows, 2, 4)
        carry = torch.zeros((len(gs) + 1, self.rows + 1, 2),
                            dtype=self.dtype, device=self.device)
        n_win = self.rows
        for j in range(len(gs)):
            prev = carry[j]
            win = prev.as_strided((n_win, 4, 1), (2, 1, 1),
                                  prev.storage_offset())
            torch.baddbmm(gs[j], ms[j], win,
                          out=carry[j + 1, 1:].view(n_win, 2, 1))
        # carry[j + 1, 1 + (seg * B + b) * (ny + 1) + r] is cell r of
        # problem b on diagonal dstep[j, seg]
        res = carry[1:, 1:].reshape(len(gs), self.n_seg, self.batch,
                                    self.prob.ny + 1, 2)[:, :, :, :-1]
        st, sg = self.own_step[:, 0], self.own_step[:, 1]
        out = res[st, sg]                                 # (nd, B, ny, 2)
        out = out.permute(1, 0, 2, 3)
        return self._unskew(out[..., 0]), self._unskew(out[..., 1])

    def _capture(self):
        shape = (self.batch, self.prob.ny, self.prob.nx)
        self.inputs = [torch.zeros(shape, dtype=self.dtype,
                                   device=self.device) for _ in range(4)]
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(2):
                self._solve(*self.inputs)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.outputs = self._solve(*self.inputs)
        self.graph = graph

    def __call__(self, u, v, ru, rv):
        if self.graph is None:
            return self._solve(u, v, ru, rv)
        for dst, src in zip(self.inputs, (u, v, ru, rv)):
            dst.copy_(src)
        self.graph.replay()
        return tuple(x.clone() for x in self.outputs)


def newton_trajectory(prob: Problem, mus, num_steps: int, *, dtype,
                      device, cutoff: float = 1e-12, max_its: int = 100,
                      n_seg: int = 0, overlap: int = 0,
                      diag_block: int = 128, on_step=None):
    """Implicit CN trajectories of B mu points from w0 = 1, in `dtype`.

    Each point steps with its own Newton loop (its own stop), batched:
    a point that has stopped is frozen while the others iterate.
    `on_step(i, u, v)` sees the (B, ny, nx) fields after step i (i = 0 is
    w0); nothing else is kept. Returns the Newton updates of each point
    (B,) as a list of ints.
    """
    mus = torch.as_tensor(mus, dtype=torch.float64).reshape(-1, 2)
    b = len(mus)
    force = forcing(prob, mus, dtype, device)
    solve = TriangularSolve(prob, b, dtype, device, n_seg=n_seg,
                            overlap=overlap, diag_block=diag_block)
    shape = (b, prob.ny, prob.nx)
    u = torch.ones(shape, dtype=dtype, device=device)
    v = torch.ones(shape, dtype=dtype, device=device)
    its = torch.zeros(b, dtype=torch.int64)
    if on_step is not None:
        on_step(0, u, v)

    def norm(ru, rv):
        return torch.sqrt((ru * ru).sum((1, 2)) + (rv * rv).sum((1, 2)))

    for i in range(num_steps):
        up, vp = u, v
        ru, rv = residual(u, v, up, vp, force, prob)
        init = norm(ru, rv)
        rn = init
        active = torch.ones(b, dtype=torch.bool, device=device)
        for _ in range(max_its):
            du, dv = solve(u, v, ru, rv)
            a = active[:, None, None]
            u = torch.where(a, u - du, u)
            v = torch.where(a, v - dv, v)
            ru, rv = residual(u, v, up, vp, force, prob)
            rn_new = norm(ru, rv)
            stop = (rn_new / init < cutoff) | (rn_new > 0.99 * rn)
            rn = torch.where(active, rn_new, rn)
            flags = torch.stack((active, stop)).cpu()
            its += flags[0].long()
            active = active & ~stop
            if not bool((flags[0] & ~flags[1]).any()):
                break
        if on_step is not None:
            on_step(i + 1, u, v)
    return its.tolist()
