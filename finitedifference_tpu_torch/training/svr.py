"""Epsilon-support-vector regression with an RBF kernel (PyTorch), every
output at once.

The JAX package fits one sklearn SVR per secondary mode (libsvm). The
port solves the same dual problem with libsvm's algorithm, written out
and batched over the outputs, on the device the inputs lie on: all modes
share the training inputs, so they share one kernel matrix, and each
SMO iteration is a few elementwise passes over (n_out, 2 l) tensors.

The dual of epsilon-SVR over the 2 l variables a = (alpha, alpha*) is

    min 1/2 a^T Q a + p^T a,   s^T a = 0,   0 <= a <= C,
    s = (+1, ..., -1, ...),  p = (eps - y, eps + y),
    Q_ij = s_i s_j K(x_i, x_j),

and libsvm's solver (Fan, Chen and Lin 2005) repeats: pick i maximizing
-s_i G_i over the variables that may move up, pick j by the second-order
gain among those that may move down, update (a_i, a_j) in closed form
with its clipping, update the gradient G = Q a + p; it stops when the
maximal violation Gmax + Gmax2 falls below tol. As in libsvm, K is held
in float32 (its Qfloat), the kernel is exp(-gamma (|x_i|^2 + |x_j|^2 -
2 x_i.x_j)), ties go to the last index, and rho is the mean of s G over
the free variables (the middle of the bounds when none is free). Not
copied: libsvm's shrinking heuristic, which only skips variables; it
changes the iterates, so the solution agrees with sklearn's default to
the stopping tolerance, and with sklearn's shrinking=False to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TAU = 1e-12
TOL = 1e-3           # libsvm's stopping tolerance (sklearn's tol)
CHECK_EVERY = 64     # iterations between two reads of the stopping flags


class SVRFit(NamedTuple):
    dual_coef: torch.Tensor   # (n_out, l): alpha - alpha* per output
    intercept: torch.Tensor   # (n_out,): -rho
    n_iter: torch.Tensor      # (n_out,) SMO iterations


def _dot(a, b):
    """a_i . b_j for all pairs, summed over the features in order (the
    rounding of libsvm's dot, which a matrix product would not keep)."""
    d = a[:, None, 0] * b[None, :, 0]
    for p in range(1, a.shape[1]):
        d = d + a[:, None, p] * b[None, :, p]
    return d


def rbf_kernel(x, gamma: float):
    """libsvm's RBF kernel matrix exp(-gamma (|x_i|^2 + |x_j|^2 -
    2 x_i.x_j)) of the rows of x."""
    dot = _dot(x, x)
    sq = torch.diagonal(dot)
    return torch.exp(-gamma * (sq[:, None] + sq[None, :] - 2 * dot))


def _last_argmax(v):
    """Index of the last maximum along dim 1 (libsvm's >= scan)."""
    n = v.shape[1]
    return n - 1 - torch.argmax(torch.flip(v, dims=(1,)), dim=1)


def fit_svr(x, y, c: float, epsilon: float, gamma: float) -> SVRFit:
    """Fit one epsilon-SVR per column of y (l, n_out) on the inputs x
    (l, n_p), kernel exp(-gamma ||x - x'||^2), box C, tube epsilon, on
    x's device. The loop reads back whether any output still moves once
    every CHECK_EVERY iterations; an output that has stopped is left as
    it is. On a CUDA device the CHECK_EVERY iterations between two
    read-backs replay as one CUDA graph (the same kernels in the same
    order: the iterations' results do not change)."""
    dev, dt = x.device, torch.float64
    l, n_out = y.shape
    k = rbf_kernel(x, gamma)
    kq = k.to(torch.float32).to(dt)                         # Qfloat
    qd = torch.diagonal(k).repeat(2)                        # double
    s = torch.cat([torch.ones(l, dtype=dt, device=dev),
                   -torch.ones(l, dtype=dt, device=dev)])
    yt = y.T.to(dt)
    g = torch.cat([epsilon - yt, epsilon + yt], dim=1)      # G = p
    alpha = torch.zeros(n_out, 2 * l, dtype=dt, device=dev)
    rows = torch.arange(n_out, device=dev)
    active = torch.ones(n_out, dtype=torch.bool, device=dev)
    n_iter = torch.zeros(n_out, dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)

    def q_row(i):
        """Q[i, :] for each output's index i: s_i s K(x_{i mod l}, .)."""
        k = kq[i % l]
        return (s[i][:, None] * s[None, :]) * torch.cat([k, k], dim=1)

    def step():
        """One SMO iteration of every output that still moves, in place."""
        upper = alpha >= c
        lower = alpha <= 0
        # i: max of -s G over the variables that may move up
        may_up = torch.where(s > 0, ~upper, ~lower)
        v = torch.where(may_up, -s * g, -inf)
        i = _last_argmax(v)
        gmax = v[rows, i]
        qi = q_row(i)
        # j: the second-order gain over the variables that may move down
        may_down = torch.where(s > 0, ~lower, ~upper)
        sg = s * g
        gmax2 = torch.where(may_down, sg, -inf).max(dim=1).values
        grad_diff = gmax[:, None] + sg
        quad = qd[i][:, None] + qd[None, :] \
            - 2.0 * s[i][:, None] * s[None, :] * qi
        quad = torch.where(quad > 0, quad, TAU)
        obj = torch.where(may_down & (grad_diff > 0),
                          -(grad_diff * grad_diff) / quad, inf)
        j = _last_argmax(-obj)
        moving = active & ~((gmax + gmax2 < TOL)
                            | torch.isinf(obj[rows, j]))
        active.copy_(moving)
        n_iter.add_(moving)

        # the two-variable update with libsvm's clipping
        a_i, a_j = alpha[rows, i], alpha[rows, j]
        g_i, g_j = g[rows, i], g[rows, j]
        q_ij = qi[rows, j]
        opposite = s[i] != s[j]
        quad2 = qd[i] + qd[j] + torch.where(opposite, 2 * q_ij, -2 * q_ij)
        quad2 = torch.where(quad2 > 0, quad2, TAU)
        # s_i != s_j: a_i and a_j move together, their difference fixed
        delta = (-g_i - g_j) / quad2
        diff = a_i - a_j
        ai, aj = a_i + delta, a_j + delta
        fix = (diff > 0) & (aj < 0)
        ai, aj = torch.where(fix, diff, ai), torch.where(fix, 0.0, aj)
        fix = (diff <= 0) & (ai < 0)
        ai, aj = torch.where(fix, 0.0, ai), torch.where(fix, -diff, aj)
        fix = (diff > 0) & (ai > c)
        ai, aj = torch.where(fix, c, ai), torch.where(fix, c - diff, aj)
        fix = (diff <= 0) & (aj > c)
        ai, aj = torch.where(fix, c + diff, ai), torch.where(fix, c, aj)
        opp_i, opp_j = ai, aj
        # s_i == s_j: their sum fixed
        delta = (g_i - g_j) / quad2
        total = a_i + a_j
        ai, aj = a_i - delta, a_j + delta
        fix = (total > c) & (ai > c)
        ai, aj = torch.where(fix, c, ai), torch.where(fix, total - c, aj)
        fix = (total <= c) & (aj < 0)
        ai, aj = torch.where(fix, total, ai), torch.where(fix, 0.0, aj)
        fix = (total > c) & (aj > c)
        ai, aj = torch.where(fix, total - c, ai), torch.where(fix, c, aj)
        fix = (total <= c) & (ai < 0)
        ai, aj = torch.where(fix, 0.0, ai), torch.where(fix, total, aj)
        ai = torch.where(opposite, opp_i, ai)
        aj = torch.where(opposite, opp_j, aj)
        ai = torch.where(moving, ai, a_i)
        aj = torch.where(moving, aj, a_j)

        d_i, d_j = ai - a_i, aj - a_j
        g.add_(qi * d_i[:, None] + q_row(j) * d_j[:, None])
        alpha.index_put_((rows, i), ai)
        alpha.index_put_((rows, j), aj)

    def chunk():
        for _ in range(CHECK_EVERY):
            step()

    if dev.type == "cuda":
        # one chunk run eagerly on a side stream warms the allocator up,
        # then the next is captured; both are real iterations
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            chunk()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            chunk()
        run_chunk = graph.replay
    else:
        run_chunk = chunk
    while bool(active.any()):
        run_chunk()

    # rho: the mean of s G over the free variables, else the bounds' middle
    upper = alpha >= c
    lower = alpha <= 0
    sg = s * g
    free = ~upper & ~lower
    n_free = free.sum(dim=1)
    ub_set = (upper & (s < 0)) | (lower & (s > 0))
    lb_set = (upper & (s > 0)) | (lower & (s < 0))
    ub = torch.where(ub_set, sg, inf).min(dim=1).values
    lb = torch.where(lb_set, sg, -inf).max(dim=1).values
    rho = torch.where(n_free > 0,
                      torch.where(free, sg, 0.0).sum(dim=1)
                      / n_free.clamp(min=1), (ub + lb) / 2)
    return SVRFit(dual_coef=alpha[:, :l] - alpha[:, l:], intercept=-rho,
                  n_iter=n_iter)


def svr_predict(fit: SVRFit, x_train, x, gamma: float):
    """sum_i coef_ji exp(-gamma ||x - x_i||^2) + b_j for each row of x:
    (n, n_out)."""
    d2 = torch.sum((x[:, None, :] - x_train[None, :, :]) ** 2, dim=-1)
    return torch.exp(-gamma * d2) @ fit.dual_coef.T + fit.intercept
