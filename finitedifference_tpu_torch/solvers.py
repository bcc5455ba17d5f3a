"""Gauss-Newton solver family for LSPG-type reduced systems (PyTorch).

Counterpart of finitedifference_tpu/solvers.py. One generic Gauss-Newton
covers the reference's hand-copied variants (gauss_newton_LSPG /
_ECSW_2D / ..., hypernet2D.py:1859-2408):

    w  = decode(y)
    f  = res(w)                  (optionally ECSW-weighted)
    V  = dec_jac(y, w)
    dy = argmin || diag(wgt) (J(w) V dy + f) ||_2
    y += dy

with the reference's stopping rules: relative residual norm <
`relnorm_cutoff` (1e-5), or stagnation |r_{k-1} - r_k| / r_{k-1} <
`min_delta` (0.1), or `max_its` (20). The check comes *before* the
update, so a stopped iteration leaves y untouched (the reference's
`break`).

The JAX lax.while_loop becomes a Python loop that reads one boolean back
from the device per iteration; an iteration that stops skips the
least-squares solve it would have thrown away.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from finitedifference_tpu_torch.device import as_tensor


def _as_col(b):
    return (b[:, None], True) if b.dim() == 1 else (b, False)


def lstsq_normal(a: torch.Tensor, b: torch.Tensor,
                 ridge: float = 0.0) -> torch.Tensor:
    """Least squares via the normal equations (a^T a) x = a^T b with a
    Cholesky solve. Squares the condition number: meant for
    well-conditioned systems such as LSPG's J@V ~ V + O(dt)."""
    g = a.T @ a
    if ridge:
        g = g + ridge * torch.eye(g.shape[0], dtype=g.dtype,
                                  device=g.device)
    rhs, vec = _as_col(a.T @ b)
    x = torch.cholesky_solve(rhs, torch.linalg.cholesky(g))
    return x[:, 0] if vec else x


def cg_normal(g: torch.Tensor, rhs: torch.Tensor,
              iters: int = 24) -> torch.Tensor:
    """`iters` unrolled conjugate-gradient steps on g x = rhs, g SPD.

    The iterate freezes once the residual (or the curvature) underflows
    to the dtype's smallest normal: 0/0 would NaN-poison the remaining
    iterations. Every step is device work; nothing reads back."""
    x = torch.zeros_like(rhs)
    r = rhs
    p = r
    rs = torch.dot(r, r)
    tiny = torch.finfo(rhs.dtype).tiny
    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    for _ in range(iters):
        gp = g @ p
        denom = torch.dot(p, gp)
        live = (rs > tiny) & (denom > tiny)
        alpha = torch.where(live, rs / torch.where(live, denom, 1.0), zero)
        x = x + alpha * p
        r = r - alpha * gp
        rs_new = torch.dot(r, r)
        beta = torch.where(live, rs_new / torch.where(live, rs, 1.0), zero)
        p = r + beta * p
        rs = rs_new
    return x


def lstsq_normal_cg(a: torch.Tensor, b: torch.Tensor,
                    iters: int = 24) -> torch.Tensor:
    """Normal equations solved by `iters` unrolled CG steps (cg_normal)
    instead of a Cholesky factorization."""
    return cg_normal(a.T @ a, a.T @ b, iters)


def lstsq_svd(a: torch.Tensor, b: torch.Tensor,
              rcond: float = 1e-6) -> torch.Tensor:
    """Least squares via truncated SVD: singular directions below
    rcond * s_max are dropped, not inverted (for rank-deficient decoder
    Jacobians)."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    sinv = torch.where(s > rcond * s[0], 1.0 / s, torch.zeros_like(s))
    ub = u.T @ b
    scaled = sinv * ub if ub.dim() == 1 else sinv[:, None] * ub
    return vt.T @ scaled


def lstsq_qr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares via reduced QR. Assumes full column rank;
    underdetermined systems (m < n) take the min-norm solution via the QR
    of a^T."""
    m, n = a.shape
    if m >= n:
        q, r = torch.linalg.qr(a)
        rhs, vec = _as_col(q.T @ b)
        x = torch.linalg.solve_triangular(r, rhs, upper=True)
        return x[:, 0] if vec else x
    q, r = torch.linalg.qr(a.T)     # a = r^T q^T
    rhs, vec = _as_col(b)
    z = torch.linalg.solve_triangular(r.T, rhs, upper=False)
    x = q @ z
    return x[:, 0] if vec else x


LS_METHODS = {"normal": lstsq_normal, "svd": lstsq_svd,
              "cg": lstsq_normal_cg, "qr": lstsq_qr}


def ls_solver(ls_method: str):
    try:
        return LS_METHODS[ls_method]
    except KeyError:
        raise ValueError(f"unknown ls_method {ls_method!r}; use one of "
                         f"{sorted(LS_METHODS)}") from None


class GNResult(NamedTuple):
    y: torch.Tensor
    num_its: int
    resnorm: torch.Tensor
    init_norm: torch.Tensor


def gauss_newton(
    decode: Callable,
    dec_jac: Callable,
    res_fn: Callable,
    jac_apply: Callable,
    y0: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    max_its: int = 20,
    relnorm_cutoff: float = 1e-5,
    min_delta: float = 0.1,
    stepsize: float = 1.0,
    ls_dtype=None,
    ls_method: str = "qr",
    line_search: bool = False,
    decode_and_jac: Optional[Callable] = None,
    w0: Optional[torch.Tensor] = None,
) -> GNResult:
    """Generic Gauss-Newton for min_y || wgt * res(decode(y)) ||.

    decode:    y -> w               (full or sampled state)
    dec_jac:   (y, w) -> V          (d decode / d y)
    res_fn:    w -> f
    jac_apply: (w, V) -> J(w) @ V
    weights:   optional ECSW weights, same length as f.
    ls_dtype:  optional dtype of the least-squares solve only (residuals
               and stopping stay in y's dtype).
    ls_method: "qr", "normal", "cg" or "svd" (LS_METHODS).
    line_search: evaluate the update at stepsize * (1, 1/2, 1/4, 1/8),
               take the best residual decrease, stop if none decreases.
    decode_and_jac: optional fused y -> (w, V).
    w0:        optional decode(y0), when the caller already has it.

    num_its counts the iterations that updated y, as the JAX package's
    `it - done`.
    """
    solve_ls = ls_solver(ls_method)
    if w0 is None:
        w0 = decode(y0)
    f0 = res_fn(w0)
    if weights is not None:
        f0 = f0 * weights
    init_norm = torch.linalg.vector_norm(f0)

    y, it, done = y0, 0, False
    rn = torch.full((), float("inf"), dtype=init_norm.dtype,
                    device=init_norm.device)
    rn_prev = rn
    while not done and it < max_its:
        if decode_and_jac is not None:
            w, v = decode_and_jac(y)
        else:
            w = decode(y)
        f = res_fn(w)
        fw = f * weights if weights is not None else f
        rn = torch.linalg.vector_norm(fw)
        stop = rn / init_norm < relnorm_cutoff
        if it > 0:
            stop = stop | (torch.abs(rn_prev - rn) / rn_prev < min_delta)
        done = bool(stop)
        if not done:
            if decode_and_jac is None:
                v = dec_jac(y, w)
            jv = jac_apply(w, v)
            if weights is not None:
                jv = weights[:, None] * jv
            if ls_dtype is not None:
                dy = solve_ls(jv.to(ls_dtype), (-fw).to(ls_dtype)).to(
                    y.dtype)
            else:
                dy = solve_ls(jv, -fw)
            if line_search:
                alphas = (1.0, 0.5, 0.25, 0.125)

                def cand_norm(alpha):
                    fc = res_fn(decode(y + alpha * stepsize * dy))
                    if weights is not None:
                        fc = fc * weights
                    return torch.linalg.vector_norm(fc)

                norms = torch.stack([cand_norm(a) for a in alphas])
                best = int(torch.argmin(norms))
                if bool(norms[best] < rn):
                    y = y + alphas[best] * stepsize * dy
                else:
                    done = True
            else:
                y = y + stepsize * dy
        it += 1
        rn_prev = rn
    return GNResult(y=y, num_its=it - int(done), resnorm=rn,
                    init_norm=init_norm)


def fit_reduced_coords(decode, dec_jac, y_init, target, *,
                       max_its: int = 10, relnorm_cutoff: float = 1e-2,
                       ls_method: str = "qr") -> GNResult:
    """Fit reduced coordinates: min_y || decode(y) - target ||.

    The reference's inner Gauss-Newton inside the closure ECSW
    training-matrix builders (hypernet2D.py:2765-2773): start from the
    projection y_init, iterate until the decode residual has shrunk by
    relnorm_cutoff (1e-2) relative to the start's, at most max_its (10)
    times. No stagnation stop (min_delta=0 disables it).
    """
    y_init = as_tensor(y_init)
    target = as_tensor(target, device=y_init.device)
    return gauss_newton(
        decode, dec_jac,
        lambda w: w - target,
        lambda w, v: v,
        y_init,
        max_its=max_its, relnorm_cutoff=relnorm_cutoff,
        min_delta=0.0, ls_method=ls_method,
    )
