"""ECSW / ECM hyper-reduction (PyTorch): training matrices, NNLS, cubature.

Counterpart of finitedifference_tpu/ecsw.py:

* `ecsw_training_matrix`: the per-snapshot Gauss-Newton work terms
  C[i*k+j, cell] = r_u[cell]*(J V)_u[cell, j] + r_v[cell]*(J V)_v[cell, j]
  (reference compute_ECSW_training_matrix_2D, hypernet2D.py:2719-2742),
  as batched stencil passes over the snapshots on their device.
* `nnls`, `nnls_gram`: Lawson-Hanson active sets with the reference's
  early stops (`rel_err_thresh`, `max_support`; lsqnonneg.py:4-110), host
  NumPy as in the JAX package and giving its bits; `nnls_gram` keeps the
  passive columns in a contiguous buffer instead of gathering them at
  every add.
* `nnls_fista`: projected-gradient (FISTA) NNLS on the device, batched
  over a leading axis with `torch.bmm` (the JAX package vmaps it).
* `empirical_cubature`: greedy positive-weight element selection
  (reference EmpiricalCubatureMethod, after Hernandez 2020), host NumPy.
* `compute_ecsw_weights`: interior NNLS or ECM + fixed boundary-ring
  weights (run_HPROM_ecsw_joshua.py:55-111, run_HPROM_ecm.py:84-91);
  `sequential_nnls_weights` and `multilevel_nnls_weights`, the batched
  and two-level variants.
* the device-resident recipe: `ecsw_training_matrix_device[_multi]`
  (chunked into one preallocated tensor), `lawson_hanson_weights_device`
  (the scoring GEMV on the device, the active set on the host) and
  `multilevel_nnls_weights_device` (FISTA screening on the device, an
  exact host solve on the screened columns).
* `ecsw_training_matrix_closure`: the training matrix of the closure
  ROMs, V = dec_jac(y) at coordinates fitted to each snapshot.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from finitedifference_tpu_torch.device import as_tensor, to_host
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.stencil import (
    apply_jacobian,
    burgers_residual_flat,
    inflow_bc_term,
    jacobian_times_basis,
    source_term,
)


# --------------------------------------------------------------------------
# ECSW training matrix
# --------------------------------------------------------------------------

# values in one (batch, k, n) temporary of the training matrix's passes
BATCH_VALUES = 2 ** 25


def ecsw_training_matrix(grid: Grid2D, snaps, prev_snaps, basis,
                         mu1, mu2, dt) -> torch.Tensor:
    """C of shape (n_snaps * k, n_cells) for linear-POD ECSW training.

    snaps/prev_snaps: (2n, S) matched snapshot columns; basis: (2n, k).
    Runs on the basis's device in the promoted dtype of snapshots and
    basis, as many snapshots per pass as keep one (batch, k, n)
    temporary near BATCH_VALUES values.
    """
    basis = as_tensor(basis)
    device = basis.device
    snaps = torch.as_tensor(snaps, device=device)
    prev_snaps = torch.as_tensor(prev_snaps, device=device)
    dtype = torch.promote_types(snaps.dtype, basis.dtype)
    basis = basis.to(dtype)
    n = grid.n_cells
    k = basis.shape[1]
    s_total = snaps.shape[1]
    batch = max(1, BATCH_VALUES // (k * n))
    src = source_term(grid, mu2, dt, dtype=dtype, device=device)
    lbc = inflow_bc_term(grid, mu1, dt, dtype=dtype, device=device)
    bu, bv = grid.split_fields(basis.T)                 # (k, ny, nx)
    out = torch.empty((s_total, k, n), dtype=dtype, device=device)
    for s0 in range(0, s_total, batch):
        w = snaps[:, s0:s0 + batch].T.to(dtype)          # (b, 2n)
        wp = prev_snaps[:, s0:s0 + batch].T.to(dtype)
        f = burgers_residual_flat(w, wp, mu1, mu2, dt, grid, src, lbc)
        u, v = grid.split_fields(w)                      # (b, ny, nx)
        ju, jv = apply_jacobian(u[:, None], v[:, None], bu, bv, dt, grid)
        fu, fv = grid.split_fields(f)
        # per-cell contraction over the u and v components
        c = ju * fu[:, None] + jv * fv[:, None]          # (b, k, ny, nx)
        out[s0:s0 + w.shape[0]] = c.reshape(w.shape[0], k, n)
    return out.reshape(s_total * k, n)


def ecsw_training_matrix_closure(grid: Grid2D, snaps, prev_snaps,
                                 decode, dec_jac, fit_y0, mu1, mu2,
                                 dt) -> torch.Tensor:
    """Training matrix for nonlinear-closure ROMs (RNM / RBF / GP / AE).

    For each snapshot: fit reduced coordinates y to it (the caller's
    `fit_y0`, typically solvers.fit_reduced_coords on the decoder), then
    the same work terms as ecsw_training_matrix with V = dec_jac(y, w) in
    place of the linear basis. A loop over the snapshots on their device
    (the card unless they are tensors elsewhere); returns the
    (n_snaps * k, n_cells) tensor there.
    """
    snaps = as_tensor(snaps)
    prev_snaps = as_tensor(prev_snaps, device=snaps.device)
    n = grid.n_cells
    blocks = []
    for i in range(snaps.shape[1]):
        y = fit_y0(snaps[:, i])
        w = decode(y)
        v = dec_jac(y, w)
        f = burgers_residual_flat(w, prev_snaps[:, i], mu1, mu2, dt, grid)
        jv = jacobian_times_basis(w, v, dt, grid)
        blocks.append((jv[:n] * f[:n, None] + jv[n:] * f[n:, None]).T)
    return torch.cat(blocks, dim=0)


# --------------------------------------------------------------------------
# NNLS — Lawson-Hanson with early stopping (host)
# --------------------------------------------------------------------------

def nnls(C, d, tol: Optional[float] = None, itmax_factor: int = 100,
         max_support: Optional[int] = None,
         rel_err_thresh: float = 0.0,
         x0: Optional[np.ndarray] = None,
         verbose: bool = False) -> Tuple[np.ndarray, float, np.ndarray]:
    """min ||C x - d|| s.t. x >= 0 by Lawson-Hanson active sets.

    Early stops (the reference's lsqnonneg extensions, lsqnonneg.py:100-105):
    `rel_err_thresh` — stop once ||resid||/||d|| drops below it;
    `max_support` — stop once the positive set reaches this size.
    `x0` — warm start (lsqnonneg.py:4): seed the passive set with the
    support of a prior/approximate solution (e.g. the device-FISTA
    screening pass, or the previous solve in a regen chain), then run the
    standard outer loop — converges to the same KKT point, typically in
    far fewer column additions.
    Returns (x, sum of squared residuals, residual vector).

    Intentional default difference: the reference's lsqnonneg defaults
    rel_err_thresh=0.01 (lsqnonneg.py:43); here the default 0.0 runs to
    full convergence, so the *library* function is exact unless a caller
    opts into an early stop (repo ECSW recipes pass 1e-4 explicitly —
    ecsw.py::compute_ecsw_weights).
    """
    C = np.ascontiguousarray(C, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    m, n = C.shape
    if tol is None:
        tol = 10 * 2.22e-16 * np.abs(C).sum(axis=0).max() * (max(m, n) + 1)

    x = np.zeros(n)
    passive = np.zeros(n, dtype=bool)   # the positive ("P") set
    it = 0
    itmax = itmax_factor * n
    norm_d = np.linalg.norm(d)

    def solve_passive():
        z = np.zeros(n)
        cols = np.where(passive)[0]
        if cols.size:
            z[cols] = np.linalg.lstsq(C[:, cols], d, rcond=None)[0]
        return z

    if x0 is not None:
        passive = np.asarray(x0, dtype=np.float64) > tol
        if passive.any():
            # inner fix-up, iterated to feasibility: drop seeded columns
            # whose unconstrained coefficient is non-positive and
            # RE-SOLVE until none remain (x=0 start, so the feasibility
            # step reduces to dropping them outright). A single
            # drop-and-resolve is not enough when the seeded passive set
            # is rank-deficient/underdetermined (e.g. a dense screening
            # seed on a wide problem): the re-solve can reintroduce
            # negative coefficients, and returning that x violates the
            # x >= 0 constraint (ADVICE r4). nnls_gram's warm start
            # iterates the same loop.
            z = solve_passive()
            while passive.any() and (z[passive] <= tol).any():
                passive &= z > tol
                z = solve_passive() if passive.any() else np.zeros(n)
            x = z
    resid = d - C @ x
    w = C.T @ resid

    if x0 is not None and norm_d > 0:
        # the seed may already satisfy a caller's early stop
        if rel_err_thresh and np.linalg.norm(resid) / norm_d \
                < rel_err_thresh:
            return x, float(resid @ resid), resid
        if max_support is not None and int((x > 0).sum()) >= max_support:
            return x, float(resid @ resid), resid

    while (~passive).any() and (w[~passive] > tol).any():
        # most-violating inactive column joins the passive set
        inactive = np.where(~passive)[0]
        t = inactive[np.argmax(w[inactive])]
        passive[t] = True
        z = solve_passive()

        # inner loop: back out coordinates that went non-positive
        while (z[passive] <= tol).any():
            it += 1
            if it > itmax:
                raise RuntimeError(
                    f"NNLS iteration limit exceeded ({it} > {itmax})")
            qq = passive & (z <= tol)
            denom = x[qq] - z[qq]
            # guard x == z == 0 ties (0/0 -> NaN alpha poisons x): such
            # a coordinate contributes alpha = 0 in exact arithmetic
            safe = np.abs(denom) > 0
            alpha = np.min(x[qq][safe] / denom[safe]) if safe.any() \
                else 0.0
            x = x + alpha * (z - x)
            passive &= ~(np.abs(x) < tol)
            z = solve_passive()

        x = z
        resid = d - C @ x
        w = C.T @ resid

        rel_err = np.linalg.norm(resid) / norm_d if norm_d > 0 else 0.0
        num_pos = int((x > 0).sum())
        if verbose:
            print(f"  nnls: support={num_pos}, rel_err={rel_err:.4f}")
        if rel_err_thresh and rel_err < rel_err_thresh:
            break
        if max_support is not None and num_pos >= max_support:
            break

    return x, float(resid @ resid), resid


def nnls_gram(C, d, tol: Optional[float] = None, itmax_factor: int = 100,
              max_support: Optional[int] = None,
              rel_err_thresh: float = 0.0,
              x0: Optional[np.ndarray] = None,
              verbose: bool = False) -> Tuple[np.ndarray, float, np.ndarray]:
    """Lawson-Hanson NNLS on an incrementally-maintained Gram Cholesky.

    Same active-set algorithm and stopping rules as `nnls` (including the
    reference's `rel_err_thresh` / `max_support` early stops,
    lsqnonneg.py:100-105), but the passive-set least-squares solve comes
    from an incrementally-extended Cholesky factor of A^T A
    (`_GramCholesky`) instead of a fresh O(m s^2) lstsq per step.
    Per-iteration cost: O(m n) scoring + O(m s) new Gram column +
    O(s^2) factor update — supports of thousands become tractable on one
    host core (this environment's fine-grid level-2 solves; a
    fresh-lstsq LH at support ~2,000 costs ~1e13 flops, hours on one
    core). The Gram squaring spends ~half the f64 significand, so
    weights agree with `nnls` to ~1e-6 relative rather than bitwise
    (tests/test_ecsw.py::test_gram_matches_lstsq).
    """
    C = np.ascontiguousarray(C, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)
    m, n = C.shape
    if tol is None:
        tol = 10 * 2.22e-16 * np.abs(C).sum(axis=0).max() * (max(m, n) + 1)

    gram = _GramCholesky(C, d)
    x = np.zeros(n)
    passive = np.zeros(n, dtype=bool)
    blocked = np.zeros(n, dtype=bool)   # columns rejected as dependent
    resid = d.copy()
    w = C.T @ resid
    it = 0
    itmax = itmax_factor * n
    norm_d = np.linalg.norm(d)
    best_rel, stall = 1e30, 0   # finite: inf-inf=nan kills the test

    def z_full():
        z = np.zeros(n)
        if gram.cols:
            z[gram.cols] = gram.weights()
        return z

    if x0 is not None:
        # warm start (lsqnonneg.py:4 x0): seed the factor with the prior
        # support in DECREASING weight order — the greedy ordering the
        # cold algorithm would discover — and stop at the first
        # dependency (an unordered all-at-once seed lets near-duplicate
        # small-weight columns into the factor first, which then makes
        # the load-bearing columns look dependent at the Gram-squared
        # precision floor and strands the solve at a premature exit)
        x0 = np.asarray(x0, dtype=np.float64)
        for j in np.argsort(-x0):
            if x0[j] <= tol:
                break
            if not gram.try_add(int(j)):
                break
            passive[j] = True
        z = z_full()
        while passive.any() and (z[passive] <= tol).any():
            drop = passive & (z <= tol)
            for j in np.where(drop)[0]:
                gram.remove(gram.cols.index(int(j)))
            passive &= ~drop
            z = z_full()
        x = z
        if gram.cols:
            cols = np.asarray(gram.cols, dtype=np.int64)
            resid = d - gram.A @ x[cols]
            w = C.T @ resid
            rel0 = np.linalg.norm(resid) / norm_d if norm_d > 0 else 0.0
            best_rel = rel0
            if rel_err_thresh and rel0 < rel_err_thresh:
                return x, float(resid @ resid), resid
            if max_support is not None \
                    and int((x > 0).sum()) >= max_support:
                return x, float(resid @ resid), resid

    rebuilt_stuck = False
    while True:
        cand = ~passive & ~blocked
        if not cand.any() or not (w[cand] > tol).any():
            # don't exit on a BLOCKED column still violating KKT: the
            # accumulated downdate error in the factor can spuriously
            # reject independent columns. Rebuild fresh once and retry;
            # a successful add re-arms the rebuild.
            stuck = ~passive & blocked
            if not rebuilt_stuck and stuck.any() \
                    and (w[stuck] > tol).any():
                cols_now = [int(j) for j in np.where(passive)[0]]
                gram = _GramCholesky(C, d)
                passive[:] = False
                for j in cols_now:
                    if gram.try_add(j):
                        passive[j] = True
                blocked[:] = False
                rebuilt_stuck = True
                continue
            break
        inactive = np.where(cand)[0]
        t = inactive[np.argmax(w[inactive])]
        if not gram.try_add(t):
            blocked[t] = True   # dependent on the current passive set
            continue
        rebuilt_stuck = False
        passive[t] = True
        z = z_full()

        while (z[passive] <= tol).any():
            it += 1
            if it > itmax:
                raise RuntimeError(
                    f"NNLS iteration limit exceeded ({it} > {itmax})")
            qq = passive & (z <= tol)
            alpha = np.min(x[qq] / (x[qq] - z[qq]))
            x = x + alpha * (z - x)
            drop = passive & (np.abs(x) < tol)
            for j in np.where(drop)[0]:
                gram.remove(gram.cols.index(int(j)))
            passive &= ~drop
            blocked[:] = False   # removals can free dependent columns
            z = z_full()

        x = z
        cols = np.asarray(gram.cols, dtype=np.int64)
        resid = d - gram.A @ x[cols]
        w = C.T @ resid

        rel_err = np.linalg.norm(resid) / norm_d if norm_d > 0 else 0.0
        num_pos = int((x > 0).sum())
        if verbose:
            print(f"  nnls_gram: support={num_pos}, rel_err={rel_err:.4f}")
        if rel_err_thresh and rel_err < rel_err_thresh:
            break
        if max_support is not None and num_pos >= max_support:
            break
        # anti-cycling safeguard: the exact-arithmetic algorithm strictly
        # decreases ||resid||, so a long plateau means floating-point
        # ties are cycling add/drop — stop rather than spin to itmax
        if rel_err < best_rel - 1e-12 * max(best_rel, 1.0):
            best_rel, stall = rel_err, 0
        else:
            stall += 1
            if stall >= 300:
                print(f"WARNING: nnls_gram stalled at rel_err="
                      f"{rel_err:.3e} (support {num_pos}); stopping")
                break

    return x, float(resid @ resid), resid


# --------------------------------------------------------------------------
# NNLS — FISTA projected gradient (device, batched)
# --------------------------------------------------------------------------

def _fista_momenta(num_iters: int, dtype: torch.dtype) -> list:
    """The FISTA momentum factors (t_i - 1) / t_{i+1}, t_0 = 1, computed
    in the working dtype as the JAX scan carries t. They depend on the
    iteration count only, so they are host floats."""
    t = (np.float32 if dtype == torch.float32 else np.float64)(1.0)
    out = []
    for _ in range(num_iters):
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        out.append(float((t - 1.0) / t_new))
        t = t_new
    return out


def nnls_fista(C, d, num_iters: int = 500):
    """Approximate NNLS by accelerated projected gradient on the device.

    Fixed iteration count; Lipschitz constant from 16 power-iteration
    steps. C (m, n) and d (m,) give (x (n,), rel_err); a leading batch
    axis, C (B, m, n) and d (B, m), solves B independent problems at
    once with batched products (the JAX package vmaps the same
    function), giving x (B, n) and rel_err (B,). Runs on C's device
    (the CUDA device for arrays that are not tensors), in C's dtype.
    """
    C = as_tensor(C)
    d = torch.as_tensor(d, device=C.device).to(C.dtype)
    single = C.dim() == 2
    if single:
        C, d = C[None], d[None]
    ct = C.transpose(1, 2)

    def ctc(v):
        return torch.bmm(ct, torch.bmm(C, v[:, :, None]))[:, :, 0]

    def norm(v):
        return torch.linalg.vector_norm(v, dim=1, keepdim=True)

    batch, _, n = C.shape
    b = torch.full((batch, n), 1.0 / float(np.sqrt(n)), dtype=C.dtype,
                   device=C.device)
    for _ in range(16):
        nb = ctc(b)
        b = nb / (norm(nb) + 1e-30)
    lip = norm(ctc(b)) / (norm(b) + 1e-30)
    step = 1.0 / (lip + 1e-30)                         # (B, 1)
    ctd = torch.bmm(ct, d[:, :, None])[:, :, 0]
    x = torch.zeros((batch, n), dtype=C.dtype, device=C.device)
    y = x
    for mom in _fista_momenta(num_iters, C.dtype):
        x_new = torch.clamp_min(y - step * (ctc(y) - ctd), 0.0)
        y = x_new + mom * (x_new - x)
        x = x_new
    resid = torch.bmm(C, x[:, :, None])[:, :, 0] - d
    rel = (norm(resid) / (norm(d) + 1e-30))[:, 0]
    if single:
        return x[0], rel[0]
    return x, rel


# --------------------------------------------------------------------------
# incrementally maintained passive-set Grams (host)
# --------------------------------------------------------------------------

class _GramCholesky:
    """Incrementally-maintained Cholesky factor of the passive-set Gram
    A^T A for a growing / shrinking column set A = G[:, cols].

    Same O(m k) per add / O(k^2) per remove economics as `_GramInverse`,
    but numerically stable: appending a column extends the factor
    exactly (one triangular solve + a Schur scalar), and deleting one
    re-triangularizes with Givens rotations — neither accumulates the
    inverse-update drift that made `_GramInverse` mis-classify
    near-parallel candidates as dependent on large correlated pools
    (observed on the 750^2 level-2 NNLS: the drifted inverse blocked
    its way to a 16% stall where the exact solve reaches 1e-4).

    `A` is G[:, cols] kept in a column-major buffer that grows and
    shrinks with the set: the same values in the same layout as the
    fresh gather the JAX package takes (NumPy returns G[:, cols] in
    column-major order), so every product gives its bits, without
    gathering k strided columns of a wide G at every add (at 250^2 G is
    4750 x 62,001, and the gathers took most of the runner's NNLS).
    """

    def __init__(self, G, b):
        self.G = G
        self.b = b
        self.L = np.zeros((0, 0))
        self.atb = np.zeros(0)
        self.cols: list = []
        self._buf = np.empty((G.shape[0], 16), order="F")

    @property
    def A(self) -> np.ndarray:
        """G[:, cols], column-major."""
        return self._buf[:, :len(self.cols)]

    def try_add(self, j, eps: float = 1e-12) -> bool:
        """Append column j; returns False (no-op) if nearly dependent."""
        from scipy.linalg import solve_triangular

        g = self.G[:, j]
        d = float(g @ g)
        k = len(self.cols)
        if k == 0:
            if d <= eps:
                return False
            self.L = np.array([[np.sqrt(d)]])
            self.atb = np.array([float(g @ self.b)])
            self.cols = [j]
            self._buf[:, 0] = g
            return True
        u = self.A.T @ g                          # (k,)
        w = solve_triangular(self.L, u, lower=True)
        s = d - float(w @ w)                      # Schur complement
        if s <= eps * max(d, 1.0):
            return False
        new = np.zeros((k + 1, k + 1))
        new[:k, :k] = self.L
        new[k, :k] = w
        new[k, k] = np.sqrt(s)
        self.L = new
        self.atb = np.append(self.atb, float(g @ self.b))
        if k == self._buf.shape[1]:
            buf = np.empty((self._buf.shape[0], 2 * k), order="F")
            buf[:, :k] = self._buf
            self._buf = buf
        self._buf[:, k] = g
        self.cols.append(j)
        return True

    def remove(self, i: int) -> None:
        """Drop the i-th (positional) column; Givens re-triangularization
        of the row-deleted factor (standard qr-delete)."""
        m = np.delete(self.L, i, axis=0)          # (k-1, k)
        k1 = m.shape[0]
        for c in range(i, k1):
            a, b = m[c, c], m[c, c + 1]
            r = np.hypot(a, b)
            if r == 0.0:
                continue
            cs, sn = a / r, b / r
            col_c = m[:, c] * cs + m[:, c + 1] * sn
            m[:, c + 1] = m[:, c + 1] * cs - m[:, c] * sn
            m[:, c] = col_c
        self.L = np.ascontiguousarray(m[:, :k1])
        self.atb = np.delete(self.atb, i)
        k = len(self.cols)
        self._buf[:, i:k - 1] = self._buf[:, i + 1:k]
        self.cols = [p for q, p in enumerate(self.cols) if q != i]

    def weights(self) -> np.ndarray:
        from scipy.linalg import solve_triangular

        y = solve_triangular(self.L, self.atb, lower=True)
        return solve_triangular(self.L.T, y, lower=False)


class _GramInverse:
    """Incrementally-maintained (A^T A)^{-1} and A^T b for a growing /
    shrinking column set A = G[:, z].

    The O(k^2) add/remove updates replace a fresh O(r k^2) lstsq per
    greedy step — the same economics as the reference's rank-one inverse
    updates (empirical_cubature_method.py:255-303,
    _UpdateWeightsInverse/_MultiUpdateInverseHermitian), implemented here
    as standard block-inverse updates/downdates of the Gram matrix.
    """

    def __init__(self, G, b):
        self.G = G
        self.b = b
        self.hinv = np.zeros((0, 0))
        self.atb = np.zeros(0)
        self.cols: list = []

    def try_add(self, j, eps: float = 1e-12) -> bool:
        """Append column j; returns False (no-op) if nearly dependent."""
        g = self.G[:, j]
        d = float(g @ g)
        if not self.cols:
            if d <= eps:
                return False
            self.hinv = np.array([[1.0 / d]])
            self.atb = np.array([float(g @ self.b)])
            self.cols = [j]
            return True
        u = self.G[:, self.cols].T @ g            # (k,)
        hu = self.hinv @ u
        s = d - float(u @ hu)                     # Schur complement
        if s <= eps * max(d, 1.0):
            return False
        k = len(self.cols)
        new = np.empty((k + 1, k + 1))
        new[:k, :k] = self.hinv + np.outer(hu, hu) / s
        new[:k, k] = -hu / s
        new[k, :k] = -hu / s
        new[k, k] = 1.0 / s
        self.hinv = new
        self.atb = np.append(self.atb, float(g @ self.b))
        self.cols.append(j)
        return True

    def remove(self, i: int) -> None:
        """Drop the i-th (positional) column via an inverse downdate."""
        keep = [p for p in range(len(self.cols)) if p != i]
        h = self.hinv
        hii = h[i, i]
        self.hinv = h[np.ix_(keep, keep)] - \
            np.outer(h[keep, i], h[i, keep]) / hii
        self.atb = self.atb[keep]
        self.cols = [self.cols[p] for p in keep]

    def weights(self) -> np.ndarray:
        return self.hinv @ self.atb


def empirical_cubature(residual_basis, tolerance: float = 0.0,
                       filter_tolerance: float = 0.0,
                       constrain_sum_of_weights: bool = True,
                       max_iters: Optional[int] = None,
                       use_inverse_updates: bool = True,
                       candidates: Optional[np.ndarray] = None,
                       max_unsuccessful: int = 100,
                       verbose: bool = False):
    """Select elements z and positive weights w with G[:, z] @ w ≈ G @ 1.

    residual_basis: (n_elements, r) — orthonormal columns spanning the
    projected-residual snapshots (typically from randomized_svd_adaptive
    of the ECSW training matrix transpose). Greedy selection with
    negative-weight ejection, per Hernandez 2020 (the algorithm the
    reference vendors in empirical_cubature_method.py). Host NumPy, as in
    the JAX package (a tensor is copied to the host first) — the greedy
    loop is inherently sequential and offline.

    use_inverse_updates=True maintains (A^T A)^{-1} by O(k^2) rank-one
    updates instead of a fresh lstsq per step (the reference's
    _UpdateWeightsInverse machinery); False re-solves each step (slower,
    bitwise-stabler reference path for cross-checks).

    candidates: optional explicit initial candidate element indices (the
    reference SetUp's `InitialCandidatesSet` y); the remaining columns
    form the COMPLEMENT pool. When the candidate pool exhausts — or the
    support stalls for `max_unsuccessful` consecutive iterations without
    growing (ejections keep cancelling additions) — the complement is
    re-admitted once (`expand_candidates_with_complement`,
    empirical_cubature_method.py:139-142 + the Calculate stall counter),
    rescuing tolerances the initial set alone cannot reach. Without
    `candidates`, the complement is the filter-rejected columns, matching
    the reference's default SetUp(y=None) — where exhaustion was
    previously a hard break.

    Returns (z, w): selected element indices and their positive weights.
    """
    if isinstance(residual_basis, torch.Tensor):
        residual_basis = residual_basis.detach().cpu().numpy()
    G = np.asarray(residual_basis, dtype=np.float64).T   # (r, M)
    M = G.shape[1]
    if constrain_sum_of_weights:
        ones = np.ones(M)
        proj = ones - G.T @ (G @ ones)
        nrm = np.linalg.norm(proj)
        if nrm > 0:
            G = np.vstack([G, proj / nrm])
    b = G @ np.ones(M)
    norm_b = np.linalg.norm(b)

    keep = np.ones(M, dtype=bool)         # filter: norm-worthy columns
    if filter_tolerance > 0:
        col_norms = np.linalg.norm(G, axis=0)
        keep &= col_norms >= filter_tolerance * norm_b
    if candidates is not None:
        cand = np.zeros(M, dtype=bool)
        cand[np.asarray(candidates, dtype=np.int64)] = True
        comp = keep & ~cand               # explicit complement pool
        cand &= keep
        if not cand.any():                # all candidates filtered away
            cand, comp = comp, np.zeros(M, dtype=bool)
    else:
        cand = keep.copy()
        comp = ~keep                      # filter-rejected columns
    Gt = np.ascontiguousarray(G.T)   # (M, r): row-major for the scoring GEMV

    gram = _GramInverse(G, b)
    z: list = []
    r = b.copy()
    alpha = np.zeros(0)
    k = 0
    expanded = False
    max_len, unsuccessful = 0, 0
    max_iters = max_iters or 10 * M

    def expand():
        nonlocal expanded
        cand[:] |= comp
        cand[np.asarray(z, dtype=np.int64)] = False
        expanded = True
        if verbose:
            print("  ecm: expanding candidate set with the complement "
                  f"(+{int(comp.sum())} columns)")

    while np.linalg.norm(r) / norm_b > tolerance and len(z) < M \
            and k < max_iters:
        if not cand.any() or (not expanded and comp.any()
                              and unsuccessful > max_unsuccessful):
            if expanded or not comp.any():
                break                     # genuinely exhausted
            expand()
        k += 1
        # score ALL columns with one GEMV and mask — a column-subset
        # gather (G[:, candidates]) copies O(M r) bytes per step and
        # dominates the whole loop at 250^2 candidate counts
        obj = Gt @ r
        obj[~cand] = -np.inf
        pick = None
        if use_inverse_updates:
            # best candidate whose column is independent of the current set
            while True:
                j = int(np.argmax(obj))
                if not np.isfinite(obj[j]):
                    break
                if gram.try_add(j):
                    pick = j
                    break
                obj[j] = -np.inf   # dependent column: skip this round
            if pick is None:
                # every remaining candidate is dependent on the current
                # set — re-admit the complement once before giving up
                if not expanded and comp.any():
                    expand()
                    continue
                break
            z.append(pick)
            cand[pick] = False
            alpha = gram.weights()
            while np.any(alpha <= 0) and len(z) > 1:
                neg = np.where(alpha <= 0)[0]
                cand[np.asarray(z, dtype=int)[neg]] = True
                for i in sorted(neg.tolist(), reverse=True):
                    gram.remove(i)
                z = [zz for i, zz in enumerate(z)
                     if i not in set(neg.tolist())]
                alpha = gram.weights()
        else:
            pick = int(np.argmax(obj))
            z.append(pick)
            cand[pick] = False
            alpha = np.linalg.lstsq(G[:, z], b, rcond=None)[0]
            while np.any(alpha <= 0) and len(z) > 1:
                neg = np.where(alpha <= 0)[0]
                cand[np.asarray(z, dtype=int)[neg]] = True
                z = [zz for i, zz in enumerate(z)
                     if i not in set(neg.tolist())]
                alpha = np.linalg.lstsq(G[:, z], b, rcond=None)[0]
        r = b - G[:, z] @ alpha
        # stall counter (reference Calculate's UnsuccesfulIterations):
        # an iteration "succeeds" only when the support reaches a new
        # maximum; long add/eject churn triggers the complement expansion
        if len(z) > max_len:
            max_len, unsuccessful = len(z), 0
        else:
            unsuccessful += 1
        if verbose:
            print(f"  ecm: k={k} |z|={len(z)} "
                  f"err={np.linalg.norm(r)/norm_b:.3e}")

    return np.asarray(z, dtype=np.int64), alpha


# --------------------------------------------------------------------------
# runner-level weight recipe
# --------------------------------------------------------------------------

def interior_mask(grid: Grid2D, ring: str = "full") -> np.ndarray:
    """Boolean (ny, nx) mask of NNLS/ECM *candidate* cells; the
    complement gets the fixed bc_w weight.

    ring='full'   — the reference recipe: the whole boundary ring is
                    fixed-weighted (run_HPROM_ecsw_joshua.py:55-111).
    ring='inflow' — only the x=0 column (where the mu1 Dirichlet inflow
                    actually acts) is fixed; the other three sides become
                    ordinary candidates. At 750^2 the full ring alone is
                    ~3,000 cells — more than a good interior sampling —
                    so the fine-grid recipe uses this (validated against
                    'full' at the canonical points, RESULTS.md).
    """
    ny, nx = grid.ny, grid.nx
    m = np.ones((ny, nx), dtype=bool)
    if ring == "full":
        m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = False
    elif ring == "inflow":
        m[:, 0] = False
    else:
        raise ValueError(f"unknown ring mode: {ring}")
    return m



def compute_ecsw_weights(C, grid: Grid2D, bc_w: float = 50.0,
                         method: str = "nnls",
                         rel_err_thresh: float = 0.0,
                         max_support: Optional[int] = None,
                         ecm_tolerance: float = 1e-2,
                         ecm_rank: Optional[int] = None,
                         ring: str = "full",
                         verbose: bool = False) -> np.ndarray:
    """Full-grid ECSW weight field from a training matrix C (rows, n_cells).

    The reference recipe (run_HPROM_ecsw_joshua.py:55-111): solve NNLS on
    the *interior* columns against d = C_interior @ 1, and give the
    boundary ring the fixed weight `bc_w`. C may be a tensor on any
    device; the NNLS methods run on the host in float64.

    method: "nnls" (Lawson-Hanson on the Gram Cholesky, `nnls_gram`),
    "nnls_lstsq" (the fresh-lstsq variant, `nnls`), "scipy_nnls", or
    "ecm": empirical cubature on the compressed residual basis
    (run_HPROM_ecm.py:84-91). ECM's randomized SVD of C_interior^T (the
    rank-`ecm_rank` sketch, else the adaptive one to 1e-8) runs where C
    lies (the CUDA device for an array that is not a tensor; the JAX
    package moves it to the host CPU), the greedy cubature to
    `ecm_tolerance` on the host.
    """
    ny, nx = grid.ny, grid.nx
    interior = interior_mask(grid, ring)
    flat_interior = interior.ravel()
    if method == "ecm":
        w_int = _ecm_weights(C, flat_interior, ecm_tolerance, ecm_rank,
                             verbose)
    else:
        Ci = to_host(C)[:, flat_interior]
        if method == "nnls":
            w_int, _, _ = nnls_gram(Ci, Ci.sum(axis=1),
                                    rel_err_thresh=rel_err_thresh,
                                    max_support=max_support,
                                    verbose=verbose)
        elif method == "nnls_lstsq":
            w_int, _, _ = nnls(Ci, Ci.sum(axis=1),
                               rel_err_thresh=rel_err_thresh,
                               max_support=max_support, verbose=verbose)
        elif method == "scipy_nnls":
            import scipy.optimize
            w_int, _ = scipy.optimize.nnls(Ci, Ci.sum(axis=1))
        else:
            raise ValueError(f"unknown weight method: {method}")

    full = np.full(ny * nx, float(bc_w))
    full[flat_interior] = w_int
    return full


def _ecm_weights(C, flat_interior, tolerance, rank, verbose) -> np.ndarray:
    """Interior ECM weights: the randomized SVD of C_interior^T where C
    lies (the rank-`rank` sketch, or the adaptive one to 1e-8 when rank
    is None), then the greedy cubature to `tolerance` on the host."""
    from finitedifference_tpu_torch.pod import (
        randomized_svd,
        randomized_svd_adaptive,
    )

    c_dev = as_tensor(C)
    cols = torch.as_tensor(np.flatnonzero(flat_interior), device=c_dev.device)
    a = c_dev.index_select(1, cols).T.contiguous()       # (n_int, rows)
    # the fixed-rank sketch skips the adaptive rank doubling: ECM's
    # cubature tolerance only needs the leading spectrum; the captured
    # energy is reported so the truncation is auditable
    if rank is not None:
        u, s, _ = randomized_svd(a, min(rank, *a.shape), n_iter=2)
        keep = max(int((s > 1e-8 * s[0]).sum()), 1)
        u, s = u[:, :keep], s[:keep]
        if verbose:
            frob = float(torch.linalg.norm(a))
            cap = float(torch.linalg.norm(s)) / frob if frob > 0 else 1.0
            print(f"  ecm: rank-{keep} sketch captures "
                  f"{100 * cap:.4f}% of ||C||_F")
    else:
        u, _, _ = randomized_svd_adaptive(a, tol=1e-8)
    z, alpha = empirical_cubature(u, tolerance=tolerance, verbose=verbose)
    w_int = np.zeros(a.shape[0])
    w_int[z] = alpha
    return w_int


def sequential_nnls_weights(C, grid: Grid2D, batch_size: int = 5000,
                            bc_w: float = 50.0,
                            rel_err_thresh: float = 0.0,
                            ring: str = "full",
                            verbose: bool = False) -> np.ndarray:
    """Sequential batched NNLS over column blocks (role of the fine
    variant run_HRNM_ecsw_joshua_sequential.py:168-195): solve NNLS on
    each interior column batch against the *running* target residual so
    the accumulated solution covers the full assembly, then finish with
    a cleanup solve on the accumulated support."""
    C = to_host(C)
    ny, nx = grid.ny, grid.nx
    interior = interior_mask(grid, ring)
    flat_interior = np.where(interior.ravel())[0]
    Ci = C[:, flat_interior]

    d_full = Ci.sum(axis=1)
    resid = d_full.copy()
    w_int = np.zeros(Ci.shape[1])
    for start in range(0, Ci.shape[1], batch_size):
        blk = slice(start, min(start + batch_size, Ci.shape[1]))
        wb, _, _ = nnls_gram(Ci[:, blk], resid,
                             rel_err_thresh=rel_err_thresh)
        w_int[blk] = wb
        resid = d_full - Ci @ w_int
        if verbose:
            print(f"  seq-nnls block {start}: support "
                  f"{(w_int > 0).sum()}, rel "
                  f"{np.linalg.norm(resid) / np.linalg.norm(d_full):.3e}")

    support = np.where(w_int > 0)[0]
    if support.size:
        w2, _, _ = nnls_gram(Ci[:, support], d_full,
                             rel_err_thresh=rel_err_thresh)
        w_int[:] = 0.0
        w_int[support] = w2

    full = np.full(ny * nx, float(bc_w))
    full[interior.ravel()] = w_int
    return full


def multilevel_nnls_weights(C, grid: Grid2D, num_subdomains: int = 12,
                            bc_w: float = 50.0,
                            rel_err_thresh: float = 0.0,
                            level1: str = "fista",
                            fista_iters: int = 800,
                            support_cap_per_block: Optional[int] = None,
                            device_block_chunk: int = 4,
                            ring: str = "full",
                            verbose: bool = False) -> np.ndarray:
    """Two-level domain-decomposed NNLS (reference
    run_HPROM_ecsw_multilevel.py:89-140): split interior columns into
    subdomain blocks, solve NNLS per block, then a level-2 NNLS on the
    union of the level-1 supports.

    The per-block solves are independent — the reference fans them out
    over joblib workers; here level-1 runs batched on the device:
    columns are zero-padded to equal-sized blocks and solved by the
    batched `nnls_fista`, `device_block_chunk` blocks per call to bound
    device memory (level1="fista", the default). The device is C's for a
    tensor, else the CUDA device. level1="host" keeps the serial
    Lawson-Hanson path (exact per-block supports). Level 2 is always an
    exact host Lawson-Hanson on the union support, warm-started from the
    level-1 values, so the FINAL weights are a true NNLS solution either
    way — level 1 is support screening.

    support_cap_per_block caps each block's screened support to its
    largest-weight entries (bounds the level-2 problem size on fine
    grids, where the level-2 active-set cost grows as |support|^3).
    """
    device = C.device if isinstance(C, torch.Tensor) else None
    C = to_host(C)
    ny, nx = grid.ny, grid.nx
    interior = interior_mask(grid, ring)
    flat_interior = np.where(interior.ravel())[0]
    Ci = C[:, flat_interior]

    support: list = []
    x1 = np.zeros(Ci.shape[1])   # level-1 values: level-2 warm start
    if level1 == "fista":
        m, ncols = Ci.shape
        blk = -(-ncols // num_subdomains)
        pad = blk * num_subdomains - ncols
        Cp = np.concatenate(
            [Ci, np.zeros((m, pad), Ci.dtype)], axis=1)
        # (B, m, blk): contiguous column blocks as one batch axis
        Cb = np.ascontiguousarray(
            Cp.reshape(m, num_subdomains, blk).transpose(1, 0, 2))
        for s in range(0, num_subdomains, device_block_chunk):
            # level 1 is SUPPORT SCREENING only (level 2 re-solves
            # exactly on the union support), so the batch runs f32, as
            # in the JAX package
            cb = as_tensor(Cb[s:s + device_block_chunk], device=device,
                           dtype=torch.float32)
            xs, rels = nnls_fista(cb, cb.sum(dim=2), num_iters=fista_iters)
            xs = xs.cpu().numpy()
            for bi in range(xs.shape[0]):
                x = xs[bi]
                # projected gradient leaves exact zeros; the relative
                # floor drops not-yet-converged dust
                pos = np.flatnonzero(x > 1e-8 * max(x.max(), 1e-300))
                if support_cap_per_block is not None \
                        and pos.size > support_cap_per_block:
                    pos = pos[np.argsort(x[pos])[::-1]
                              [:support_cap_per_block]]
                in_range = (s + bi) * blk + pos < ncols
                pos = pos[in_range]
                cols = (s + bi) * blk + pos
                support.extend(int(p) for p in cols)
                x1[cols] = x[pos]
            if verbose:
                print(f"  fista blocks {s}..{s + xs.shape[0] - 1}: "
                      f"rel err {float(rels.max()):.3e}, "
                      f"union {len(support)}")
    elif level1 == "host":
        blocks = np.array_split(np.arange(Ci.shape[1]), num_subdomains)
        for blk in blocks:
            wb, _, _ = nnls(Ci[:, blk], Ci[:, blk].sum(axis=1),
                            rel_err_thresh=rel_err_thresh)
            support.extend(blk[wb > 0].tolist())
            x1[blk] = wb
    else:
        raise ValueError(f"unknown level1 method: {level1}")
    support = np.asarray(sorted(set(support)), dtype=np.int64)
    if support.size == 0:
        raise ValueError(
            "multilevel NNLS: empty level-1 support — the training matrix "
            "is (near) zero. Check the snapshot pairing: residuals of "
            "consecutive converged snapshots vanish; pair each snapshot "
            "with an earlier state (the reference uses a 3-step offset).")
    if verbose:
        print(f"  level-1 union support: {support.size}")

    # level-2 exact solve, warm-started from the level-1 values
    # (lsqnonneg.py:4 x0)
    w2, _, _ = nnls_gram(Ci[:, support], Ci.sum(axis=1),
                         rel_err_thresh=rel_err_thresh,
                         x0=x1[support])
    w_int = np.zeros(Ci.shape[1])
    w_int[support] = w2

    full = np.full(ny * nx, float(bc_w))
    full[interior.ravel()] = w_int
    return full


# --------------------------------------------------------------------------
# fine-grid (device-resident) weight recipe
# --------------------------------------------------------------------------

def ecsw_training_matrix_device(grid: Grid2D, snaps, prev_snaps, basis,
                                mu1, mu2, dt, chunk: int = 2,
                                dtype=torch.float32) -> torch.Tensor:
    """Device-resident (S*k, n_cells) ECSW training matrix, built `chunk`
    snapshots at a time on the basis's device (the CUDA device for an
    array that is not a tensor).

    At 750^2 each snapshot's (2n, k) Jacobian product is ~0.4 GB, so
    chunking bounds the working set to C (S*k*n*4 bytes in float32) plus
    a chunk's temporaries: every chunk's rows are written in place into
    one preallocated tensor.
    """
    return ecsw_training_matrix_device_multi(
        grid, [(mu1, mu2, snaps, prev_snaps)], basis, dt,
        chunk=chunk, dtype=dtype)


def ecsw_training_matrix_device_multi(grid: Grid2D, groups, basis, dt,
                                      chunk: int = 2,
                                      dtype=torch.float32) -> torch.Tensor:
    """Device-resident training matrix over MULTIPLE training
    trajectories: `groups` is a list of (mu1, mu2, snaps, prev_snaps)
    and the result stacks each group's rows in order — equal to
    vstacking per-mu `ecsw_training_matrix` blocks, assembled into one
    preallocated tensor like the single-mu builder above.

    Spreading the row budget over several training mu generalizes the
    sampled mesh (ECSW as published trains over all snapshots); the
    reference recipe trains on one trajectory
    (run_HPROM_ecsw_joshua.py:55-66).
    """
    basis = as_tensor(basis)
    k = basis.shape[1]
    s_total = 0
    for _, _, snaps, _ in groups:
        s = snaps.shape[1]
        if s % chunk:
            raise ValueError(f"snapshot count {s} must divide by "
                             f"chunk {chunk} (pad/stride the "
                             f"training set)")
        s_total += s
    C = torch.empty((s_total * k, grid.n_cells), dtype=dtype,
                    device=basis.device)
    row = 0
    for mu1, mu2, snaps, prev_snaps in groups:
        snaps = torch.as_tensor(snaps, device=basis.device)
        prev_snaps = torch.as_tensor(prev_snaps, device=basis.device)
        for s in range(0, snaps.shape[1], chunk):
            blk = ecsw_training_matrix(grid, snaps[:, s:s + chunk],
                                       prev_snaps[:, s:s + chunk], basis,
                                       mu1, mu2, dt)
            C[row:row + blk.shape[0]] = blk
            row += blk.shape[0]
    return C


def _colsum_max(C_dev, cand_dev, chunk: int = 65536) -> float:
    """max over candidate columns of sum_i |C[i, j]|, in column chunks:
    abs(C) at once would take a second C-sized buffer."""
    out = 0.0
    for lo in range(0, C_dev.shape[1], chunk):
        hi = min(lo + chunk, C_dev.shape[1])
        out = max(out, float((C_dev[:, lo:hi].abs().sum(dim=0)
                              * cand_dev[lo:hi]).max()))
    return out


def lawson_hanson_weights_device(C_dev, grid: Grid2D,
                                 bc_w: float = 50.0,
                                 rel_err_thresh: float = 1e-4,
                                 ring: str = "inflow",
                                 batch_add: int = 8,
                                 max_support: Optional[int] = None,
                                 stall_limit: int = 300,
                                 verbose: bool = False) -> np.ndarray:
    """EXACT Lawson-Hanson ECSW weights with the training matrix resident
    on the device — the fine-grid production recipe.

    Greedy active-set NNLS needs the gradient w = C^T r over EVERY
    candidate column at every step; pre-screening a subset caps what the
    greedy can reach. So the split is by OPERATION, not by column block:
    the O(m n) scoring GEMV runs on the device against the resident C,
    and only the score vector plus the few newly selected columns
    (`C[:, idx]`, a gather; the JAX package fetches them as one-hot
    matmuls) reach the host. The host keeps the passive-set Cholesky
    factor (`_GramCholesky` mechanics inlined over the fetched-column
    cache) and runs the exact inner drop loop.

    `batch_add` adds the top-q gradient columns per scoring round
    (block-pivoting LH) to amortize the round trip; q=1 reproduces the
    textbook algorithm. Same stopping rules as `nnls`/`nnls_gram`
    (reference lsqnonneg.py:100-105 + the rel_err_thresh recipe stop,
    run_HPROM_ecsw_joshua.py:55-111). C_dev stays on its device (the
    CUDA device for an array that is not a tensor).
    """
    from scipy.linalg import solve_triangular

    C_dev = as_tensor(C_dev)
    m, ncols = C_dev.shape
    ny, nx = grid.ny, grid.nx
    assert ncols == ny * nx
    cand = interior_mask(grid, ring).ravel()
    cand_dev = torch.as_tensor(cand, device=C_dev.device).to(C_dev.dtype)

    d = (C_dev @ cand_dev).double().cpu().numpy()
    norm_d = np.linalg.norm(d)

    def score(resid):
        r = torch.as_tensor(resid, device=C_dev.device).to(C_dev.dtype)
        return ((r @ C_dev) * cand_dev).double().cpu().numpy()

    def fetch_cols(idx):
        sel = torch.as_tensor(idx, dtype=torch.int64, device=C_dev.device)
        return C_dev.index_select(1, sel).double().cpu().numpy()

    tol = 10 * 2.22e-16 * _colsum_max(C_dev, cand_dev) * (max(m, ncols) + 1)

    cache: dict = {}

    def col(j):
        if j not in cache:
            cache[j] = fetch_cols([j]).ravel()
        return cache[j]

    def prefetch(js):
        missing = [int(j) for j in js if int(j) not in cache]
        if missing:
            got = fetch_cols(missing)
            for q, j in enumerate(missing):
                cache[j] = got[:, q].copy()

    # passive-set state: Cholesky factor L of A_p^T A_p, fetched columns
    # Ap, reduced rhs atb — the _GramCholesky mechanics over cache cols
    L = np.zeros((0, 0))
    Ap = np.zeros((m, 0))
    atb = np.zeros(0)
    cols: list = []

    def try_add(j) -> bool:
        nonlocal L, Ap, atb, cols
        g = col(j)
        dd = float(g @ g)
        k = len(cols)
        if k == 0:
            if dd <= 1e-12:
                return False
            L = np.array([[np.sqrt(dd)]])
            Ap = g[:, None].copy()
            atb = np.array([float(g @ d)])
            cols = [j]
            return True
        u = Ap.T @ g
        ww = solve_triangular(L, u, lower=True)
        s = dd - float(ww @ ww)
        if s <= 1e-12 * max(dd, 1.0):
            return False
        new = np.zeros((k + 1, k + 1))
        new[:k, :k] = L
        new[k, :k] = ww
        new[k, k] = np.sqrt(s)
        L = new
        Ap = np.column_stack([Ap, g])
        atb = np.append(atb, float(g @ d))
        cols.append(j)
        return True

    def remove(i) -> None:
        nonlocal L, Ap, atb, cols
        mm = np.delete(L, i, axis=0)
        k1 = mm.shape[0]
        for c in range(i, k1):
            a, b = mm[c, c], mm[c, c + 1]
            r = np.hypot(a, b)
            if r == 0.0:
                continue
            cs, sn = a / r, b / r
            col_c = mm[:, c] * cs + mm[:, c + 1] * sn
            mm[:, c + 1] = mm[:, c + 1] * cs - mm[:, c] * sn
            mm[:, c] = col_c
        L = np.ascontiguousarray(mm[:, :k1])
        Ap = np.delete(Ap, i, axis=1)
        atb = np.delete(atb, i)
        cols = [p for q, p in enumerate(cols) if q != i]

    def weights_now():
        y = solve_triangular(L, atb, lower=True)
        return solve_triangular(L.T, y, lower=False)

    x = np.zeros(ncols)
    passive = np.zeros(ncols, bool)
    blocked = np.zeros(ncols, bool)
    resid = d.copy()
    rel = 1.0
    best_rel, stall = 1e30, 0   # finite: inf-inf=nan kills the test
    rounds = 0
    dead_rounds = 0   # consecutive scoring rounds with no accepted add
    add_budget = batch_add
    while True:
        rounds += 1
        w = score(resid)
        w[passive | blocked] = -np.inf
        order = np.argsort(w)[::-1]
        top = [int(t) for t in order[:add_budget] if w[t] > tol]
        if not top:
            if blocked.any() and rel > rel_err_thresh and dead_rounds < 3:
                blocked[:] = False   # retry once support has changed
                dead_rounds += 1
                continue
            break
        prefetch(top)
        added = 0
        for t in top:
            if try_add(t):
                passive[t] = True
                added += 1
            else:
                blocked[t] = True
        if added == 0:
            dead_rounds += 1
            if dead_rounds >= 50:
                print(f"WARNING: device LH: every positive-gradient "
                      f"candidate is numerically dependent at rel_err="
                      f"{rel:.3e}; stopping", flush=True)
                break
            continue
        dead_rounds = 0
        z = np.zeros(ncols)
        z[cols] = weights_now()
        guard = 0
        while (z[passive] <= tol).any():
            guard += 1
            if guard > 10 * max(len(cols), 1):
                break
            qq = passive & (z <= tol)
            alpha = np.min(x[qq] / (x[qq] - z[qq]))
            x = x + alpha * (z - x)
            dropm = passive & (np.abs(x) < tol)
            for j in np.where(dropm)[0]:
                remove(cols.index(int(j)))
            passive &= ~dropm
            blocked[:] = False
            z = np.zeros(ncols)
            if cols:
                z[cols] = weights_now()
        x = z
        resid = d - Ap @ x[np.asarray(cols, np.int64)]
        rel = np.linalg.norm(resid) / norm_d if norm_d > 0 else 0.0
        num_pos = int((x > 0).sum())
        if verbose and rounds % 20 == 0:
            print(f"  device LH: round {rounds}, support {num_pos}, "
                  f"rel_err {rel:.2e}", flush=True)
        if rel_err_thresh and rel < rel_err_thresh:
            break
        if max_support is not None and num_pos >= max_support:
            break
        if rel < best_rel - 1e-12 * max(best_rel, 1.0):
            best_rel, stall = rel, 0
        else:
            stall += 1
            if stall >= 25 and add_budget > 1:
                # block pivoting can cycle (the batch is added between
                # LS solves, losing the textbook one-at-a-time progress
                # guarantee); the single-add walk always makes strict
                # residual progress in exact arithmetic. The fallback is
                # permanent: on correlated ECSW pools that cycle once,
                # re-batching just re-enters the cycle
                add_budget = 1
                if verbose:
                    print("  device LH: batched adds cycling; falling "
                          "back to single-add", flush=True)
            if stall >= stall_limit:
                print(f"WARNING: device LH stalled at rel_err={rel:.3e}"
                      f" (support {num_pos}); stopping", flush=True)
                break
    if verbose:
        print(f"  device LH done: {rounds} rounds, support "
              f"{int((x > 0).sum())}, rel_err {rel:.3e}", flush=True)

    full = np.full(ny * nx, float(bc_w))
    full[cand] = 0.0
    full[x > 0] = x[x > 0]
    return full


def multilevel_nnls_weights_device(C_dev, grid: Grid2D,
                                   num_subdomains: int = 12,
                                   bc_w: float = 50.0,
                                   rel_err_thresh: float = 1e-4,
                                   fista_iters: int = 2000,
                                   support_cap_per_block: int = 400,
                                   ring: str = "inflow",
                                   level1: str = "global",
                                   support_cap_total: Optional[int] = None,
                                   verbose: bool = False) -> np.ndarray:
    """Fine-grid multilevel NNLS with C resident on the device end to end.

    Same two-level recipe as `multilevel_nnls_weights` (reference
    run_HPROM_ecsw_multilevel.py:89-140), for grids where C should not
    visit the host: level-1 support screening runs as FISTA on the
    device; only the screened-support columns (m x |U|) reach the host,
    where `nnls_gram` finishes with an EXACT Lawson-Hanson solve.

    level1 selects the screening shape:
      "global" (default) — ONE masked FISTA over all candidate columns;
        the support is the top-`support_cap_total` positive weights
        (8000 when None), each kept column having earned its place
        against every other candidate.
      "block" — per-subdomain FISTA on contiguous column blocks with
        per-block top-`support_cap_per_block` truncation.

    Non-candidate columns (the `ring` mask) are masked instead of
    gathered — a zero column has zero gradient, so FISTA/NNLS never
    select it and the column blocks stay contiguous slices. C_dev stays
    on its device (the CUDA device for an array that is not a tensor).
    """
    C_dev = as_tensor(C_dev)
    m, ncols = C_dev.shape
    ny, nx = grid.ny, grid.nx
    assert ncols == ny * nx
    cand = interior_mask(grid, ring).ravel()
    cand_dev = torch.as_tensor(cand, device=C_dev.device).to(C_dev.dtype)
    d_full = C_dev @ cand_dev

    if level1 == "global":
        # ONE masked FISTA over every candidate column, without a masked
        # copy of C: the mask rides on the gradient, so non-candidates
        # have zero gradient and stay at zero
        def ctc(v):
            return ((C_dev @ v) @ C_dev) * cand_dev

        def rel_of(x):
            return float(torch.linalg.vector_norm(C_dev @ x - d_full)
                         / (torch.linalg.vector_norm(d_full) + 1e-30))

        ctd = (d_full @ C_dev) * cand_dev
        b = cand_dev / torch.linalg.vector_norm(cand_dev)
        for _ in range(16):
            nb = ctc(b)
            b = nb / (torch.linalg.vector_norm(nb) + 1e-30)
        lip = torch.linalg.vector_norm(ctc(b)) \
            / (torch.linalg.vector_norm(b) + 1e-30)
        step = 1.0 / (lip + 1e-30)
        x = torch.zeros(ncols, dtype=C_dev.dtype, device=C_dev.device)
        y = x
        for i, mom in enumerate(_fista_momenta(fista_iters, C_dev.dtype)):
            grad = (ctc(y) - ctd) * cand_dev
            x_new = torch.clamp_min(y - step * grad, 0.0)
            y = x_new + mom * (x_new - x)
            x = x_new
            if verbose and (i + 1) % 1000 == 0:
                print(f"  global fista: {i + 1}/{fista_iters} its, rel "
                      f"{rel_of(x):.3e}", flush=True)
        rel = rel_of(x)
        x = x.cpu().numpy()
        cap = support_cap_total or 8000
        pos = np.flatnonzero(x > 1e-8 * max(float(x.max()), 1e-30))
        if pos.size > cap:
            pos = pos[np.argsort(x[pos])[::-1][:cap]]
        support = pos
        if verbose:
            print(f"  global fista: rel {rel:.3e}, support "
                  f"{support.size}", flush=True)
    elif level1 == "block":
        blk = -(-ncols // num_subdomains)
        support: list = []
        for b in range(num_subdomains):
            lo, hi = b * blk, min((b + 1) * blk, ncols)
            c_blk = C_dev[:, lo:hi] * cand_dev[None, lo:hi]
            d_blk = c_blk.sum(dim=1)
            x, rel = nnls_fista(c_blk, d_blk, num_iters=fista_iters)
            x = x.cpu().numpy()
            pos = np.flatnonzero(x > 1e-8 * max(float(x.max()), 1e-30))
            if pos.size > support_cap_per_block:
                pos = pos[np.argsort(x[pos])[::-1]
                          [:support_cap_per_block]]
            support.extend(int(p) for p in lo + pos)
            if verbose:
                print(f"  fista block {b}: rel {float(rel):.3e}, "
                      f"kept {pos.size}, union {len(support)}",
                      flush=True)
    else:
        raise ValueError(f"unknown level1 method: {level1}")

    support = np.asarray(sorted(set(int(p) for p in support)),
                         dtype=np.int64)
    if support.size == 0:
        raise ValueError("device multilevel NNLS: empty level-1 support")

    # only the screened columns and the target reach the host: one
    # column gather (the JAX package selects them by chunked one-hot
    # matmuls, because a TPU gather on the C-sized buffer allocated a
    # C-sized temporary)
    sel = torch.as_tensor(support, device=C_dev.device)
    Cs = C_dev.index_select(1, sel).double().cpu().numpy()
    d_h = d_full.double().cpu().numpy()
    if verbose:
        print(f"  level-2 host solve: {Cs.shape}", flush=True)
    w2, _, _ = nnls_gram(Cs, d_h, rel_err_thresh=rel_err_thresh,
                         verbose=verbose)

    full = np.full(ny * nx, float(bc_w))
    full[cand] = 0.0
    full[support] = w2
    return full
