"""ECSW hyper-reduction (PyTorch): training matrix, NNLS, weight recipe.

Counterpart of the part of finitedifference_tpu/ecsw.py that the HPROM
recipe runs (runners/run_hprom.py:34-91):

* `ecsw_training_matrix`: the per-snapshot Gauss-Newton work terms
  C[i*k+j, cell] = r_u[cell]*(J V)_u[cell, j] + r_v[cell]*(J V)_v[cell, j]
  (reference compute_ECSW_training_matrix_2D, hypernet2D.py:2719-2742),
  as batched stencil passes over the snapshots on their device.
* `nnls`, `nnls_gram`: Lawson-Hanson active sets with the reference's
  early stops (`rel_err_thresh`, `max_support`; lsqnonneg.py:4-110), host
  NumPy as in the JAX package, copied from it unchanged.
* `compute_ecsw_weights`: interior NNLS + fixed boundary-ring weights
  (run_HPROM_ecsw_joshua.py:55-111).

Not ported yet (ROADMAP Queue A, item 9): method="ecm" and
`empirical_cubature`, `nnls_fista`, the sequential, multilevel and
device NNLS variants, and `ecsw_training_matrix_closure`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.stencil import (
    apply_jacobian,
    burgers_residual_flat,
    inflow_bc_term,
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
            resid = d - C[:, cols] @ x[cols]
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
        resid = d - C[:, cols] @ x[cols]
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
    """

    def __init__(self, G, b):
        self.G = G
        self.b = b
        self.L = np.zeros((0, 0))
        self.atb = np.zeros(0)
        self.cols: list = []

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
            return True
        u = self.G[:, self.cols].T @ g            # (k,)
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
    device; the solve runs on the host in float64.

    method: "nnls" (Lawson-Hanson on the Gram Cholesky, `nnls_gram`),
    "nnls_lstsq" (the fresh-lstsq variant, `nnls`) or "scipy_nnls".
    "ecm" raises NotImplementedError: empirical cubature is not ported
    yet (ROADMAP Queue A, item 2); its keywords `ecm_tolerance` and
    `ecm_rank` sit where the JAX package has them, so its calls bind.
    """
    if isinstance(C, torch.Tensor):
        C = C.detach().cpu().numpy()
    C = np.asarray(C)
    ny, nx = grid.ny, grid.nx
    interior = interior_mask(grid, ring)
    flat_interior = interior.ravel()
    Ci = C[:, flat_interior]

    if method == "nnls":
        w_int, _, _ = nnls_gram(Ci, Ci.sum(axis=1),
                                rel_err_thresh=rel_err_thresh,
                                max_support=max_support, verbose=verbose)
    elif method == "nnls_lstsq":
        w_int, _, _ = nnls(Ci, Ci.sum(axis=1),
                           rel_err_thresh=rel_err_thresh,
                           max_support=max_support, verbose=verbose)
    elif method == "scipy_nnls":
        import scipy.optimize
        w_int, _ = scipy.optimize.nnls(Ci, Ci.sum(axis=1))
    elif method == "ecm":
        raise NotImplementedError(
            "method='ecm' (empirical cubature) is not ported yet: "
            "ROADMAP Queue A, item 2 (the rest of ecsw.py)")
    else:
        raise ValueError(f"unknown weight method: {method}")

    full = np.full(ny * nx, float(bc_w))
    full[flat_interior] = w_int
    return full
