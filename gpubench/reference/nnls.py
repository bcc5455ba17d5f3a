"""Frozen copy of the port's Lawson-Hanson NNLS on a Gram Cholesky
(`nnls_gram` and `_GramCholesky` of finitedifference_tpu_torch/ecsw.py,
with its warm start left out), NumPy and SciPy only, so that the offline
model's ECSW weights come from the benchmark's own code.

Lawson-Hanson active sets with the early stops of the reference's
lsqnonneg (`rel_err_thresh`, `max_support`); the passive-set least-squares
solve comes from an incrementally extended Cholesky factor of A^T A.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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


def nnls_gram(C, d, tol: Optional[float] = None, itmax_factor: int = 100,
              max_support: Optional[int] = None,
              rel_err_thresh: float = 0.0,
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
