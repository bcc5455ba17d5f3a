"""Projected training pairs for the closures (host NumPy).

Counterpart of the part of finitedifference_tpu/training/rnm_train.py
that every closure shares: project snapshots onto a POD basis and split
the coefficients into primary q_p = q[:n_p] and secondary
q_s = q[n_p:n_p+n_s]. The RNM network trainer itself is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def project_snapshots(basis, snaps_t, num_primary: int,
                      num_secondary: Optional[int] = None,
                      mu_labels=None):
    """q = basis^T snaps -> (q_p, q_s) training pairs.

    snaps_t: (n_samples, 2n) row-major samples. Optionally append the
    (mu1, mu2) labels to q_p (the `_mu_included` trainer variant).
    """
    q = np.asarray(snaps_t) @ np.asarray(basis)   # (S, k)
    n_p = num_primary
    n_s = num_secondary if num_secondary is not None else q.shape[1] - n_p
    q_p = q[:, :n_p]
    q_s = q[:, n_p:n_p + n_s]
    if mu_labels is not None:
        q_p = np.hstack([q_p, np.asarray(mu_labels)])
    return q_p, q_s
