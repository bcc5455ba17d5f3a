"""POD basis construction (PyTorch): exact SVD, randomized SVD (Halko),
and an adaptive error-controlled variant.

Counterpart of finitedifference_tpu/pod.py. The randomized range finder
draws its sketch from a torch.Generator seeded on the snapshot matrix's
device, so it is not bit-equal to the JAX package's jax.random sketch;
both capture the same leading subspace (the tests compare subspace
angles against the exact SVD).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from finitedifference_tpu_torch.device import as_tensor


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def randomized_svd(a: torch.Tensor, num_modes: int,
                   generator: Optional[torch.Generator] = None,
                   n_oversamples: int = 10, n_iter: int = 7):
    """Halko randomized truncated SVD of `a` (m, n) -> (U, s, Vh).

    Power iteration with QR re-orthonormalization each step. Without a
    generator the sketch is seeded with 0 on a's device."""
    if generator is None:
        generator = _generator(a.device, 0)
    m, n = a.shape
    k = min(num_modes + n_oversamples, min(m, n))
    omega = torch.randn((n, k), generator=generator, dtype=a.dtype,
                        device=a.device)
    q, _ = torch.linalg.qr(a @ omega)
    for _ in range(n_iter):
        z, _ = torch.linalg.qr(a.T @ q)
        q, _ = torch.linalg.qr(a @ z)
    b = q.T @ a                      # (k, n)
    ub, s, vh = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[:, :num_modes], s[:num_modes], vh[:num_modes, :]


def pod(snaps, num_modes: Optional[int] = None, method: str = "svd",
        random_state: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """POD modes of a snapshot matrix (reference POD, hypernet2D.py:2670).

    Returns (U, s). method 'svd' = exact thin SVD; 'rsvd' = randomized,
    its sketch seeded with `random_state` (0 when None)."""
    snaps = as_tensor(snaps)
    if method == "svd":
        u, s, _ = torch.linalg.svd(snaps, full_matrices=False)
        if num_modes is not None:
            return u[:, :num_modes], s[:num_modes]
        return u, s
    if method == "rsvd":
        if num_modes is None:
            num_modes = min(snaps.shape)
        gen = _generator(snaps.device,
                         0 if random_state is None else random_state)
        u, s, _ = randomized_svd(snaps, num_modes, generator=gen)
        return u, s
    raise ValueError(f"Unknown POD method {method!r}; use 'svd' or 'rsvd'.")


def podsize(svals, energy_thresh: Optional[float] = None,
            min_size: Optional[int] = None,
            max_size: Optional[int] = None) -> int:
    """Basis size meeting an energy threshold and/or size bounds
    (reference podsize, hypernet2D.py:2695-2717)."""
    if energy_thresh is None and min_size is None and max_size is None:
        raise ValueError("Must specify at least one truncation criterion")
    if isinstance(svals, torch.Tensor):
        svals = svals.detach().cpu().numpy()
    svals = np.asarray(svals)
    if energy_thresh is not None:
        energies = np.cumsum(np.square(svals)) / np.square(svals).sum()
        hits = np.nonzero(energies >= energy_thresh)[0]
        # a threshold never reached (e.g. 1.0 with roundoff) keeps every
        # mode
        numvecs = int(hits[0]) if hits.size else len(svals)
    else:
        numvecs = int(min_size)
    if min_size is not None:
        numvecs = max(numvecs, int(min_size))
    if max_size is not None:
        numvecs = min(numvecs, int(max_size))
    return numvecs


def randomized_svd_adaptive(a, tol: float = 1e-8,
                            generator: Optional[torch.Generator] = None,
                            initial_rank: int = 32,
                            max_rank: Optional[int] = None):
    """Error-controlled randomized SVD.

    Doubles the sketch rank until ||A - U S Vh||_F / ||A||_F <= tol, then
    truncates singular values below tol * s_max (the reference's adaptive
    Halko class, randomized_singular_value_decomposition.py:36-220). Each
    trial draws a fresh sketch from `generator`."""
    a = as_tensor(a)
    m, n = a.shape
    if generator is None:
        generator = _generator(a.device, 0)
    max_rank = min(m, n) if max_rank is None else min(max_rank, min(m, n))
    norm_a = float(torch.linalg.norm(a))
    if norm_a == 0.0:
        def z(*shape):
            return torch.zeros(shape, dtype=a.dtype, device=a.device)
        return z(m, 0), z(0), z(0, n)

    rank = min(initial_rank, max_rank)
    while True:
        u, s, vh = randomized_svd(a, rank, generator=generator, n_iter=4)
        resid = float(torch.linalg.norm(a - (u * s) @ vh))
        if resid / norm_a <= tol or rank >= max_rank:
            break
        rank = min(2 * rank, max_rank)
    keep = int((s > tol * float(s[0])).sum()) if s.numel() else 0
    keep = max(keep, 1)
    return u[:, :keep], s[:keep], vh[:keep, :]


def split_basis(u, num_primary: int, num_secondary: Optional[int] = None):
    """Split POD modes into primary/secondary blocks (U_p, U_s):
    U_p = U[:, :n_p], U_s = U[:, n_p:n_p+n_s]."""
    u_p = u[:, :num_primary]
    if num_secondary is None:
        u_s = u[:, num_primary:]
    else:
        u_s = u[:, num_primary:num_primary + num_secondary]
    return u_p, u_s
