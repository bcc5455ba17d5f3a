"""The port's POD against the JAX package on the CPU: exact SVD modes up
to column sign, randomized SVD by subspace angle against the exact SVD
(its torch.Generator sketch is not jax.random's), the same podsize
truncations."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu import pod as jpod
from finitedifference_tpu_torch import pod as tpod
from finitedifference_tpu_torch import convert

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")


def decaying_matrix(m=300, n=80, decay=0.5, seed=0):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(m, n)))
    v, _ = np.linalg.qr(rng.normal(size=(n, n)))
    s = decay ** np.arange(n)
    return (u * s) @ v.T


def max_subspace_angle(u1, u2):
    """Largest principal angle (radians) between two column spaces."""
    q1, _ = np.linalg.qr(u1)
    q2, _ = np.linalg.qr(u2)
    cos = np.linalg.svd(q1.T @ q2, compute_uv=False)
    return float(np.arccos(np.clip(cos.min(), -1.0, 1.0)))


@pytest.mark.parametrize("num_modes", [15, None])
def test_pod_svd_matches_jax_up_to_sign(num_modes):
    a = decaying_matrix()
    ju, js = jpod.pod(jnp.asarray(a), num_modes=num_modes, method="svd")
    tu, ts = tpod.pod(to_torch(a), num_modes=num_modes, method="svd")
    ju, tu = np.asarray(ju), tu.numpy()
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-12,
                               atol=1e-14)
    # the leading (well separated) modes agree up to sign
    lead = 15
    dots = np.abs(np.sum(ju[:, :lead] * tu[:, :lead], axis=0))
    np.testing.assert_allclose(dots, 1.0, atol=1e-12)


def test_pod_rsvd_subspace_matches_exact_svd():
    """rsvd: the same singular values as JAX's rsvd and the exact SVD,
    and the exact SVD's leading subspace."""
    a = decaying_matrix()
    k = 15
    s_exact = np.linalg.svd(a, compute_uv=False)[:k]
    u_exact = np.linalg.svd(a, full_matrices=False)[0][:, :k]
    tu, ts = tpod.pod(to_torch(a), num_modes=k, method="rsvd",
                      random_state=3)
    _, js = jpod.pod(jnp.asarray(a), num_modes=k, method="rsvd",
                     random_state=3)
    np.testing.assert_allclose(ts.numpy(), s_exact, rtol=1e-9)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-9)
    assert max_subspace_angle(tu.numpy(), u_exact) < 1e-7


def test_randomized_svd_seeded_and_reconstructs():
    """Same generator seed -> same sketch; the rank-k reconstruction
    error equals the exact truncation's."""
    a = to_torch(decaying_matrix(seed=2))
    k = 20
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    u1, s1, vh1 = tpod.randomized_svd(a, k, generator=g1)
    u2, _, _ = tpod.randomized_svd(a, k, generator=g2)
    assert torch.equal(u1, u2)
    s_all = np.linalg.svd(a.numpy(), compute_uv=False)
    err = float(torch.linalg.norm(a - (u1 * s1) @ vh1))
    assert err <= np.linalg.norm(s_all[k:]) * 1.01 + 1e-12


def test_pod_f32_on_its_device():
    """A float32 snapshot matrix stays float32 (the chip run's POD)."""
    a = to_torch(decaying_matrix(), dtype=torch.float32)
    u, s = tpod.pod(a, num_modes=10, method="rsvd", random_state=0)
    assert u.dtype == s.dtype == torch.float32
    assert u.shape == (300, 10)
    s_exact = np.linalg.svd(a.double().numpy(), compute_uv=False)[:10]
    np.testing.assert_allclose(s.numpy(), s_exact, rtol=1e-5)


def test_unknown_method():
    with pytest.raises(ValueError):
        tpod.pod(torch.eye(4), method="qr")


@pytest.mark.parametrize("kw", [
    {"energy_thresh": 0.999},
    {"energy_thresh": 0.5, "min_size": 3},
    {"energy_thresh": 0.99999999, "max_size": 2},
    {"min_size": 2},
    {"energy_thresh": 1.0},
])
def test_podsize_matches_jax(kw):
    svals = np.array([10.0, 1.0, 0.1, 0.01, 1e-9])
    assert tpod.podsize(to_torch(svals), **kw) == jpod.podsize(svals, **kw)


def test_podsize_requires_criterion():
    with pytest.raises(ValueError):
        tpod.podsize(np.ones(3))


def test_adaptive_rank_discovery():
    """A rank-12 matrix: the adaptive rSVD keeps exactly 12 modes, as
    the JAX package's does, and reconstructs to the tolerance."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(200, 12)) @ rng.normal(size=(12, 90))
    ju, _, _ = jpod.randomized_svd_adaptive(jnp.asarray(a), tol=1e-8,
                                            initial_rank=4)
    u, s, vh = tpod.randomized_svd_adaptive(to_torch(a), tol=1e-8,
                                            initial_rank=4)
    assert u.shape[1] == ju.shape[1] == 12
    recon = (u * s) @ vh
    assert float(torch.linalg.norm(to_torch(a) - recon)) \
        <= 1e-8 * np.linalg.norm(a)
    z = tpod.randomized_svd_adaptive(torch.zeros(5, 4, dtype=torch.float64))
    assert [t.shape for t in z] == [(5, 0), (0,), (0, 4)]


def test_split_basis():
    u = to_torch(np.arange(40.0).reshape(4, 10))
    for args in ((3,), (3, 4)):
        jp, js = jpod.split_basis(jnp.asarray(u.numpy()), *args)
        tp, ts = tpod.split_basis(u, *args)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
