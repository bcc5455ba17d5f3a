"""The port's RBF closures (finitedifference_tpu_torch.closures) against the
JAX package's, on the CPU, float64.

The same seeded NumPy inputs go to the JAX function and to its port:
- the scaler (fit_minmax, identity_scaler) to 1e-15;
- kernel_matrix and phi'(r)/r for all five kernels to 1e-13;
- the global closure's predict, Jacobian and fused form to 1e-10
  (relative), with the JAX fit's weights carried across (convert) and
  with the port's own fit;
- the kNN closure's, to 1e-10, on the pure float64 Cholesky branch
  (ridge 1e-8), the float32-factor + refinement branch (ridge 1e-5) and
  the QR branch (multiquadric);
- every analytic Jacobian against torch.func.jacfwd of the port's
  predict (1e-10);
- manifold_decoder and manifold_decoder_fused, with and without ref, to
  1e-12.

The fits are compared at shape parameters whose kernel matrices have a
condition number of at most ~1e6: there two LAPACK builds agree to
~1e-13 (measured); near 1e10 (epsilon 0.3 on these points) any two
Cholesky or SVD implementations, JAX's own against SciPy's included,
differ by ~1e-7, a property of the matrix and not of the port.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu.closures import common as jcommon
from finitedifference_tpu.closures import rbf as jrbf
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.closures import common as tcommon
from finitedifference_tpu_torch.closures import rbf as trbf

to_torch = functools.partial(convert.to_torch, device="cpu")
KERNELS = ("gaussian", "imq", "multiquadric", "linear", "matern")
SCALE = np.array([1.0, 0.5, 2.0])
GLOBAL_EPS = 2.0
KNN_EPS = 1.0
KNN_K = 12
# (kernel, ridge): the f64 Cholesky, the f32 factor refined in f64, QR
KNN_BRANCHES = [("gaussian", 1e-8), ("gaussian", 1e-5),
                ("multiquadric", 1e-8), ("imq", 1e-8), ("matern", 1e-5),
                ("linear", 1e-8)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads only spin, and
    their load slows the tests that share the machine. One thread for the
    module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def data():
    """60 training pairs q_p (3) -> q_s (4) of a smooth map, and 6
    queries inside the training box."""
    rng = np.random.default_rng(3)
    q_p = rng.uniform(-2, 3, size=(60, 3)) * SCALE
    q_s = np.stack([np.sin(q_p[:, 0]) + q_p[:, 1] ** 2,
                    np.cos(q_p[:, 2]) * q_p[:, 0],
                    np.tanh(q_p.sum(1)), q_p[:, 1] * q_p[:, 2]], 1)
    queries = rng.uniform(-2, 3, size=(6, 3)) * SCALE
    return q_p, q_s, queries


# ---------------------------------------------------------------- scaler


def test_fit_minmax_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 4)) * np.array([1.0, 10.0, 1e-3, 0.0]) + 2.0
    want = jcommon.fit_minmax(x)
    got = tcommon.fit_minmax(x, device="cpu")
    np.testing.assert_allclose(npy(got.scale_), np.asarray(want.scale_),
                               rtol=1e-15)
    np.testing.assert_allclose(npy(got.min_), np.asarray(want.min_),
                               rtol=1e-15, atol=1e-15)
    # the zero-span column counts as span 1: scale 2, like sklearn
    assert float(got.scale_[3]) == 2.0
    t = got.transform(torch.as_tensor(x))
    np.testing.assert_allclose(npy(t), np.asarray(want.transform(x)),
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose([float(t[:, :3].min()), float(t[:, :3].max())],
                               [-1.0, 1.0], rtol=1e-15)
    np.testing.assert_allclose(npy(got.inverse_transform(t)), x,
                               rtol=1e-14)
    # a tensor is fitted where it lies, in its dtype
    f32 = tcommon.fit_minmax(torch.as_tensor(x, dtype=torch.float32),
                             feature_range=(0.0, 1.0))
    assert f32.scale_.dtype == torch.float32
    np.testing.assert_allclose(
        npy(f32.scale_), np.asarray(jcommon.fit_minmax(
            x.astype(np.float32), feature_range=(0.0, 1.0)).scale_),
        rtol=1e-6)


def test_identity_scaler():
    s = tcommon.identity_scaler(5, device="cpu")
    want = jcommon.identity_scaler(5)
    np.testing.assert_array_equal(npy(s.scale_), np.asarray(want.scale_))
    np.testing.assert_array_equal(npy(s.min_), np.asarray(want.min_))
    assert s.scale_.dtype == torch.float64
    y = torch.arange(5.0, dtype=torch.float64)
    assert torch.equal(s.transform(y), y)


# --------------------------------------------------------------- kernels


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matrix_matches_jax(kernel):
    rng = np.random.default_rng(1)
    xa = rng.normal(size=(7, 3))
    xb = np.vstack([rng.normal(size=(4, 3)), xa[2:3]])   # one r = 0
    for eps in (0.05, 1.3):
        want = np.asarray(jrbf.kernel_matrix(jnp.asarray(xa),
                                             jnp.asarray(xb), eps, kernel))
        got = trbf.kernel_matrix(to_torch(xa), to_torch(xb), eps, kernel)
        assert got.shape == (7, 5)
        np.testing.assert_allclose(npy(got), want, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_derivative_matches_jax(kernel):
    """phi'(r)/r, with the linear kernel's 1/max(r, 1e-12) guard at r=0,
    and phi'(r)/r * r against autograd's phi'(r)."""
    r = np.array([0.0, 1e-13, 0.3, 1.0, 2.5])
    for eps in (0.05, 1.3):
        want = np.asarray(jrbf.KERNELS[kernel][1](jnp.asarray(r), eps))
        got = trbf.KERNELS[kernel][1](to_torch(r), eps)
        np.testing.assert_allclose(npy(got), want, rtol=1e-13)
        rr = to_torch(r[2:]).requires_grad_()
        phi = trbf.KERNELS[kernel][0](rr, eps)
        (dphi,) = torch.autograd.grad(phi.sum(), rr)
        np.testing.assert_allclose(npy(got[2:] * rr), npy(dphi),
                                   rtol=1e-12)
    if kernel == "linear":
        assert float(got[0]) == 1e12


def test_unknown_kernel_raises():
    x = torch.zeros((3, 2), dtype=torch.float64)
    for fn in (lambda: trbf.kernel_matrix(x, x, 1.0, "cubic"),
               lambda: trbf.fit_global_rbf(x, x, 1.0, kernel="cubic"),
               lambda: trbf.fit_knn_rbf(x, x, 1.0, 2, kernel="cubic")):
        with pytest.raises(ValueError, match=r"unknown RBF kernel 'cubic'"
                                             r"; valid: \['gaussian'"):
            fn()
    assert sorted(trbf.KERNELS) == sorted(jrbf.KERNELS)


@pytest.mark.parametrize("kernel", sorted(trbf.KERNELS))
def test_batched_svd_solve_equals_one_by_one(kernel):
    """The grid search's one batched SVD per kernel (a stack over eps)
    gives each eps the weights of its own unbatched solve."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.uniform(-1, 1, (30, 3)))
    rhs = torch.as_tensor(rng.normal(size=(30, 4)))
    eps = torch.as_tensor(np.logspace(-2, 1, 6))
    eye = 1e-8 * torch.eye(30, dtype=torch.float64)
    phi = trbf.kernel_matrix(x, x, eps[:, None, None], kernel)
    got = trbf.svd_solve(phi.expand(6, 30, 30) + eye, rhs)
    for i, e in enumerate(eps.tolist()):
        want = trbf.svd_solve(trbf.kernel_matrix(x, x, e, kernel) + eye, rhs)
        np.testing.assert_allclose(npy(got[i]), npy(want), rtol=1e-10,
                                   atol=1e-10 * float(want.abs().max()))


# ---------------------------------------------------------------- global


def _closure_outputs(closure, queries):
    outs = []
    for y in queries:
        y = to_torch(y)
        p, j = closure.predict_and_jacobian(y)
        outs.append((npy(closure.predict(y)), npy(closure.jacobian(y)),
                     npy(p), npy(j)))
    return [np.stack(o) for o in zip(*outs)]


def _jax_outputs(closure, queries):
    outs = []
    for y in queries:
        y = jnp.asarray(y)
        p, j = closure.predict_and_jacobian(y)
        outs.append((np.asarray(closure.predict(y)),
                     np.asarray(closure.jacobian(y)), np.asarray(p),
                     np.asarray(j)))
    return [np.stack(o) for o in zip(*outs)]


@pytest.mark.parametrize("kernel", KERNELS)
def test_global_rbf_matches_jax(data, kernel):
    """predict, jacobian and the fused pair: with the JAX fit's weights
    carried across, and with the port's own fit."""
    q_p, q_s, queries = data
    jm = jrbf.fit_global_rbf(q_p, q_s, GLOBAL_EPS, kernel=kernel)
    want = _jax_outputs(jrbf.global_rbf_closure(jm), queries)
    carried = convert.global_rbf_from_jax(jm, device="cpu")
    own = trbf.fit_global_rbf(q_p, q_s, GLOBAL_EPS, kernel=kernel,
                              device="cpu")
    np.testing.assert_allclose(npy(own.q_p_train),
                               np.asarray(jm.q_p_train), rtol=1e-14,
                               atol=1e-14)
    assert own.epsilon == jm.epsilon and own.kernel == jm.kernel
    for model in (carried, own):
        got = _closure_outputs(trbf.global_rbf_closure(model), queries)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert rel(g, w) <= 1e-10
        # the fused pair is the separate calls
        np.testing.assert_allclose(got[2], got[0], rtol=1e-14)
        np.testing.assert_allclose(got[3], got[1], rtol=1e-14)
    assert rel(npy(own.w_global), np.asarray(jm.w_global)) <= 1e-8


@pytest.mark.parametrize("kernel", KERNELS)
def test_global_rbf_jacobian_is_jacfwd(data, kernel):
    q_p, q_s, queries = data
    model = trbf.fit_global_rbf(q_p, q_s, GLOBAL_EPS, kernel=kernel,
                                device="cpu")
    for y in queries[:3]:
        y = to_torch(y)
        ad = torch.func.jacfwd(lambda v: trbf.rbf_global_predict(model, v))(y)
        assert rel(trbf.rbf_global_jacobian(model, y), ad) <= 1e-10


def test_global_rbf_precision_bridge(data):
    """A float32 query evaluates the core in the model's float64 and is
    cast back: float32 out, equal to the float64 result rounded."""
    q_p, q_s, queries = data
    closure = trbf.global_rbf_closure(
        trbf.fit_global_rbf(q_p, q_s, GLOBAL_EPS, device="cpu"))
    y64 = to_torch(queries[0])
    y32 = y64.to(torch.float32)
    for fn in (closure.predict, closure.jacobian):
        got, want = fn(y32), fn(y32.to(torch.float64)).to(torch.float32)
        assert got.dtype == torch.float32 and torch.equal(got, want)
    p, j = closure.predict_and_jacobian(y32)
    assert p.dtype == j.dtype == torch.float32


# ------------------------------------------------------------------- kNN


@pytest.mark.parametrize("kernel,ridge", KNN_BRANCHES)
def test_knn_rbf_matches_jax(data, kernel, ridge):
    q_p, q_s, queries = data
    jm = jrbf.fit_knn_rbf(q_p, q_s, KNN_EPS, KNN_K, kernel=kernel,
                          ridge=ridge)
    want = _jax_outputs(jrbf.knn_rbf_closure(jm), queries)
    carried = convert.knn_rbf_from_jax(jm, device="cpu")
    own = trbf.fit_knn_rbf(q_p, q_s, KNN_EPS, KNN_K, kernel=kernel,
                           ridge=ridge, device="cpu")
    assert (own.neighbors, own.ridge, own.kernel) == \
        (jm.neighbors, jm.ridge, jm.kernel)
    for model in (carried, own):
        got = _closure_outputs(trbf.knn_rbf_closure(model), queries)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert rel(g, w) <= 1e-10
        np.testing.assert_allclose(got[2], got[0], rtol=1e-14)
        np.testing.assert_allclose(got[3], got[1], rtol=1e-14)


def test_knn_neighbours_and_branches(data):
    """The k nearest by float32 squared distance (torch.topk of -d2), the
    same set as JAX's; the refined branch recovers the float64 solve."""
    q_p, q_s, queries = data
    jm = jrbf.fit_knn_rbf(q_p, q_s, KNN_EPS, KNN_K)
    tm = convert.knn_rbf_from_jax(jm, device="cpu")
    for y in queries:
        xj = jm.scaler.transform(jnp.asarray(y))
        xk_j, _ = jrbf._knn_gather(jm, xj)
        xk_t, yk_t = trbf._knn_gather(tm, tm.scaler.transform(to_torch(y)))
        assert sorted(map(tuple, np.asarray(xk_j))) == \
            sorted(map(tuple, npy(xk_t)))
    # ridge 1e-5: f32 factor + 3 float64 passes == the float64 Cholesky
    refined = tm._replace(ridge=1e-5)
    w_ref = trbf._knn_local_weights(refined, xk_t, yk_t)
    phi = trbf.kernel_matrix(xk_t, xk_t, KNN_EPS, "gaussian") \
        + 1e-5 * torch.eye(KNN_K, dtype=torch.float64)
    w64 = torch.linalg.solve(phi, yk_t)
    assert w_ref.dtype == torch.float64
    assert rel(w_ref, w64) <= 1e-12
    assert rel(w_ref, w64) > 0    # not the float64 factorization's bits


@pytest.mark.parametrize("kernel,ridge", KNN_BRANCHES)
def test_knn_rbf_jacobian_is_jacfwd(data, kernel, ridge):
    q_p, q_s, queries = data
    model = trbf.fit_knn_rbf(q_p, q_s, KNN_EPS, KNN_K, kernel=kernel,
                             ridge=ridge, device="cpu")
    for y in queries[:3]:
        y = to_torch(y)
        ad = torch.func.jacfwd(lambda v: trbf.rbf_knn_predict(model, v))(y)
        assert rel(trbf.rbf_knn_jacobian(model, y), ad) <= 1e-10


def test_knn_not_positive_definite_gives_nan():
    """A Cholesky of a matrix that is not positive definite yields NaN, as
    JAX's does, and raises nothing (no host sync, no other solver): the
    solve through it is NaN in both packages."""
    from jax.scipy.linalg import cho_factor, cho_solve

    a = np.array([[1.0, 2.0], [2.0, 1.0]])
    b = np.array([[1.0], [3.0]])
    low = trbf._cho_factor(torch.as_tensor(a))
    assert np.isnan(npy(low)[np.tril_indices(2)]).all()
    assert torch.isnan(torch.cholesky_solve(torch.as_tensor(b), low)).all()
    assert np.isnan(np.asarray(cho_solve(cho_factor(a), b))).all()


# --------------------------------------------------------------- decoders


@pytest.fixture(scope="module")
def decoder_inputs(data):
    q_p, q_s, queries = data
    rng = np.random.default_rng(5)
    u_p = np.linalg.qr(rng.normal(size=(50, 3)))[0]
    u_s = np.linalg.qr(rng.normal(size=(50, 4)))[0]
    ref = rng.normal(size=50)
    jm = jrbf.fit_global_rbf(q_p, q_s, GLOBAL_EPS, kernel="imq")
    return u_p, u_s, ref, jm, queries


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("closure", ["none", "global", "knn"])
def test_manifold_decoders_match_jax(decoder_inputs, data, with_ref,
                                     closure):
    u_p, u_s, ref, jm, queries = decoder_inputs
    ref = ref if with_ref else None
    if closure == "none":
        jc = tc = None
    elif closure == "global":
        jc = jrbf.global_rbf_closure(jm)
        tc = trbf.global_rbf_closure(convert.global_rbf_from_jax(
            jm, device="cpu"))
    else:
        jk = jrbf.fit_knn_rbf(data[0], data[1], KNN_EPS, KNN_K)
        jc = jrbf.knn_rbf_closure(jk)
        tc = trbf.knn_rbf_closure(convert.knn_rbf_from_jax(jk,
                                                           device="cpu"))
    jdec, jjac = jcommon.manifold_decoder(u_p, u_s, jc, ref=ref)
    jfused = jcommon.manifold_decoder_fused(u_p, u_s, jc, ref=ref)
    u_p_t, u_s_t = to_torch(u_p), to_torch(u_s)
    tdec, tjac = tcommon.manifold_decoder(u_p_t, u_s_t, tc, ref=ref)
    tfused = tcommon.manifold_decoder_fused(u_p_t, u_s_t, tc, ref=ref)
    for y in queries[:3]:
        w_want = np.asarray(jdec(jnp.asarray(y)))
        v_want = np.asarray(jjac(jnp.asarray(y)))
        fw, fv = jfused(jnp.asarray(y))
        w, v = tfused(to_torch(y))
        assert rel(tdec(to_torch(y)), w_want) <= 1e-12
        assert rel(tjac(to_torch(y)), v_want) <= 1e-12
        assert rel(tjac(to_torch(y), w), v_want) <= 1e-12
        assert rel(w, np.asarray(fw)) <= 1e-12
        assert rel(v, np.asarray(fv)) <= 1e-12
    if closure == "none":    # the linear decoder's Jacobian is the basis
        assert tjac(to_torch(queries[0])) is u_p_t
        assert tfused(to_torch(queries[0]))[1] is u_p_t


def test_fused_decoder_without_fused_closure(decoder_inputs):
    """A Closure without predict_and_jacobian: the fused decoder makes the
    separate calls."""
    u_p, u_s, _, jm, queries = decoder_inputs
    full = trbf.global_rbf_closure(convert.global_rbf_from_jax(
        jm, device="cpu"))
    bare = tcommon.Closure(predict=full.predict, jacobian=full.jacobian)
    a = tcommon.manifold_decoder_fused(to_torch(u_p), to_torch(u_s), full)
    b = tcommon.manifold_decoder_fused(to_torch(u_p), to_torch(u_s), bare)
    for (wa, va), (wb, vb) in zip(map(a, map(to_torch, queries)),
                                  map(b, map(to_torch, queries))):
        np.testing.assert_allclose(npy(wa), npy(wb), rtol=1e-14)
        np.testing.assert_allclose(npy(va), npy(vb), rtol=1e-14)


# ---------------------------------------------------------------- convert


def test_convert_carriers(data):
    q_p, q_s, _ = data
    jg = jrbf.fit_global_rbf(q_p, q_s, GLOBAL_EPS, kernel="matern")
    g = convert.global_rbf_from_jax(jg, device="cpu")
    assert isinstance(g, trbf.GlobalRBF)
    assert (g.epsilon, g.kernel) == (GLOBAL_EPS, "matern")
    for got, want in ((g.w_global, jg.w_global),
                      (g.q_p_train, jg.q_p_train),
                      (g.scaler.scale_, jg.scaler.scale_),
                      (g.scaler.min_, jg.scaler.min_)):
        assert got.device.type == "cpu" and got.dtype == torch.float64
        np.testing.assert_array_equal(npy(got), np.asarray(want))
    jk = jrbf.fit_knn_rbf(q_p, q_s, 0.7, 9, kernel="imq", ridge=1e-6)
    k = convert.knn_rbf_from_jax(jk, device="cpu")
    assert isinstance(k, trbf.KNNRBF)
    assert (k.epsilon, k.neighbors, k.kernel, k.ridge) == \
        (0.7, 9, "imq", 1e-6)
    np.testing.assert_array_equal(npy(k.q_p_train), np.asarray(jk.q_p_train))
    np.testing.assert_array_equal(npy(k.q_s_train), np.asarray(jk.q_s_train))
    np.testing.assert_array_equal(npy(k.scaler.min_),
                                  np.asarray(jk.scaler.min_))


def test_entry_points_need_a_card_or_cpu(data, monkeypatch):
    """Host arrays go to the card by default: without one, the fits, the
    scalers, the decoders and the carriers raise at once."""
    q_p, q_s, _ = data
    jg = jrbf.fit_global_rbf(q_p, q_s, GLOBAL_EPS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = (lambda: tcommon.fit_minmax(q_p),
             lambda: tcommon.identity_scaler(3),
             lambda: trbf.fit_global_rbf(q_p, q_s, 1.0),
             lambda: trbf.fit_knn_rbf(q_p, q_s, 1.0, 5),
             lambda: tcommon.manifold_decoder(q_p, q_s, None),
             lambda: convert.global_rbf_from_jax(jg))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
