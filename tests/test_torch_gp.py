"""The port's GP closure (finitedifference_tpu_torch.closures.gp) and its Adam
(finitedifference_tpu_torch.optim) against the JAX package's, on the CPU,
float64.

The same seeded NumPy inputs (60 pairs q_p (3) -> q_s (6), 6 held-out
queries) go to the JAX function and to its port:
- carried models (JAX fits through convert.gp_from_jax: GPModel
  isotropic and ARD at nu 1.5 and 2.5, PerModeGPModel at both, an SVGP
  GPModel): predict, Jacobian and the fused form to 1e-12 relative, each
  Jacobian against torch.func.jacfwd of the predict to 1e-10 (a forward
  derivative of the value, not the same expression), the precision
  bridge with a float32 y against the float64 closure to 1e-6;
- the objectives at fixed parameters: the LML (iso, ARD, both nu), the
  per-mode LML batched over modes, the collapsed SVGP bound and the
  anisotropic RBF's validation error, values and autograd gradients
  against jax.grad, 1e-12 relative;
- the Adam update against optax.adam on the same 300 gradients, eager
  and under jax.jit (the form the JAX fits run): 1e-15 relative per step
  in norm, not bit for bit, for two reasons outside the update's form:
  torch's vectorized float64 sqrt on the CPU is not correctly rounded
  (about 0.8% of inputs come out one ulp off numpy's), and XLA's CPU
  compiler contracts the jitted elementwise chain into fused
  multiply-adds;
- the fits: hyperparameters to 1e-10 and held-out predictions to 1e-10
  relative (measured: 1e-13 to 2e-13 after 30-60 Adam steps, the
  rounding of two autograd implementations amplified by the steps);
  alpha is not compared at fitted hyperparameters (cond(K) near 1e8 at
  noise 1e-6), nor eigh's eigenvectors (their signs are not fixed);
- the median of the per-mode noises as jnp.median (mean of the two
  middle values), where torch.median would take the lower;
- a Gram that is not positive definite gives NaN, as in JAX;
- the manifold ROM with a carried GP closure at 12^2, full and sampled
  mesh: reduced coordinates to 1e-10, Gauss-Newton counts equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finitedifference_tpu import rom as jrom
from finitedifference_tpu.closures import common as jcommon
from finitedifference_tpu.closures import gp as jgp
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import sampled as jsm
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch import optim
from finitedifference_tpu_torch import rom as trom
from finitedifference_tpu_torch.closures import common as tcommon
from finitedifference_tpu_torch.closures import gp as tgp
from finitedifference_tpu_torch.ops import sampled as tsm
from finitedifference_tpu_torch.training import rbf_train as trbf_train
from tests import oracle

to_torch = functools.partial(convert.to_torch, device="cpu")
SCALE = np.array([1.0, 0.5, 2.0])
FIT_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads only spin, and
    their load slows the tests that share the machine. One thread for the
    module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def rel(a, b):
    a, b = npy(a), npy(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def data():
    """60 pairs of a smooth map R^3 -> R^6 whose outputs span three orders
    of magnitude, and 6 queries inside the training box."""
    rng = np.random.default_rng(3)
    q_p = rng.uniform(-2, 3, size=(60, 3)) * SCALE
    q_s = np.stack([np.sin(q_p[:, 0]) + q_p[:, 1] ** 2,
                    np.cos(q_p[:, 2]) * q_p[:, 0],
                    np.tanh(q_p.sum(1)), q_p[:, 1] * q_p[:, 2],
                    0.01 * np.sin(3 * q_p[:, 1]),
                    1e-3 * np.cos(q_p[:, 0] - q_p[:, 2])], 1)
    queries = rng.uniform(-2, 3, size=(6, 3)) * SCALE
    return q_p, q_s, queries


# ------------------------------------------------------------ carried models

JAX_MODELS = {
    "iso": lambda q_p, q_s: jgp.fit_gp(q_p, q_s, num_steps=30),
    "iso_nu25": lambda q_p, q_s: jgp.fit_gp(q_p, q_s, num_steps=30, nu=2.5),
    "ard": lambda q_p, q_s: jgp.fit_gp(q_p, q_s, num_steps=30, ard=True,
                                       noise=1e-6),
    "ard_nu25": lambda q_p, q_s: jgp.fit_gp(q_p, q_s, num_steps=30,
                                            ard=True, nu=2.5),
    "per_mode": lambda q_p, q_s: jgp.fit_gp_full_per_mode(q_p, q_s,
                                                          num_steps=30),
    "per_mode_nu25": lambda q_p, q_s: jgp.fit_gp_full_per_mode(
        q_p, q_s, num_steps=30, nu=2.5),
    "svgp": lambda q_p, q_s: jgp.fit_gp_variational(
        q_p, q_s, num_inducing=20, num_steps=30),
}


@pytest.fixture(scope="module")
def jax_models(data):
    q_p, q_s, _ = data
    return {name: fit(q_p, q_s) for name, fit in JAX_MODELS.items()}


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_carried_closure_matches_jax(jax_models, data, name):
    jm = jax_models[name]
    tm = convert.gp_from_jax(jm, device="cpu")
    per_mode = name.startswith("per_mode")
    assert isinstance(tm, tgp.PerModeGPModel if per_mode else tgp.GPModel)
    assert tm.nu == jm.nu and tm.noise == jm.noise
    jc, tc = jgp.gp_closure(jm), tgp.gp_closure(tm)
    t_pred = tgp.per_mode_gp_predict if per_mode else tgp.gp_predict
    for y in data[2]:
        yj, yt = jnp.asarray(y), to_torch(y)
        p, j = tc.predict_and_jacobian(yt)
        assert rel(tc.predict(yt), jc.predict(yj)) <= 1e-12
        assert rel(tc.jacobian(yt), jc.jacobian(yj)) <= 1e-12
        jp, jj = jc.predict_and_jacobian(yj)
        assert rel(p, jp) <= 1e-12 and rel(j, jj) <= 1e-12
        ad = torch.func.jacfwd(lambda v: t_pred(tm, v))(yt)
        assert rel(j, ad) <= 1e-10


@pytest.mark.parametrize("name", ["ard", "per_mode"])
def test_precision_bridge(jax_models, data, name):
    """A float32 y: the core runs in the model's float64, the result comes
    back in float32."""
    tc = tgp.gp_closure(convert.gp_from_jax(jax_models[name], device="cpu"))
    for y in data[2][:3]:
        y64 = to_torch(y)
        p32, j32 = tc.predict_and_jacobian(y64.float())
        p64, j64 = tc.predict_and_jacobian(y64.float().double())
        assert p32.dtype == j32.dtype == torch.float32
        assert tc.predict(y64.float()).dtype == torch.float32
        assert rel(p32, p64) <= 1e-6 and rel(j32, j64) <= 1e-6


def test_matern32_matches_jax(data):
    q_p = data[0]
    for ls in (0.7, np.array([0.5, 1.5, 0.9])):
        for nu in (1.5, 2.5):
            want = jgp.matern32(jnp.asarray(q_p), jnp.asarray(q_p[:7]),
                                jnp.asarray(ls), 1.3, nu=nu)
            got = tgp.matern32(to_torch(q_p), to_torch(q_p[:7]),
                               to_torch(ls), 1.3, nu=nu)
            assert rel(got, want) <= 1e-14


# ---------------------------------------------------------------- objectives


def _scaled(q_p):
    return np.asarray(jcommon.fit_minmax(q_p).transform(jnp.asarray(q_p)))


@pytest.mark.parametrize("ard", [False, True], ids=["iso", "ard"])
@pytest.mark.parametrize("nu", [1.5, 2.5])
def test_lml_and_gradient_match_jax(data, ard, nu):
    x, y = _scaled(data[0]), data[1]
    params = np.array([0.3, -0.4, 0.2, 0.1])[:2 + 2 * ard]
    fj = lambda p: jgp._log_marginal_likelihood(p, jnp.asarray(x),
                                                jnp.asarray(y), 1e-6, nu=nu)
    pt = to_torch(params).requires_grad_()
    val = tgp._log_marginal_likelihood(pt, to_torch(x), to_torch(y), 1e-6,
                                       nu=nu)
    (grad,) = torch.autograd.grad(val, pt)
    assert rel(val.detach(), fj(jnp.asarray(params))) <= 1e-12
    assert rel(grad, jax.grad(fj)(jnp.asarray(params))) <= 1e-12


def test_per_mode_lml_batched_matches_jax(data):
    """The full per-mode fit's objective: every mode's LML at once from
    the squared differences, against JAX's LML mode by mode."""
    x, y = _scaled(data[0]), data[1]
    rng = np.random.default_rng(5)
    params = rng.normal(size=(y.shape[1], 4)) * 0.4
    xt = to_torch(x)
    diff2 = ((xt[:, None, :] - xt[None, :, :]) ** 2).movedim(-1, 0)
    pt = to_torch(params).requires_grad_()
    vals = tgp._gaussian_lml(tgp._per_mode_kernels(pt, diff2, 1e-6, 1.5),
                             to_torch(y.T[:, :, None]))
    (grad,) = torch.autograd.grad(vals.sum(), pt)
    for j in range(y.shape[1]):
        fj = lambda p: jgp._log_marginal_likelihood(
            p, jnp.asarray(x), jnp.asarray(y[:, j:j + 1]), 1e-6)
        assert rel(vals[j].detach(), fj(jnp.asarray(params[j]))) <= 1e-12
        assert rel(grad[j], jax.grad(fj)(jnp.asarray(params[j]))) <= 1e-12


def test_collapsed_elbo_and_gradient_match_jax(data):
    x, y = _scaled(data[0]), data[1]
    hyp = np.array([0.2, -0.3, 0.1, 0.4])
    z = x[::4] + 0.01
    fj = lambda h, zz: jgp._collapsed_elbo(h, zz, jnp.asarray(x),
                                           jnp.asarray(y), 1e-4)
    ht, zt = to_torch(hyp).requires_grad_(), to_torch(z).requires_grad_()
    val = tgp._collapsed_elbo(ht, zt, to_torch(x), to_torch(y), 1e-4)
    gh, gz = torch.autograd.grad(val, (ht, zt))
    wh, wz = jax.grad(fj, argnums=(0, 1))(jnp.asarray(hyp), jnp.asarray(z))
    assert rel(val.detach(), fj(jnp.asarray(hyp), jnp.asarray(z))) <= 1e-12
    assert rel(gh, wh) <= 1e-12 and rel(gz, wz) <= 1e-12


def _jax_aniso_val_err(log_scales, base, qp_tr, qs_tr, qp_va, qs_va):
    """The JAX package's val_err of fit_global_rbf_anisotropic (nested
    there), written out with its own operations, gaussian kernel."""
    from finitedifference_tpu.closures.rbf import _get_kernel

    phi_fn, _ = _get_kernel("gaussian")
    scales = jnp.exp(log_scales)
    sc = jcommon.MinMaxScaler(scale_=base.scale_ * scales,
                              min_=base.min_ * scales)
    qn_tr, qn_va = sc.transform(qp_tr), sc.transform(qp_va)

    def kmat(xa, xb):
        d2 = jnp.sum((xa[:, None, :] - xb[None, :, :]) ** 2, axis=-1)
        return phi_fn(jnp.sqrt(d2 + 1e-300), 1.0)

    phi = kmat(qn_tr, qn_tr) + 1e-8 * jnp.eye(qn_tr.shape[0])
    w = jnp.linalg.solve(phi, qs_tr)
    pred = kmat(qn_va, qn_tr) @ w
    return jnp.linalg.norm(pred - qs_va) / jnp.linalg.norm(qs_va)


def test_aniso_val_err_and_gradient_match_jax(data):
    q_p, q_s = data[0], data[1]
    tr, va = np.arange(45), np.arange(45, 60)
    jbase = jcommon.fit_minmax(q_p[tr])
    tbase = tcommon.fit_minmax(q_p[tr], device="cpu")
    logs = np.array([0.3, -0.2, 0.5])
    jparts = [jnp.asarray(a) for a in (q_p[tr], q_s[tr], q_p[va], q_s[va])]
    tparts = [to_torch(a) for a in (q_p[tr], q_s[tr], q_p[va], q_s[va])]
    fj = lambda p: _jax_aniso_val_err(p, jbase, *jparts)
    pt = to_torch(logs).requires_grad_()
    val = trbf_train._aniso_val_err(pt, tbase, *tparts, "gaussian")
    (grad,) = torch.autograd.grad(val, pt)
    assert rel(val.detach(), fj(jnp.asarray(logs))) <= 1e-12
    assert rel(grad, jax.grad(fj)(jnp.asarray(logs))) <= 1e-12


# --------------------------------------------------------------------- Adam


def _gradient_sequence(seed):
    """300 gradients of 7 parameters over nine orders of magnitude."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(300, 7)) * np.logspace(-6, 3, 7) \
        + rng.normal(size=7)


@pytest.mark.parametrize("seed", [0, 1])
def test_adam_matches_optax(seed):
    g = _gradient_sequence(seed)
    opt = optax.adam(0.05)
    p_j = jnp.zeros(7)
    s_j = opt.init(p_j)
    p_t = (torch.zeros(7, dtype=torch.float64),)
    s_t = optim.adam_init(p_t)
    eager, optax_eager = [], []
    for gi in g:
        u, s_j = opt.update(jnp.asarray(gi), s_j, p_j)
        p_j = optax.apply_updates(p_j, u)
        (u_t,), s_t = optim.adam_update((to_torch(gi),), s_t, 0.05)
        p_t = (p_t[0] + u_t,)
        eager.append(p_t[0].numpy())
        optax_eager.append(np.asarray(p_j))
    assert s_t.count == 300

    @jax.jit
    def scanned(gs):
        def step(carry, gi):
            p, s = carry
            u, s = opt.update(gi, s, p)
            p = optax.apply_updates(p, u)
            return (p, s), p
        p0 = jnp.zeros(7)
        return jax.lax.scan(step, (p0, opt.init(p0)), gs)[1]

    eager = np.array(eager)
    for want in (np.array(optax_eager), np.asarray(scanned(jnp.asarray(g)))):
        per_step = np.linalg.norm(eager - want, axis=1) \
            / np.linalg.norm(want, axis=1)
        assert per_step.max() <= 1e-15


def test_adam_minimize_runs_the_same_steps():
    """adam_minimize on a loss whose gradient is the fed sequence: the same
    parameters as the update loop."""
    g = to_torch(_gradient_sequence(2)[:40])
    seen = []

    def loss(p):
        i = len(seen)
        seen.append(i)
        return torch.sum(p * g[i])

    (p,) = optim.adam_minimize(loss, (torch.zeros(7, dtype=torch.float64),),
                               40, 0.05)
    want = (torch.zeros(7, dtype=torch.float64),)
    state = optim.adam_init(want)
    for gi in g:
        (u,), state = optim.adam_update((gi,), state, 0.05)
        want = (want[0] + u,)
    assert torch.equal(p, want[0]) and not p.requires_grad


# --------------------------------------------------------------------- fits


def _held_out(predict, model, queries):
    return np.stack([npy(predict(model, q)) for q in queries])


FITS = {
    "iso": (jgp.fit_gp, tgp.fit_gp, dict(num_steps=40)),
    "ard": (jgp.fit_gp, tgp.fit_gp, dict(num_steps=40, ard=True,
                                         noise=1e-6)),
    "nu25": (jgp.fit_gp, tgp.fit_gp, dict(num_steps=40, ard=True, nu=2.5)),
    "no_opt": (jgp.fit_gp, tgp.fit_gp, dict(optimize=False)),
    "scales": (jgp.fit_gp_per_mode, tgp.fit_gp_per_mode,
               dict(num_steps=40)),
    "variational": (jgp.fit_gp_variational, tgp.fit_gp_variational,
                    dict(num_steps=40, num_inducing=24)),
}


@pytest.mark.parametrize("name", list(FITS))
def test_fit_matches_jax(data, name):
    q_p, q_s, queries = data
    jfit, tfit, kw = FITS[name]
    jm = jfit(q_p, q_s, **kw)
    tm = tfit(q_p, q_s, device="cpu", **kw)
    assert isinstance(tm, tgp.GPModel) and tm.alpha.device.type == "cpu"
    assert tm.nu == jm.nu
    assert rel(tm.amplitude, jm.amplitude) <= FIT_TOL
    assert rel(tm.length_scale, jm.length_scale) <= FIT_TOL
    assert abs(tm.noise - jm.noise) <= FIT_TOL * jm.noise
    assert rel(tm.x_train, jm.x_train) <= FIT_TOL   # Z for the SVGP
    want = _held_out(jgp.gp_predict, jm, jnp.asarray(queries))
    got = _held_out(tgp.gp_predict, tm, to_torch(queries))
    assert rel(got, want) <= FIT_TOL


def test_full_per_mode_fit_matches_jax_for_any_chunk(data):
    q_p, q_s, queries = data
    jm = jgp.fit_gp_full_per_mode(q_p, q_s, num_steps=40)
    models = [tgp.fit_gp_full_per_mode(q_p, q_s, num_steps=40,
                                       mode_chunk=c, device="cpu")
              for c in (1, 4)]
    for field in ("alpha", "length_scale", "amplitude"):
        assert torch.equal(getattr(models[0], field),
                           getattr(models[1], field))
    tm = models[1]
    assert isinstance(tm, tgp.PerModeGPModel)
    assert tm.length_scale.shape == (6, 3) and tm.amplitude.shape == (6,)
    assert rel(tm.amplitude, jm.amplitude) <= FIT_TOL
    assert rel(tm.length_scale, jm.length_scale) <= FIT_TOL
    want = _held_out(jgp.per_mode_gp_predict, jm, jnp.asarray(queries))
    got = _held_out(tgp.per_mode_gp_predict, tm, to_torch(queries))
    assert rel(got, want) <= FIT_TOL


def test_mode_scales_optimizer_matches_jax(data):
    """_optimize_mode_scales on the same eigenvalues, projected outputs
    and starts: every mode's (log a, log n) as JAX's vmapped Adam."""
    x, y = _scaled(data[0]), data[1]
    k = np.asarray(jgp.matern32(jnp.asarray(x), jnp.asarray(x), 0.8))
    lam, q = np.linalg.eigh(k)
    lam = np.maximum(lam, 0.0)
    yt = q.T @ y
    p0 = np.tile([0.1, np.log(1e-6)], (y.shape[1], 1))
    want = jgp._optimize_mode_scales(jnp.asarray(lam), jnp.asarray(yt),
                                     jnp.asarray(p0), num_steps=60)
    got = tgp._optimize_mode_scales(to_torch(lam), to_torch(yt),
                                    to_torch(p0), num_steps=60)
    assert rel(got, want) <= 1e-12


def test_noise_median_is_jax_median():
    """An even count: the mean of the two middle values, as jnp.median;
    torch.median would return the lower."""
    v = np.array([3e-7, 1e-6, 5e-8, 2e-5, 4e-6, 9e-7])
    assert float(tgp._median(to_torch(v))) == float(jnp.median(v))
    assert float(torch.median(to_torch(v))) != float(jnp.median(v))
    assert float(tgp._median(to_torch(v[:5]))) == float(jnp.median(v[:5]))


def test_per_mode_scales_noise_is_the_median(data):
    """fit_gp_per_mode's noise over an even mode count (6) equals JAX's;
    the two middle per-mode noises differ, so the lower one would not."""
    q_p, q_s, _ = data
    jm = jgp.fit_gp_per_mode(q_p, q_s, num_steps=40)
    tm = tgp.fit_gp_per_mode(q_p, q_s, num_steps=40, device="cpu")
    assert abs(tm.noise - jm.noise) <= FIT_TOL * jm.noise


def test_not_positive_definite_gives_nan(data):
    """Repeated inputs and a negative noise: the Gram is not positive
    definite, and the factor is NaN in both packages, with no exception."""
    q_p, q_s, _ = data
    q_p = np.concatenate([q_p[:10], q_p[:10]])
    q_s = np.concatenate([q_s[:10], q_s[:10]])
    jm = jgp.fit_gp(q_p, q_s, optimize=False, noise=-1e-3)
    tm = tgp.fit_gp(q_p, q_s, optimize=False, noise=-1e-3, device="cpu")
    assert np.isnan(np.asarray(jm.alpha)).all()
    assert torch.isnan(tm.alpha).all()
    per_mode = tgp.fit_gp_full_per_mode(q_p, q_s, noise=-1e-3, num_steps=2,
                                        device="cpu")
    assert torch.isnan(per_mode.alpha).all()


# ------------------------------------------------------------ manifold ROM

N, DT, STEPS, N_P, N_S = 12, 0.05, 10, 3, 5


@pytest.fixture(scope="module")
def rom_problem():
    """12^2 oracle trajectories at two training points, their 8-mode POD
    split 3 + 5 and a JAX ARD GP closure on the projected pairs."""
    jgrid = JGrid2D(nx=N, ny=N, x_up=100.0, y_up=100.0)
    ops, xc = oracle.make_problem(nx=N, ny=N)
    w0 = np.ones(jgrid.state_dim)
    snaps = np.hstack([oracle.implicit_trajectory(w0, mu, DT, 20, ops, xc)
                       for mu in ([4.25, 0.0225], [5.5, 0.015])])
    u = np.linalg.svd(snaps, full_matrices=False)[0][:, :N_P + N_S]
    q = u.T @ snaps
    jm = jgp.fit_gp(q[:N_P].T, q[N_P:].T, num_steps=30, ard=True,
                    noise=1e-6)
    return jgrid, w0, u[:, :N_P], u[:, N_P:], jm


@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampled"])
def test_manifold_rom_with_gp_closure_matches_jax(rom_problem, sampled):
    jgrid, w0, u_p, u_s, jm = rom_problem
    tgrid = convert.grid_from_jax(jgrid)
    jc = jgp.gp_closure(jm)
    tc = tgp.gp_closure(convert.gp_from_jax(jm, device="cpu"))
    jkw, tkw = {}, {}
    y0 = u_p.T @ w0
    if sampled:
        inds = np.arange(0, jgrid.n_cells, 3)
        weights = np.random.default_rng(2).uniform(0.5, 2.0, inds.size)
        jmesh = jsm.build_sampled_mesh(jgrid, inds)
        idx = np.asarray(jsm.augmented_state_indices(jmesh, jgrid.n_cells))
        u_p, u_s = u_p[idx], u_s[idx]
        jkw = dict(mesh=jmesh, sample_weights=jnp.asarray(weights))
        tkw = dict(mesh=tsm.build_sampled_mesh(tgrid, inds, device="cpu"),
                   sample_weights=to_torch(weights))
    jdec, jjac = jcommon.manifold_decoder(u_p, u_s, jc)
    up_t, us_t = to_torch(u_p), to_torch(u_s)
    tdec, tjac = tcommon.manifold_decoder(up_t, us_t, tc)
    jres = jrom.manifold_rom(
        jgrid, jnp.asarray(y0), jdec, jjac, DT, STEPS, 4.75, 0.02,
        decode_and_jac=jcommon.manifold_decoder_fused(u_p, u_s, jc), **jkw)
    tres = trom.manifold_rom(
        tgrid, to_torch(y0), tdec, tjac, DT, STEPS, 4.75, 0.02,
        decode_and_jac=tcommon.manifold_decoder_fused(up_t, us_t, tc), **tkw)
    assert tres.red_coords.shape == (N_P, STEPS + 1)
    assert rel(tres.red_coords, jres.red_coords) <= 1e-10
    assert tres.total_gn_its == int(jres.total_gn_its) > STEPS
