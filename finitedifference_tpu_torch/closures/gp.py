"""Gaussian-process closure (PyTorch): Matérn GP regression q_p -> q_s.

Counterpart of finitedifference_tpu/closures/gp.py (the reference's
sklearn GaussianProcessRegressor with ConstantKernel x Matern(nu=1.5) on
MinMax-scaled inputs, its custom predict k_vec @ alpha_ and its
hand-derived Matérn gradient). The fits maximize the exact log marginal
likelihood with Adam in optax's form (optim.py) on (log amplitude, log
length scales) from zeros, gradients by torch.autograd; predict and
Jacobian are closed-form expressions.

Four fits, as in the JAX package:
- fit_gp: one kernel and one (amplitude, noise) for every output;
- fit_gp_per_mode: shared ARD length scales, an exact (amplitude, noise)
  per output in the unit kernel's eigenbasis, folded into a GPModel;
- fit_gp_full_per_mode: one ARD GP per output (PerModeGPModel), the
  modes' Adam runs batched, mode_chunk at a time;
- fit_gp_variational: the collapsed sparse variational bound (Titsias),
  with learned inducing points; the result is a GPModel on them.

A Cholesky factor of a matrix that is not positive definite is NaN, as
JAX's is (closures.common._cho_factor); nothing swaps in another solver.
Each fit runs on q_p_train's device when it is a tensor, else on
`device` (default: the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from finitedifference_tpu_torch.closures.common import (
    Closure,
    MinMaxScaler,
    _cho_factor,
    fit_minmax,
)
from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.optim import adam_minimize
from finitedifference_tpu_torch.precision import hi_matmul

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)
LOG_2PI = math.log(2.0 * math.pi)


def _matern_of_r2(r2, amplitude, nu: float):
    """Matérn-3/2 (nu 1.5) or -5/2 (nu 2.5) of the squared scaled distance,
    through the safe norm sqrt(max(r2, 1e-36)): the floor keeps the ARD
    hyper-gradient finite on the diagonal, where d||v||/dv is NaN."""
    r = torch.sqrt(torch.clamp(r2, min=1e-36))
    if nu == 2.5:
        s = SQRT5 * r
        return amplitude * (1.0 + s + s * s / 3.0) * torch.exp(-s)
    s = SQRT3 * r
    return amplitude * (1.0 + s) * torch.exp(-s)


def matern32(xa, xb, length_scale, amplitude=1.0, nu: float = 1.5):
    """k(xa, xb) = amp (1 + sqrt(3) r) exp(-sqrt(3) r) with
    r = ||(xa - xb) / l|| (nu 1.5, the reference's kernel), or the
    Matérn-5/2 amp (1 + s + s^2/3) exp(-s), s = sqrt(5) r (nu 2.5).
    length_scale is a scalar or an (n_p,) ARD vector, inside the norm."""
    scaled = (xa[:, None, :] - xb[None, :, :]) / length_scale
    return _matern_of_r2(torch.sum(scaled * scaled, dim=-1), amplitude, nu)


class GPModel(NamedTuple):
    x_train: torch.Tensor       # (N, n_p) scaled inputs
    alpha: torch.Tensor         # (N, n_s) = K^{-1} Y
    length_scale: torch.Tensor  # scalar or (n_p,) ARD scales
    amplitude: torch.Tensor     # scalar
    noise: float
    scaler: MinMaxScaler
    nu: float = 1.5             # Matérn smoothness (1.5 or 2.5)


def _gaussian_lml(k, y):
    """log N(y | 0, k), summed over the columns of y (N, n_out); k may
    carry leading batch axes, and y then too."""
    chol = _cho_factor(k)
    alpha = torch.cholesky_solve(y, chol)
    n, n_out = y.shape[-2:]
    quad = torch.sum(y * alpha, dim=(-2, -1))
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * quad - 0.5 * n_out * logdet - 0.5 * n * n_out * LOG_2PI


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _log_marginal_likelihood(params, x, y, noise, nu: float = 1.5):
    """Exact multi-output log marginal likelihood at params = (log amp,
    log ls...)."""
    log_amp, log_ls = params[0], params[1:]
    k = matern32(x, x, torch.exp(log_ls), torch.exp(log_amp), nu=nu)
    k = k + noise * _eye(x.shape[0], x)
    return _gaussian_lml(k, y)


def _optimize_hypers(x, y, noise, num_steps: int = 200,
                     learning_rate: float = 0.05, ard: bool = False,
                     nu: float = 1.5):
    """Adam from zeros (log amp = log ls = 0) on the negative LML."""
    n_ls = x.shape[1] if ard else 1
    params0 = torch.zeros(1 + n_ls, dtype=x.dtype, device=x.device)
    (params,) = adam_minimize(
        lambda p: -_log_marginal_likelihood(p, x, y, noise, nu=nu),
        (params0,), num_steps, learning_rate)
    return params


def _optimize_mode_scales(eigvals, ytilde, params0, num_steps: int = 200,
                          learning_rate: float = 0.05):
    """Per-output (log amplitude, log noise) LML maximization in the
    eigenbasis of the shared unit-amplitude kernel, K = Q diag(lam) Q^T,
    ytilde = Q^T y: mode j's kernel a_j K + n_j I shares the
    eigenvectors, so its LML is O(N):

        L_j = -1/2 sum_i yt_i^2/(a lam_i + n) - 1/2 sum_i log(a lam_i + n)

    params0 (n_s, 2); every mode's Adam run at once (the sum of the
    modes' losses: each row's gradient is its own)."""
    yt = ytilde.T                                        # (n_s, N)

    def loss(p):
        d = torch.exp(p[:, :1]) * eigvals[None, :] + torch.exp(p[:, 1:2]) \
            + 1e-12
        lml = -0.5 * torch.sum(yt * yt / d, dim=1) \
            - 0.5 * torch.sum(torch.log(d), dim=1)
        return -torch.sum(lml)

    (params,) = adam_minimize(loss, (params0,), num_steps, learning_rate)
    return params


def _median(v):
    """jnp.median of a 1-D tensor: the mean of the two middle values for an
    even count (torch.median returns the lower one)."""
    s = torch.sort(v).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _scaled_inputs(q_p_train, q_s_train, scaler, device):
    q_p_train = as_tensor(q_p_train, device=device)
    y = as_tensor(q_s_train, device=q_p_train.device)
    if scaler is None:
        scaler = fit_minmax(q_p_train)
    return scaler.transform(q_p_train), y, scaler


def fit_gp_per_mode(q_p_train, q_s_train,
                    scaler: MinMaxScaler | None = None,
                    noise: float = 1e-6, optimize: bool = True,
                    num_steps: int = 200, ard: bool = True,
                    nu: float = 1.5, device=None) -> GPModel:
    """Per-mode amplitude/noise GP with shared ARD length scales: the
    shared fit's length scales, the unit kernel's eigendecomposition
    (eigenvalues clipped at 0), then every output's exact (a_j, n_j); a_j
    is folded into alpha, so the result is an ordinary GPModel with
    amplitude 1 and noise the median of the n_j."""
    x, y, scaler = _scaled_inputs(q_p_train, q_s_train, scaler, device)
    if optimize:
        shared = _optimize_hypers(x, y, noise, num_steps=num_steps,
                                  ard=ard, nu=nu)
    else:
        shared = torch.zeros(1 + (x.shape[1] if ard else 1), dtype=x.dtype,
                             device=x.device)
    amp0, ls = torch.exp(shared[0]), torch.exp(shared[1:])
    if not ard:
        ls = ls[0]

    k_unit = matern32(x, x, ls, 1.0, nu=nu)
    eigvals, q = torch.linalg.eigh(k_unit)
    eigvals = torch.clamp(eigvals, min=0.0)
    ytilde = hi_matmul(q.T, y)                           # (N, n_s)

    start = torch.stack([torch.log(amp0),
                         torch.log(torch.as_tensor(noise, dtype=x.dtype,
                                                   device=x.device))])
    params0 = start.repeat(y.shape[1], 1)
    params = _optimize_mode_scales(eigvals, ytilde, params0,
                                   num_steps=num_steps)
    amps = torch.exp(params[:, 0])                       # (n_s,)
    noises = torch.exp(params[:, 1])                     # (n_s,)

    # alpha_j = Q (a_j lam + n_j)^{-1} ytilde_j; predict uses the unit
    # kernel vector, so fold a_j in: pred_j = a_j k_u^T alpha_j
    denom = amps[None, :] * eigvals[:, None] + noises[None, :] + 1e-12
    alpha = hi_matmul(q, ytilde / denom) * amps[None, :]
    return GPModel(x_train=x, alpha=alpha, length_scale=ls,
                   amplitude=torch.ones((), dtype=x.dtype, device=x.device),
                   noise=float(_median(noises)), scaler=scaler,
                   nu=float(nu))


def fit_gp(q_p_train, q_s_train, scaler: MinMaxScaler | None = None,
           noise: float = 1e-8, optimize: bool = True,
           num_steps: int = 200, ard: bool = False,
           nu: float = 1.5, device=None) -> GPModel:
    """Multi-output Matérn GP with one kernel for every output (sklearn's
    multi-output GPR); ard=True learns a length scale per input
    dimension. optimize=False keeps amplitude = length scale = 1."""
    x, y, scaler = _scaled_inputs(q_p_train, q_s_train, scaler, device)
    if optimize:
        params = _optimize_hypers(x, y, noise, num_steps=num_steps,
                                  ard=ard, nu=nu)
        amp = torch.exp(params[0])
        ls = torch.exp(params[1:]) if ard else torch.exp(params[1])
    else:
        amp = torch.ones((), dtype=x.dtype, device=x.device)
        ls = torch.ones((), dtype=x.dtype, device=x.device)

    k = matern32(x, x, ls, amp, nu=nu) + noise * _eye(x.shape[0], x)
    alpha = torch.cholesky_solve(y, _cho_factor(k))
    return GPModel(x_train=x, alpha=alpha, length_scale=ls, amplitude=amp,
                   noise=noise, scaler=scaler, nu=float(nu))


def gp_predict(model: GPModel, y):
    """q_s(y) = k(X_train, x)^T @ alpha."""
    x = model.scaler.transform(y)
    k_vec = matern32(model.x_train, x[None, :], model.length_scale,
                     model.amplitude, nu=model.nu)[:, 0]
    return hi_matmul(k_vec, model.alpha)


def _dk(model: GPModel, y):
    """(scaled query x, its differences to X_train, the scaled distances
    s, exp(-s)); the Jacobians use ||diff / l|| with no floor."""
    x = model.scaler.transform(y)
    diff = x[None, :] - model.x_train                    # (N, n_p)
    r = torch.linalg.vector_norm(diff / model.length_scale, dim=1)
    s = (SQRT5 if model.nu == 2.5 else SQRT3) * r
    return diff, s, torch.exp(-s)


def gp_jacobian(model: GPModel, y):
    """Analytic d q_s / d y: the Matérn-3/2 gradient
    dk/dx = -3 amp / l^2 exp(-s) (x - X_i) (Matérn-5/2:
    -(5/3) amp / l^2 (1 + s) exp(-s) (x - X_i)), chained through the
    MinMax scaling."""
    diff, s, es = _dk(model, y)
    if model.nu == 2.5:
        dk = (-(5.0 / 3.0) * model.amplitude / model.length_scale**2) \
            * ((1.0 + s) * es)[:, None] * diff
    else:
        dk = (-3.0 * model.amplitude / model.length_scale**2) \
            * es[:, None] * diff                         # ls broadcasts
    jac_scaled = hi_matmul(model.alpha.T, dk)            # (n_s, n_p)
    return jac_scaled * model.scaler.scale_[None, :]


def gp_predict_and_jacobian(model: GPModel, y):
    """Fused value + Jacobian sharing the differences and distances to
    the training set."""
    diff, s, es = _dk(model, y)
    if model.nu == 2.5:
        pred = hi_matmul(
            model.amplitude * (1.0 + s + s * s / 3.0) * es, model.alpha)
        dk = (-(5.0 / 3.0) * model.amplitude / model.length_scale**2) \
            * ((1.0 + s) * es)[:, None] * diff
    else:
        pred = hi_matmul(model.amplitude * (1.0 + s) * es, model.alpha)
        dk = (-3.0 * model.amplitude / model.length_scale**2) \
            * es[:, None] * diff
    jac = hi_matmul(model.alpha.T, dk) * model.scaler.scale_[None, :]
    return pred, jac


class PerModeGPModel(NamedTuple):
    """Independent per-output GPs (the reference's one sklearn GPR per
    secondary mode), stored batched so the closure is one contraction."""
    x_train: torch.Tensor       # (N, n_p) scaled inputs
    alpha: torch.Tensor         # (N, n_s), column j = K_j^{-1} y_j
    length_scale: torch.Tensor  # (n_s, n_p) per-mode ARD scales
    amplitude: torch.Tensor     # (n_s,)
    noise: float
    scaler: MinMaxScaler
    nu: float = 1.5


def _svgp_terms(hyp, z, x, y, noise, nu: float):
    """Shared algebra of the collapsed SVGP bound (Titsias 2009):
    A = L_z^{-1} K_zn / sigma, B = I + A A^T, c = L_B^{-1} A y / sigma.
    Returns (A, L_z, L_B, c)."""
    amp = torch.exp(hyp[0])
    ls = torch.exp(hyp[1:])
    m = z.shape[0]
    jitter = 1e-10 + 1e-8 * amp
    kzz = matern32(z, z, ls, amp, nu=nu) + jitter * _eye(m, z)
    kzn = matern32(z, x, ls, amp, nu=nu)
    lz = _cho_factor(kzz)
    sigma = math.sqrt(noise)
    a = torch.linalg.solve_triangular(lz, kzn, upper=False) / sigma
    b = _eye(m, z) + a @ a.T
    lb = _cho_factor(b)
    c = torch.linalg.solve_triangular(lb, a @ y, upper=False) / sigma
    return a, lz, lb, c


def _collapsed_elbo(hyp, z, x, y, noise, nu: float = 1.5):
    """Titsias's collapsed variational bound for Gaussian-likelihood
    sparse GP regression (multi-output, shared kernel):

        L = log N(Y | 0, Q_nn + sigma^2 I)
            - n_out/(2 sigma^2) tr(K_nn - Q_nn),
        Q_nn = K_nz K_zz^{-1} K_zn,

    the exact optimum over q(u) of the reference's stochastic SVGP ELBO
    (POD-GP/compute_gp_models_pytorch.py:259-321)."""
    amp = torch.exp(hyp[0])
    a, _, lb, c = _svgp_terms(hyp, z, x, y, noise, nu)
    n, n_out = y.shape
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(lb)))
    quad = torch.sum(y * y) / noise - torch.sum(c * c)
    trace = amp * n - noise * torch.sum(a * a)
    return -0.5 * n_out * (n * math.log(2.0 * math.pi * noise) + logdet) \
        - 0.5 * quad - 0.5 * n_out * trace / noise


def _optimize_svgp(x, y, z0, noise, num_steps: int = 300,
                   learning_rate: float = 0.05, nu: float = 1.5):
    """(log amp, log ARD scales) and the inducing locations, jointly, by
    Adam on the negative collapsed bound."""
    hyp0 = torch.zeros(1 + x.shape[1], dtype=x.dtype, device=x.device)
    return adam_minimize(
        lambda hyp, z: -_collapsed_elbo(hyp, z, x, y, noise, nu=nu),
        (hyp0, z0), num_steps, learning_rate)


def fit_gp_variational(q_p_train, q_s_train,
                       scaler: MinMaxScaler | None = None,
                       noise: float = 1e-6, num_inducing: int = 64,
                       num_steps: int = 300, nu: float = 1.5,
                       learning_rate: float = 0.05, device=None) -> GPModel:
    """Sparse variational GP regression (the reference's GPyTorch SVGP
    option) through the collapsed bound: ARD kernel, inducing points
    learned jointly from a spread seed (np.random.default_rng(0), as in
    the JAX package). The predictive mean is k(x, Z) W, so the result is
    a plain GPModel with Z as x_train and W as alpha."""
    x, y, scaler = _scaled_inputs(q_p_train, q_s_train, scaler, device)
    n = x.shape[0]
    m = min(num_inducing, n)
    idx = np.random.default_rng(0).permutation(n)[:m]
    z0 = x[torch.as_tensor(np.sort(idx), device=x.device)]

    hyp, z = _optimize_svgp(x, y, z0, noise, num_steps=num_steps,
                            learning_rate=learning_rate, nu=nu)
    _, lz, lb, c = _svgp_terms(hyp, z, x, y, noise, nu)
    # W = L_z^{-T} L_B^{-T} c (GPflow's SGPR predictive-mean algebra)
    w = torch.linalg.solve_triangular(
        lz.T, torch.linalg.solve_triangular(lb.T, c, upper=True),
        upper=True)
    return GPModel(x_train=z, alpha=w, length_scale=torch.exp(hyp[1:]),
                   amplitude=torch.exp(hyp[0]), noise=noise,
                   scaler=scaler, nu=float(nu))


def _per_mode_kernels(params, diff2, noise, nu: float):
    """One ARD Matérn kernel matrix per row of params = (log amp, log
    ls...) (B, 1 + n_p), from the squared differences diff2 (n_p, N, N):
    r^2 = sum_p diff2_p / l_p^2, summed term by term in a fixed order (a
    matrix product would round differently for another B), without the
    (B, N, N, n_p) scaled differences of matern32. (B, N, N) with noise
    on the diagonal."""
    inv_ls2 = 1.0 / torch.exp(params[:, 1:]) ** 2        # (B, n_p)
    r2 = diff2[0] * inv_ls2[:, :1, None]
    for p in range(1, diff2.shape[0]):
        r2 = r2 + diff2[p] * inv_ls2[:, p:p + 1, None]   # (B, N, N)
    k = _matern_of_r2(r2, torch.exp(params[:, 0])[:, None, None], nu)
    return k + noise * _eye(diff2.shape[1], diff2)


def fit_gp_full_per_mode(q_p_train, q_s_train,
                         scaler: MinMaxScaler | None = None,
                         noise: float = 1e-6, num_steps: int = 150,
                         nu: float = 1.5, mode_chunk: int = 70,
                         device=None) -> PerModeGPModel:
    """One ARD GP per output mode (the reference's per-mode family,
    POD-GP/compute_gp_models.py): each mode's Adam from zeros on its own
    exact LML, mode_chunk modes at a time as one batched program
    (batched Cholesky factorizations and solves). The modes' runs are
    independent, so the result does not depend on mode_chunk (bit for bit
    on the CPU; on the card to rounding, as cuBLAS and cuSOLVER pick
    their batched routines by the batch's size); it bounds
    the memory (about a dozen (mode_chunk, N, N) buffers under autograd:
    8 GiB at 70 modes of 1,128 pairs, where 140 modes take 15 GiB for a
    few percent less time on an H100)."""
    x, y, scaler = _scaled_inputs(q_p_train, q_s_train, scaler, device)
    n, n_s = y.shape
    diff2 = ((x[:, None, :] - x[None, :, :]) ** 2).movedim(-1, 0)
    diff2 = diff2.contiguous()                           # (n_p, N, N)
    alphas, lss, amps = [], [], []
    for j0 in range(0, n_s, mode_chunk):
        yc = y.T[j0:j0 + mode_chunk, :, None]            # (B, N, 1)
        params0 = torch.zeros(yc.shape[0], 1 + x.shape[1], dtype=x.dtype,
                              device=x.device)
        (params,) = adam_minimize(
            lambda p: -torch.sum(_gaussian_lml(
                _per_mode_kernels(p, diff2, noise, nu), yc)),
            (params0,), num_steps, 0.05)
        k = _per_mode_kernels(params, diff2, noise, nu)
        alphas.append(torch.cholesky_solve(yc, _cho_factor(k))[:, :, 0])
        lss.append(torch.exp(params[:, 1:]))
        amps.append(torch.exp(params[:, 0]))
    return PerModeGPModel(
        x_train=x, alpha=torch.cat(alphas).T,
        length_scale=torch.cat(lss), amplitude=torch.cat(amps),
        noise=noise, scaler=scaler, nu=float(nu))


def _per_mode_kernel_terms(model: PerModeGPModel, x):
    """Shared geometry of the batched per-mode closure: the input
    differences diff (N, n_p), 1/l^2 (n_s, n_p) and the per-mode scaled
    distances s (N, n_s)."""
    diff = x[None, :] - model.x_train                    # (N, n_p)
    inv_ls2 = 1.0 / (model.length_scale ** 2)            # (n_s, n_p)
    r2 = hi_matmul(diff * diff, inv_ls2.T)               # (N, n_s)
    r = torch.sqrt(torch.clamp(r2, min=1e-36))
    s = (SQRT5 if model.nu == 2.5 else SQRT3) * r
    return diff, inv_ls2, s


def per_mode_gp_predict(model: PerModeGPModel, y):
    """pred_j = a_j sum_i k_j(x, X_i) alpha_ij, all modes at once."""
    x = model.scaler.transform(y)
    _, _, s = _per_mode_kernel_terms(model, x)
    poly = (1.0 + s + s * s / 3.0) if model.nu == 2.5 else (1.0 + s)
    k = poly * torch.exp(-s)                             # (N, n_s)
    return model.amplitude * torch.sum(k * model.alpha, dim=0)


def per_mode_gp_predict_and_jacobian(model: PerModeGPModel, y):
    """Fused batched value + Jacobian: dk_j/dx = -3 a_j e^{-s} (x - X_i)
    / l_j^2 (Matérn-3/2) or -(5/3) a_j (1+s) e^{-s} (x - X_i) / l_j^2
    (5/2), contracted over the training axis in one product."""
    x = model.scaler.transform(y)
    diff, inv_ls2, s = _per_mode_kernel_terms(model, x)
    es = torch.exp(-s)                                   # (N, n_s)
    if model.nu == 2.5:
        pred = model.amplitude * torch.sum(
            (1.0 + s + s * s / 3.0) * es * model.alpha, dim=0)
        w = -(5.0 / 3.0) * (1.0 + s) * es * model.alpha  # (N, n_s)
    else:
        pred = model.amplitude * torch.sum((1.0 + s) * es * model.alpha,
                                           dim=0)
        w = -3.0 * es * model.alpha
    # jac[j, p] = a_j inv_ls2[j, p] sum_i w_ij diff_ip
    jac = torch.einsum("ij,ip->jp", w, diff) * inv_ls2
    jac = model.amplitude[:, None] * jac
    return pred, jac * model.scaler.scale_[None, :]


def per_mode_gp_jacobian(model: PerModeGPModel, y):
    return per_mode_gp_predict_and_jacobian(model, y)[1]


def gp_closure(model) -> Closure:
    """Closure with the precision bridge of rbf.global_rbf_closure: the
    k-vector @ alpha contraction cancels heavily, so it runs in the
    model's dtype whatever the solver's, and the result is cast back.
    Dispatches on the model type: GPModel or PerModeGPModel."""
    cd = model.alpha.dtype
    per_mode = isinstance(model, PerModeGPModel)
    f_pred = per_mode_gp_predict if per_mode else gp_predict
    f_jac = per_mode_gp_jacobian if per_mode else gp_jacobian
    f_both = per_mode_gp_predict_and_jacobian if per_mode \
        else gp_predict_and_jacobian

    def predict(y):
        return f_pred(model, y.to(cd)).to(y.dtype)

    def jacobian(y):
        return f_jac(model, y.to(cd)).to(y.dtype)

    def both(y):
        p, j = f_both(model, y.to(cd))
        return p.to(y.dtype), j.to(y.dtype)

    return Closure(predict=predict, jacobian=jacobian,
                   predict_and_jacobian=both)
