"""RBF interpolation closures (PyTorch): global (precomputed weights) and
k-nearest-neighbour (a local solve per query).

Counterpart of finitedifference_tpu/closures/rbf.py. Each kernel is
phi(r, eps) together with phi'(r)/r, and the interpolants and Jacobians
are generic over the kernel. The kNN variant picks the neighbours with
torch.topk on the float32 squared distances (the JAX package's
lax.top_k), then solves the k x k local system.

Kernels: gaussian exp(-(er)^2), imq 1/sqrt(1+(er)^2), multiquadric
sqrt(1+(er)^2), linear r, matern (Matern-3/2) (1+s)exp(-s) with
s = sqrt(3) e r.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from finitedifference_tpu_torch.closures.common import (
    Closure,
    MinMaxScaler,
    _cho_factor,
    fit_minmax,
)
from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.precision import hi_matmul
from finitedifference_tpu_torch.solvers import lstsq_qr


# --------------------------------------------------------------------------
# kernels: phi(r) and phi'(r)/r (the latter avoids the r=0 singularity in
# the chain rule d phi/d x = phi'(r)/r * (x - x_i))
# --------------------------------------------------------------------------

def _gaussian(r, eps):
    return torch.exp(-((eps * r) ** 2))


def _gaussian_dr_over_r(r, eps):
    return -2.0 * eps**2 * _gaussian(r, eps)


def _imq(r, eps):
    return 1.0 / torch.sqrt(1.0 + (eps * r) ** 2)


def _imq_dr_over_r(r, eps):
    return -(eps**2) * (1.0 + (eps * r) ** 2) ** -1.5


def _mq(r, eps):
    return torch.sqrt(1.0 + (eps * r) ** 2)


def _mq_dr_over_r(r, eps):
    return eps**2 / torch.sqrt(1.0 + (eps * r) ** 2)


def _linear(r, eps):
    return r


def _linear_dr_over_r(r, eps):
    # phi' = 1, so phi'/r is singular at r=0: guarded as in the JAX package
    return 1.0 / torch.clamp(r, min=1e-12)


def _matern32(r, eps):
    s = math.sqrt(3.0) * eps * r
    return (1.0 + s) * torch.exp(-s)


def _matern32_dr_over_r(r, eps):
    s = math.sqrt(3.0) * eps * r
    return -3.0 * eps**2 * torch.exp(-s)


KERNELS = {
    "gaussian": (_gaussian, _gaussian_dr_over_r),
    "imq": (_imq, _imq_dr_over_r),
    "multiquadric": (_mq, _mq_dr_over_r),
    "linear": (_linear, _linear_dr_over_r),
    "matern": (_matern32, _matern32_dr_over_r),
}


def _get_kernel(kernel: str):
    try:
        return KERNELS[kernel]
    except KeyError:
        raise ValueError(
            f"unknown RBF kernel {kernel!r}; valid: {sorted(KERNELS)}"
        ) from None


def _norm_rows(x):
    """Euclidean norm over the last axis."""
    return torch.linalg.vector_norm(x, dim=-1)


def kernel_matrix(xa, xb, eps, kernel: str = "gaussian"):
    """phi(||xa_i - xb_j||) for row sets xa (m,d), xb (n,d) -> (m,n)."""
    phi, _ = _get_kernel(kernel)
    d = _norm_rows(xa[:, None, :] - xb[None, :, :])
    return phi(d, eps)


# --------------------------------------------------------------------------
# global RBF interpolation (precomputed weights W: (n_train, n_s))
# --------------------------------------------------------------------------

class GlobalRBF(NamedTuple):
    """Trained global RBF model (the content of the reference's
    pod_rbf_global_model/global_weights.pkl)."""
    w_global: torch.Tensor      # (n_train, n_s)
    q_p_train: torch.Tensor     # (n_train, n_p), already normalized
    epsilon: float
    kernel: str
    scaler: MinMaxScaler


def rbf_global_predict(model: GlobalRBF, y):
    """q_s(y) = phi(||scaler(y) - Q||) @ W."""
    phi, _ = _get_kernel(model.kernel)
    x = model.scaler.transform(y)
    r = _norm_rows(model.q_p_train - x[None, :])
    return hi_matmul(phi(r, model.epsilon), model.w_global)


def rbf_global_jacobian(model: GlobalRBF, y):
    """Analytic d q_s / d y: W^T @ [phi'(r)/r * (x - Q)] * scaler.scale_."""
    _, dr_over_r = _get_kernel(model.kernel)
    x = model.scaler.transform(y)
    diff = x[None, :] - model.q_p_train          # (n_train, n_p)
    r = _norm_rows(diff)
    dphi = dr_over_r(r, model.epsilon)[:, None] * diff
    jac_norm = hi_matmul(model.w_global.T, dphi)  # (n_s, n_p)
    return jac_norm * model.scaler.scale_[None, :]


def rbf_global_predict_and_jacobian(model: GlobalRBF, y):
    """Fused value + Jacobian sharing the distance evaluation."""
    phi, dr_over_r = _get_kernel(model.kernel)
    x = model.scaler.transform(y)
    diff = x[None, :] - model.q_p_train
    r = _norm_rows(diff)
    pred = hi_matmul(phi(r, model.epsilon), model.w_global)
    dphi = dr_over_r(r, model.epsilon)[:, None] * diff
    jac = hi_matmul(model.w_global.T, dphi) * model.scaler.scale_[None, :]
    return pred, jac


def global_rbf_closure(model: GlobalRBF) -> Closure:
    """Closure with a precision bridge: the kernel-weight contraction runs
    in the MODEL's dtype whatever the solver's, and the result is cast
    back. phi(r) @ W cancels by ~5e5, so an f32 online state must not
    drag the closure core down to f32."""
    cd = model.w_global.dtype

    def predict(y):
        return rbf_global_predict(model, y.to(cd)).to(y.dtype)

    def jacobian(y):
        return rbf_global_jacobian(model, y.to(cd)).to(y.dtype)

    def both(y):
        p, j = rbf_global_predict_and_jacobian(model, y.to(cd))
        return p.to(y.dtype), j.to(y.dtype)

    return Closure(predict=predict, jacobian=jacobian,
                   predict_and_jacobian=both)


def svd_solve(phi, rhs, sval_tol: float = 1e-8):
    """phi^+ rhs through the SVD, singular values below sval_tol * s_max
    dropped (the reference trainer's solve); phi may carry leading batch
    axes, solved in one batched SVD."""
    u, s, vh = torch.linalg.svd(phi, full_matrices=False)
    s_inv = torch.where(s > sval_tol * s[..., :1], 1.0 / s,
                        torch.zeros_like(s))
    return (vh.mT * s_inv[..., None, :]) @ (u.mT @ rhs)


def fit_global_rbf(q_p_train, q_s_train, epsilon, kernel: str = "gaussian",
                   scaler: MinMaxScaler | None = None,
                   lambda_reg: float = 1e-8,
                   sval_tol: float = 1e-8, device=None) -> GlobalRBF:
    """Solve Phi(Q, Q) W = q_s for the global weights, on q_p_train's
    device when it is a tensor, else on `device` (default: the card).

    SVD-regularized: singular values below sval_tol * s_max are dropped;
    a small Tikhonov term conditions the kernel matrix.
    """
    _get_kernel(kernel)   # validate early
    q_p_train = as_tensor(q_p_train, device=device)
    q_s_train = as_tensor(q_s_train, device=q_p_train.device)
    if scaler is None:
        scaler = fit_minmax(q_p_train)
    qn = scaler.transform(q_p_train)
    phi = kernel_matrix(qn, qn, epsilon, kernel)
    phi = phi + lambda_reg * torch.eye(phi.shape[0], dtype=phi.dtype,
                                       device=phi.device)
    w = svd_solve(phi, q_s_train, sval_tol)
    return GlobalRBF(w_global=w, q_p_train=qn, epsilon=float(epsilon),
                     kernel=kernel, scaler=scaler)


# --------------------------------------------------------------------------
# k-nearest-neighbour RBF (a local solve per query)
# --------------------------------------------------------------------------

class KNNRBF(NamedTuple):
    q_p_train: torch.Tensor     # (n_train, n_p), normalized
    q_s_train: torch.Tensor     # (n_train, n_s)
    epsilon: float
    neighbors: int
    kernel: str
    scaler: MinMaxScaler
    # Tikhonov ridge on the local interpolation system. 1e-8 keeps the
    # reference's unregularized solve to round-off; larger values are a
    # real hyperparameter (train_knn_rbf_search sweeps it).
    ridge: float = 1e-8


def _knn_gather(model: KNNRBF, x):
    """Coordinates of the k nearest training points to x.

    Distances and top-k run in float32 whatever the model dtype (as in
    the JAX package: the sets differ only on exact distance ties); the
    gathered coordinates keep the model dtype."""
    d2 = torch.sum((model.q_p_train.to(torch.float32)
                    - x[None, :].to(torch.float32)) ** 2, dim=1)
    _, idx = torch.topk(-d2, model.neighbors)
    return model.q_p_train[idx], model.q_s_train[idx]


# strictly positive-definite kernels (any point set): Cholesky-safe.
# multiquadric/linear are only conditionally PD and keep the QR solve.
_PD_KERNELS = frozenset({"gaussian", "imq", "matern"})


def _knn_local_weights(model: KNNRBF, xk, yk):
    """Solve the local interpolation system Phi_k W = q_s_k.

    PD kernels solve by Cholesky, the others by QR. In float64 with a
    ridge >= 1e-6 the factorization is float32 and three float64
    residual-correction passes recover float64 accuracy (the JAX
    package's branch: the ridge keeps cond(phi) within float32's range,
    and the branch decides which rounding the solve carries)."""
    phi = kernel_matrix(xk, xk, model.epsilon, model.kernel)
    phi = phi + model.ridge * torch.eye(phi.shape[0], dtype=phi.dtype,
                                        device=phi.device)
    if model.kernel in _PD_KERNELS:
        if phi.dtype == torch.float64 and model.ridge >= 1e-6:
            f32 = torch.float32
            cf = _cho_factor(phi.to(f32))
            w = torch.cholesky_solve(yk.to(f32), cf).to(phi.dtype)
            for _ in range(3):
                r = yk - hi_matmul(phi, w)
                w = w + torch.cholesky_solve(r.to(f32), cf).to(phi.dtype)
            return w
        return torch.cholesky_solve(yk, _cho_factor(phi))
    return lstsq_qr(phi, yk)


def rbf_knn_predict(model: KNNRBF, y):
    """kNN-RBF interpolation: query -> k nearest -> local Phi solve ->
    psi @ W_local."""
    x = model.scaler.transform(y)
    xk, yk = _knn_gather(model, x)
    w_loc = _knn_local_weights(model, xk, yk)
    phi, _ = _get_kernel(model.kernel)
    r = _norm_rows(xk - x[None, :])
    return hi_matmul(phi(r, model.epsilon), w_loc)


def rbf_knn_jacobian(model: KNNRBF, y):
    """Analytic Jacobian holding the neighbour set fixed."""
    _, dr_over_r = _get_kernel(model.kernel)
    x = model.scaler.transform(y)
    xk, yk = _knn_gather(model, x)
    w_loc = _knn_local_weights(model, xk, yk)
    diff = x[None, :] - xk
    r = _norm_rows(diff)
    dpsi = dr_over_r(r, model.epsilon)[:, None] * diff   # (k, n_p)
    jac_norm = hi_matmul(w_loc.T, dpsi)                  # (n_s, n_p)
    return jac_norm * model.scaler.scale_[None, :]


def rbf_knn_predict_and_jacobian(model: KNNRBF, y):
    """Fused value + Jacobian sharing ONE neighbour search and ONE local
    kernel solve."""
    phi, dr_over_r = _get_kernel(model.kernel)
    x = model.scaler.transform(y)
    xk, yk = _knn_gather(model, x)
    w_loc = _knn_local_weights(model, xk, yk)
    diff = x[None, :] - xk
    r = _norm_rows(diff)
    pred = hi_matmul(phi(r, model.epsilon), w_loc)
    dpsi = dr_over_r(r, model.epsilon)[:, None] * diff
    jac = hi_matmul(w_loc.T, dpsi) * model.scaler.scale_[None, :]
    return pred, jac


def knn_rbf_closure(model: KNNRBF) -> Closure:
    """Precision bridge as in global_rbf_closure: the local kernel solve
    and contraction run in the model's dtype."""
    cd = model.q_p_train.dtype

    def predict(y):
        return rbf_knn_predict(model, y.to(cd)).to(y.dtype)

    def jacobian(y):
        return rbf_knn_jacobian(model, y.to(cd)).to(y.dtype)

    def both(y):
        p, j = rbf_knn_predict_and_jacobian(model, y.to(cd))
        return p.to(y.dtype), j.to(y.dtype)

    return Closure(predict=predict, jacobian=jacobian,
                   predict_and_jacobian=both)


def fit_knn_rbf(q_p_train, q_s_train, epsilon, neighbors: int,
                kernel: str = "gaussian",
                scaler: MinMaxScaler | None = None,
                ridge: float = 1e-8, device=None) -> KNNRBF:
    """The kNN model: the scaled training set, on q_p_train's device when
    it is a tensor, else on `device` (default: the card)."""
    _get_kernel(kernel)   # validate early
    q_p_train = as_tensor(q_p_train, device=device)
    if scaler is None:
        scaler = fit_minmax(q_p_train)
    return KNNRBF(
        q_p_train=scaler.transform(q_p_train),
        q_s_train=as_tensor(q_s_train, device=q_p_train.device),
        epsilon=float(epsilon), neighbors=int(neighbors),
        kernel=kernel, scaler=scaler, ridge=float(ridge),
    )

