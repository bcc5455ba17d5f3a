"""Shared closure plumbing (PyTorch): scaler, closure protocol, manifold
decoder.

Counterpart of finitedifference_tpu/closures/common.py. The host-CPU
helper `run_on_host_cpu` is not ported: the fits run on the device the
caller gives (the H100 has FP64, where a TPU emulates it).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from finitedifference_tpu_torch.device import as_tensor, resolve_device
from finitedifference_tpu_torch.precision import hi_matmul


class MinMaxScaler(NamedTuple):
    """sklearn-compatible MinMaxScaler state (reference pipelines fit
    MinMaxScaler(feature_range=(-1, 1)) on q_p).
    transform(x) = x * scale_ + min_."""
    scale_: torch.Tensor   # (dim,)
    min_: torch.Tensor     # (dim,)

    def transform(self, x):
        return x * self.scale_ + self.min_

    def inverse_transform(self, x):
        return (x - self.min_) / self.scale_


def identity_scaler(dim: int, device=None) -> MinMaxScaler:
    """No-op float64 scaler (the reference's `_no_norm` RBF variants), on
    `device` (default: the card)."""
    ones = torch.ones(dim, dtype=torch.float64,
                      device=resolve_device(device))
    return MinMaxScaler(scale_=ones, min_=torch.zeros_like(ones))


def fit_minmax(data, feature_range=(-1.0, 1.0),
               device=None) -> MinMaxScaler:
    """Fit a MinMaxScaler on rows of `data` (n_samples, dim), on data's
    device when it is a tensor, else on `device` (default: the card). A
    feature with zero span counts as span 1, as in sklearn."""
    data = as_tensor(data, device=device)
    dmin = data.min(dim=0).values
    dmax = data.max(dim=0).values
    span = dmax - dmin
    span = torch.where(span == 0, torch.ones_like(span), span)
    fmin, fmax = feature_range
    scale = (fmax - fmin) / span
    minv = fmin - dmin * scale
    return MinMaxScaler(scale_=scale, min_=minv)


def _cho_factor(a):
    """Lower Cholesky factor of a (or of each matrix of a batch); NaN where
    a matrix is not positive definite (the JAX factorization's result
    there), with no host sync and no exception."""
    low, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(low, float("nan")), low)


class Closure(NamedTuple):
    """q_p -> q_s map with an explicit Jacobian.

    predict:  (n_p,) -> (n_s,)
    jacobian: (n_p,) -> (n_s, n_p)
    predict_and_jacobian: optional fused (n_p,) -> ((n_s,), (n_s, n_p)),
        sharing the per-query work (neighbour search, local kernel solve,
        distances) between the value and the Jacobian. When None, callers
        make the separate calls.
    """
    predict: Callable
    jacobian: Callable
    predict_and_jacobian: Optional[Callable] = None


def _blocks(basis, basis2, ref):
    basis = as_tensor(basis)
    basis2 = as_tensor(basis2, device=basis.device) \
        if basis2 is not None else None
    ref = as_tensor(ref, device=basis.device) if ref is not None else None
    return basis, basis2, ref


def manifold_decoder(basis, basis2, closure: Optional[Closure], ref=None):
    """(decode, dec_jac) for w(y) = ref + U_p y + U_s closure(y).

    With closure=None this is the linear decoder. `ref` is an optional
    reference-state offset. The blocks go to the card unless they are
    tensors already (device.as_tensor).
    """
    basis, basis2, ref = _blocks(basis, basis2, ref)

    def decode(y):
        w = hi_matmul(basis, y)
        if closure is not None:
            w = w + hi_matmul(basis2, closure.predict(y))
        if ref is not None:
            w = w + ref
        return w

    def dec_jac(y, w=None):
        if closure is None:
            return basis
        return basis + hi_matmul(basis2, closure.jacobian(y))

    return decode, dec_jac


def manifold_decoder_fused(basis, basis2, closure: Optional[Closure],
                           ref=None):
    """Fused `decode_and_jac(y) -> (w, V)` companion to manifold_decoder:
    one closure evaluation (closure.predict_and_jacobian where the closure
    has it) for both."""
    basis, basis2, ref = _blocks(basis, basis2, ref)

    def decode_and_jac(y):
        if closure is None:
            w = hi_matmul(basis, y)
            if ref is not None:
                w = w + ref
            return w, basis
        if closure.predict_and_jacobian is not None:
            q_s, j_s = closure.predict_and_jacobian(y)
        else:
            q_s, j_s = closure.predict(y), closure.jacobian(y)
        w = hi_matmul(basis, y) + hi_matmul(basis2, q_s)
        if ref is not None:
            w = w + ref
        v = basis + hi_matmul(basis2, j_s)
        return w, v

    return decode_and_jac
