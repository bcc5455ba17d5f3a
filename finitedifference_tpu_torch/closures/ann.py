"""POD-ANN (RNM) closure (PyTorch): a small ELU MLP mapping q_p -> q_s.

Counterpart of finitedifference_tpu/closures/ann.py (the reference's
RNM_NN, models.py:9-42: q1 -> 32 -> 64 -> 128 -> 256 -> 256 -> q2 with
ELU). The decoder Jacobian is torch.func.jacfwd of the network, as the
JAX package takes jax.jacfwd. Matmuls run in full f32 (precision.py
keeps TF32 off), the counterpart of the JAX layers' Precision.HIGHEST.

The parameters start from Flax's default initialisation, not PyTorch's:
lecun_normal kernels (a standard normal truncated to [-2, 2], times
sqrt(1 / fan_in) / 0.87962566103423978) and zero biases. The draws come
from a torch.Generator, so their bits differ from Flax's while their
distribution is the same; convert.rnm_from_flax carries a Flax network's
parameters across exactly.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from finitedifference_tpu_torch.closures.common import Closure
from finitedifference_tpu_torch.device import resolve_device

HIDDEN = (32, 64, 128, 256, 256)
# the standard deviation of a standard normal truncated to [-2, 2]
# (Flax's variance_scaling divides by it)
TRUNC_STD = 0.87962566103423978


def rnm_apply(params: Sequence[torch.Tensor], x):
    """The MLP on x (..., q1) with params (W0, b0, W1, b1, ...) in
    nn.Linear's layout: ELU (alpha 1) after every layer but the last."""
    n = len(params) // 2
    for i in range(n):
        x = F.linear(x, params[2 * i], params[2 * i + 1])
        if i < n - 1:
            x = F.elu(x)
    return x


class RNM_NN(nn.Module):
    """ELU MLP with the reference architecture (models.py:13-27).

    The parameters are drawn as Flax's RNM_NN.init draws them (module
    docstring) from `generator`, on the CPU, then moved to `device`
    (default: the card); generator None is a generator seeded with 0,
    the counterpart of JAX's default key 0.
    """

    def __init__(self, q1_size: int, q2_size: int,
                 hidden: Sequence[int] = HIDDEN, *, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        sizes = (q1_size, *hidden, q2_size)
        # skip_init: no draw from PyTorch's default initialisation
        self.layers = nn.ModuleList(
            nn.utils.skip_init(nn.Linear, a, b, dtype=dtype)
            for a, b in zip(sizes[:-1], sizes[1:]))
        self.hidden = tuple(hidden)
        self.reset_parameters(generator)
        self.to(resolve_device(device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Flax's default init: lecun_normal kernels, zero biases."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for layer in self.layers:
            std = math.sqrt(1.0 / layer.in_features) / TRUNC_STD
            w = torch.empty(layer.weight.shape, dtype=layer.weight.dtype)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            layer.weight.copy_(w)
            layer.bias.zero_()

    def forward(self, x):
        return rnm_apply(tuple(self.parameters()), x)


def init_rnm(q1_size: int, q2_size: int,
             generator: torch.Generator | None = None,
             dtype=torch.float32, device=None) -> RNM_NN:
    """A new RNM_NN with Flax's default initialisation drawn from
    `generator` (seeded with 0 when None), its parameters in `dtype` on
    `device` (default: the card). Flax keeps float32 parameters whatever
    the input's dtype; the port gives them `dtype`."""
    return RNM_NN(q1_size, q2_size, dtype=dtype, device=device,
                  generator=generator)


def _frozen(module: RNM_NN):
    """The module's parameters without grad, and their dtype."""
    params = tuple(p.detach() for p in module.parameters())
    return params, params[0].dtype


def rnm_closure(module: RNM_NN) -> Closure:
    """Closure from a trained RNM network.

    The net runs in its own parameter dtype (float32 by default, as the
    reference's torch nets) whatever the solver's dtype: inputs are cast
    down, outputs cast back up. The Jacobian (n_s, n_p) is
    torch.func.jacfwd of predict; both work under torch.func.vmap.
    """
    params, net_dtype = _frozen(module)

    def predict(y):
        return rnm_apply(params, y.to(net_dtype)).to(y.dtype)

    return Closure(predict=predict, jacobian=torch.func.jacfwd(predict))


def rnm_closure_with_mu(module: RNM_NN, mu) -> Closure:
    """RNM closure whose network input is [q_p; mu1; mu2] with mu fixed at
    ROM time (the `_mu_included` trainer variant, paired with
    project_snapshots(mu_labels=...)). The Jacobian is with respect to
    q_p only: (n_s, n_p)."""
    params, net_dtype = _frozen(module)
    mu_vec = torch.as_tensor(mu, dtype=net_dtype, device=params[0].device)

    def predict(y):
        z = torch.cat([y.to(net_dtype), mu_vec])
        return rnm_apply(params, z).to(y.dtype)

    return Closure(predict=predict, jacobian=torch.func.jacfwd(predict))
