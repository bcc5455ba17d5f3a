"""optax.adam's update, written out in PyTorch.

The JAX package fits its GP hyperparameters, the sparse GP's inducing
points and the anisotropic RBF's scales with optax.adam(learning_rate)
from zeros. torch.optim.Adam rounds differently (it folds the bias
corrections into the step size), so the port writes optax's form:

    mu <- (1 - b1) g + b1 mu
    nu <- (1 - b2) g^2 + b2 nu
    t  <- t + 1
    p  <- p + (-lr) * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

with b1 0.9, b2 0.999, eps 1e-8 added after the square root (eps_root
0), the operations in optax's order (b^t as a Python float equals XLA's
power). Fed the same gradients, it agrees with optax to about an ulp a
step: torch's vectorized float64 sqrt on the CPU is not correctly
rounded, and under jax.jit XLA's CPU compiler contracts the chain into
fused multiply-adds.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    count: int
    mu: tuple
    nu: tuple


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    """optax.adam's init: zero moments, count 0."""
    return AdamState(0, tuple(torch.zeros_like(p) for p in params),
                     tuple(torch.zeros_like(p) for p in params))


def adam_moments_update(grads: Sequence[torch.Tensor], mu, nu, bc1, bc2,
                        learning_rate):
    """(updates, mu, nu): optax.adam's update from the moments mu, nu and
    the bias corrections bc1 = 1 - b1^t, bc2 = 1 - b2^t of the new count
    t. bc1, bc2 and learning_rate are floats, or 0-d tensors on the
    parameters' device (a CUDA graph's inputs)."""
    mu = tuple((1 - B1) * g + B1 * m for g, m in zip(grads, mu))
    nu = tuple((1 - B2) * (g * g) + B2 * v for g, v in zip(grads, nu))
    updates = tuple(-learning_rate * ((m / bc1) / (torch.sqrt(v / bc2) + EPS))
                    for m, v in zip(mu, nu))
    return updates, mu, nu


def adam_update(grads: Sequence[torch.Tensor], state: AdamState,
                learning_rate: float):
    """(updates, new state) for `grads`, as optax.adam(learning_rate)
    .update; add the updates to the parameters (optax.apply_updates)."""
    count = state.count + 1
    updates, mu, nu = adam_moments_update(grads, state.mu, state.nu,
                                          1 - B1 ** count, 1 - B2 ** count,
                                          learning_rate)
    return updates, AdamState(count, mu, nu)


def adam_minimize(loss: Callable, params: Sequence[torch.Tensor],
                  num_steps: int, learning_rate: float,
                  callback: Callable | None = None) -> tuple:
    """Run num_steps Adam steps on loss(*params) from `params`; gradients
    by torch.autograd. callback(i, value, new_params), if given, sees each
    step's loss value (at the parameters before the step). Returns the
    parameters as a tuple of tensors without grad.

    A loss that is a sum of independent terms, one per row of a batch of
    parameters, minimizes each row as its own Adam run would: the update
    is elementwise (the JAX package's vmap over modes)."""
    params = tuple(p.detach() for p in params)
    state = adam_init(params)
    for i in range(num_steps):
        live = tuple(p.requires_grad_() for p in (q.clone() for q in params))
        value = loss(*live)
        grads = torch.autograd.grad(value, live)
        updates, state = adam_update(grads, state, learning_rate)
        params = tuple(p.detach() + u for p, u in zip(live, updates))
        if callback is not None:
            callback(i, value.detach(), params)
    return params
