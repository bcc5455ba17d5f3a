"""Minibatch Adam epochs over one flat parameter vector (PyTorch): the
machinery the network trainers share (rnm_train, ae_train).

The JAX package jits an epoch as one lax.scan of minibatch steps. Here
the parameters travel through the epoch as one flat vector, so Adam's
update (optax's form, optim.py) is a handful of elementwise kernels a
step whatever the layer count, and elementwise, so the same bits as a
per-layer update. A step is the loss of a minibatch at the flat
parameters, its autograd gradient and the Adam update. The minibatches
are the rows perm[:num_batches * batch_size] of the training tensors,
num_batches = n // batch_size (the rest dropped), as JAX's epochs take
them. On the CPU an epoch runs its steps eagerly (train_epoch); on the
card the trainers replay one step captured in a CUDA graph (EpochGraph).

A loss is loss_fn(leaves, *batch): the parameters as a list of tensors
in module.parameters()'s order, and one minibatch of each training
tensor.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from finitedifference_tpu_torch.optim import (
    B1,
    B2,
    AdamState,
    adam_init,
    adam_moments_update,
    adam_update,
)


def flat_params(module: nn.Module):
    """(flat parameter vector, shapes, sizes) of the module's parameters."""
    params = [p.detach() for p in module.parameters()]
    return (torch.cat([p.reshape(-1) for p in params]),
            [p.shape for p in params], [p.numel() for p in params])


def unflat(flat, shapes, sizes):
    return [t.view(s) for t, s in zip(flat.split(sizes), shapes)]


def adam_init_flat(module: nn.Module) -> AdamState:
    """optax.adam(lr).init of the module's parameters, as one flat
    vector (the layout the epochs update)."""
    return adam_init((flat_params(module)[0],))


def loss_and_grad(loss_fn: Callable, flat, shapes, sizes, batch):
    """The minibatch loss at the flat parameters and its gradient, flat."""
    leaves = [t.requires_grad_() for t in unflat(flat, shapes, sizes)]
    loss = loss_fn(leaves, *batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), torch.cat([g.reshape(-1) for g in grads])


def _write_back(module: nn.Module, flat, shapes, sizes) -> None:
    with torch.no_grad():
        for p, t in zip(module.parameters(), unflat(flat, shapes, sizes)):
            p.copy_(t)


def _minibatches(data: Sequence[torch.Tensor], perm, batch_size: int):
    """Each training tensor's rows perm[:num_batches * batch_size] as
    (num_batches, batch_size, ...)."""
    num_batches = data[0].shape[0] // batch_size
    perm = perm[: num_batches * batch_size]
    return [d[perm].reshape(num_batches, batch_size, *d.shape[1:])
            for d in data]


def train_epoch(loss_fn: Callable, module: nn.Module, opt_state: AdamState,
                data: Sequence[torch.Tensor], perm, batch_size: int,
                learning_rate: float):
    """One eager epoch: one Adam step at learning_rate on each minibatch.
    Updates the module's parameters in place; returns (opt_state, the
    mean of the batch losses taken before each update) with the loss a
    0-d tensor on the device."""
    batches = _minibatches(data, perm, batch_size)
    flat, shapes, sizes = flat_params(module)
    losses = []
    for batch in zip(*batches):
        loss, grad = loss_and_grad(loss_fn, flat, shapes, sizes, batch)
        (update,), opt_state = adam_update((grad,), opt_state,
                                           learning_rate)
        flat = flat + update
        losses.append(loss)
    _write_back(module, flat, shapes, sizes)
    return opt_state, torch.mean(torch.stack(losses))


class EpochGraph:
    """train_epoch on the card, each minibatch step replayed from one CUDA
    graph: the step of train_epoch (the same loss, gradient and optax
    update) on static buffers, its minibatch, bias corrections and
    learning rate read from device tensors at a device step index. A
    step's arithmetic is train_epoch's but for the bias corrections,
    divided by as tensors where the eager step divides by a Python float
    (which PyTorch's CUDA division turns into a multiplication by its
    reciprocal): the two differ by rounding.

    Made once a training run from the loss, the module, the Adam state
    and the training tensors' shapes; run(module, data, perm,
    learning_rate) is one epoch.
    """

    def __init__(self, loss_fn: Callable, module: nn.Module,
                 opt_state: AdamState, data: Sequence[torch.Tensor],
                 batch_size: int):
        dev = data[0].device
        self.loss_fn = loss_fn
        self.batch_size = batch_size
        self.num_batches = data[0].shape[0] // batch_size
        flat, self.shapes, self.sizes = flat_params(module)
        self.flat = flat.clone()
        self.mu = opt_state.mu[0].clone()
        self.nu = opt_state.nu[0].clone()
        self.count = opt_state.count
        nb, bs = self.num_batches, batch_size
        self.batches = [torch.zeros(nb, bs, *d.shape[1:], dtype=d.dtype,
                                    device=dev) for d in data]
        self.bc = torch.ones(2, nb, dtype=flat.dtype, device=dev)
        self.lr = torch.zeros((), dtype=flat.dtype, device=dev)
        # a loss in the promotion of the data's and the parameters' dtypes
        self.losses = torch.zeros(nb, device=dev, dtype=torch.promote_types(
            flat.dtype, data[0].dtype))
        self.i = torch.zeros(1, dtype=torch.long, device=dev)
        # warm up on a side stream (as torch.cuda.graph asks), then put
        # the state back before the capture
        saved = [t.clone() for t in (self.flat, self.mu, self.nu)]
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, v in zip((self.flat, self.mu, self.nu), saved):
            t.copy_(v)
        self.i.zero_()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._step()

    def _step(self):
        batch = [b.index_select(0, self.i)[0] for b in self.batches]
        bc = self.bc.index_select(1, self.i)
        loss, grad = loss_and_grad(self.loss_fn, self.flat, self.shapes,
                                   self.sizes, batch)
        (update,), (mu,), (nu,) = adam_moments_update(
            (grad,), (self.mu,), (self.nu,), bc[0, 0], bc[1, 0], self.lr)
        with torch.no_grad():
            self.mu.copy_(mu)
            self.nu.copy_(nu)
            self.flat.add_(update)
            self.losses.index_copy_(0, self.i, loss.reshape(1))
            self.i.add_(1)

    def run(self, module: nn.Module, data: Sequence[torch.Tensor], perm,
            learning_rate: float):
        """One epoch, as train_epoch(loss_fn, module, state, data, perm,
        batch_size, learning_rate): updates the module's parameters;
        returns (the Adam state, the mean batch loss, a 0-d tensor)."""
        nb = self.num_batches
        for buf, b in zip(self.batches,
                          _minibatches(data, perm, self.batch_size)):
            buf.copy_(b)
        counts = range(self.count + 1, self.count + nb + 1)
        self.bc.copy_(torch.tensor([[1 - B1 ** t for t in counts],
                                    [1 - B2 ** t for t in counts]],
                                   dtype=torch.float64))
        self.lr.fill_(learning_rate)
        self.i.zero_()
        for _ in range(nb):
            self.graph.replay()
        self.count += nb
        _write_back(module, self.flat, self.shapes, self.sizes)
        return (AdamState(self.count, (self.mu,), (self.nu,)),
                torch.mean(self.losses))
