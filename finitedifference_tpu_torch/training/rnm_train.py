"""POD-ANN (RNM) closure training (PyTorch).

Counterpart of finitedifference_tpu/training/rnm_train.py (the
reference's train_reduced_manifold_autoencoder.py:86-219): project
snapshots onto a POD basis, split the coefficients into primary
q_p = q[:n_p] and secondary q_s = q[n_p:n_p+n_s] (project_snapshots, on
the host, shared by every closure), and regress q_p -> q_s with the
RNM_NN MLP: MSE, Adam in optax's form (optim.py), a plateau learning-rate
schedule stepped once an epoch, patience early stop, best checkpointing.

The JAX package jits an epoch as one lax.scan; here an epoch is a loop
of minibatch steps on the device, one host read an epoch (the losses).
The parameters travel through the epoch as one flat vector, so Adam's
update is a handful of elementwise kernels a step whatever the layer
count (elementwise, so the same bits as a per-layer update). On the CPU
each step runs eagerly (_train_epoch); on the card train_rnm replays one
step captured in a CUDA graph (_EpochGraph): the eager step is ~120
small launches, 1.40-1.56 ms on an H100 machine's host, the replay
0.19 ms (kernel_check_gpu.py rnm).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from finitedifference_tpu_torch.closures.ann import (
    RNM_NN,
    init_rnm,
    rnm_apply,
)
from finitedifference_tpu_torch.device import as_tensor, resolve_device
from finitedifference_tpu_torch.optim import (
    B1,
    B2,
    AdamState,
    adam_init,
    adam_moments_update,
    adam_update,
)
from finitedifference_tpu_torch.training.monitor import TrainingMonitor


def project_snapshots(basis, snaps_t, num_primary: int,
                      num_secondary: Optional[int] = None,
                      mu_labels=None):
    """q = basis^T snaps -> (q_p, q_s) training pairs.

    snaps_t: (n_samples, 2n) row-major samples. Optionally append the
    (mu1, mu2) labels to q_p (the `_mu_included` trainer variant).
    """
    q = np.asarray(snaps_t) @ np.asarray(basis)   # (S, k)
    n_p = num_primary
    n_s = num_secondary if num_secondary is not None else q.shape[1] - n_p
    q_p = q[:, :n_p]
    q_s = q[:, n_p:n_p + n_s]
    if mu_labels is not None:
        q_p = np.hstack([q_p, np.asarray(mu_labels)])
    return q_p, q_s


def _flat(module: RNM_NN):
    """(flat parameter vector, shapes, sizes) of the module's parameters."""
    params = [p.detach() for p in module.parameters()]
    return (torch.cat([p.reshape(-1) for p in params]),
            [p.shape for p in params], [p.numel() for p in params])


def _unflat(flat, shapes, sizes):
    return [t.view(s) for t, s in zip(flat.split(sizes), shapes)]


def adam_init_module(module: RNM_NN) -> AdamState:
    """optax.adam(lr).init of the module's parameters, as one flat
    vector (the layout _train_epoch updates)."""
    return adam_init((_flat(module)[0],))


def _train_epoch(module: RNM_NN, opt_state: AdamState, q_p, q_s, perm,
                 batch_size: int, learning_rate: float):
    """One epoch: the rows perm[:num_batches * batch_size] in minibatches
    of batch_size (the rest dropped), one Adam step each at
    learning_rate on the MSE over batch and outputs. Updates the module's
    parameters in place; returns (opt_state, the mean of the batch losses
    taken before each update) with the loss a 0-d tensor on the device.
    """
    n = q_p.shape[0]
    num_batches = n // batch_size
    perm = perm[: num_batches * batch_size]
    xb = q_p[perm].reshape(num_batches, batch_size, -1)
    yb = q_s[perm].reshape(num_batches, batch_size, -1)
    flat, shapes, sizes = _flat(module)
    losses = []
    for x, y in zip(xb, yb):
        loss, grad = _loss_and_grad(flat, shapes, sizes, x, y)
        (update,), opt_state = adam_update((grad,), opt_state,
                                           learning_rate)
        flat = flat + update
        losses.append(loss)
    with torch.no_grad():
        for p, t in zip(module.parameters(), _unflat(flat, shapes, sizes)):
            p.copy_(t)
    return opt_state, torch.mean(torch.stack(losses))


def _loss_and_grad(flat, shapes, sizes, x, y):
    """The minibatch MSE at the flat parameters and its gradient, flat."""
    leaves = [t.requires_grad_() for t in _unflat(flat, shapes, sizes)]
    loss = torch.mean((rnm_apply(leaves, x) - y) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), torch.cat([g.reshape(-1) for g in grads])


class _EpochGraph:
    """_train_epoch on the card, each minibatch step replayed from one CUDA
    graph: the step of _train_epoch (the same loss, gradient and optax
    update) on static buffers, its minibatch, bias corrections and
    learning rate read from device tensors at a device step index. A
    step's arithmetic is _train_epoch's but for the bias corrections,
    divided by as tensors where the eager step divides by a Python float
    (which PyTorch's CUDA division turns into a multiplication by its
    reciprocal): the two differ by rounding.

    Made once a training run from the module, the Adam state and the
    training pairs' shapes; run(module, q_p, q_s, perm, learning_rate)
    is one epoch.
    """

    def __init__(self, module: RNM_NN, opt_state: AdamState, q_p, q_s,
                 batch_size: int):
        dev = q_p.device
        self.batch_size = batch_size
        self.num_batches = q_p.shape[0] // batch_size
        flat, self.shapes, self.sizes = _flat(module)
        self.flat = flat.clone()
        self.mu = opt_state.mu[0].clone()
        self.nu = opt_state.nu[0].clone()
        self.count = opt_state.count
        nb, bs = self.num_batches, batch_size
        self.xb = torch.zeros(nb, bs, q_p.shape[1], dtype=q_p.dtype,
                              device=dev)
        self.yb = torch.zeros(nb, bs, q_s.shape[1], dtype=q_s.dtype,
                              device=dev)
        self.bc = torch.ones(2, nb, dtype=flat.dtype, device=dev)
        self.lr = torch.zeros((), dtype=flat.dtype, device=dev)
        self.losses = torch.zeros(nb, dtype=flat.dtype, device=dev)
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
        x = self.xb.index_select(0, self.i)[0]
        y = self.yb.index_select(0, self.i)[0]
        bc = self.bc.index_select(1, self.i)
        loss, grad = _loss_and_grad(self.flat, self.shapes, self.sizes, x, y)
        (update,), (mu,), (nu,) = adam_moments_update(
            (grad,), (self.mu,), (self.nu,), bc[0, 0], bc[1, 0], self.lr)
        with torch.no_grad():
            self.mu.copy_(mu)
            self.nu.copy_(nu)
            self.flat.add_(update)
            self.losses.index_copy_(0, self.i, loss.reshape(1))
            self.i.add_(1)

    def run(self, module: RNM_NN, q_p, q_s, perm, learning_rate: float):
        """One epoch, as _train_epoch(module, state, q_p, q_s, perm,
        batch_size, learning_rate): updates the module's parameters;
        returns (the Adam state, the mean batch loss, a 0-d tensor)."""
        nb, bs = self.num_batches, self.batch_size
        perm = perm[: nb * bs]
        self.xb.copy_(q_p[perm].reshape(nb, bs, -1))
        self.yb.copy_(q_s[perm].reshape(nb, bs, -1))
        counts = range(self.count + 1, self.count + nb + 1)
        self.bc.copy_(torch.tensor([[1 - B1 ** t for t in counts],
                                    [1 - B2 ** t for t in counts]],
                                   dtype=torch.float64))
        self.lr.fill_(learning_rate)
        self.i.zero_()
        for _ in range(nb):
            self.graph.replay()
        self.count += nb
        with torch.no_grad():
            for p, t in zip(module.parameters(),
                            _unflat(self.flat, self.shapes, self.sizes)):
                p.copy_(t)
        return (AdamState(self.count, (self.mu,), (self.nu,)),
                torch.mean(self.losses))


@torch.no_grad()
def _eval_loss(module: RNM_NN, q_p, q_s):
    """MSE of the module's predictions over the rows and outputs."""
    return torch.mean((module(q_p) - q_s) ** 2)


def train_rnm(q_p, q_s, *, epochs: int = 5000, lr: float = 1e-3,
              batch_size: int = 16, train_frac: float = 0.9,
              patience: int = 500, seed: int = 1234557,
              model_path: str = "rnm_model.pt",
              plateau_patience: int = 100, plateau_factor: float = 0.5,
              plateau_threshold: float = 1e-4, min_lr: float = 1e-7,
              train_dtype="float32", resume: bool = False,
              verbose: bool = False,
              device=None) -> Tuple[RNM_NN, TrainingMonitor]:
    """Train the RNM closure network on `device` (default: the card).
    Returns (module, monitor), the module holding the best checkpoint
    (the JAX package returns (module, params, monitor)).

    Scheduling matches the reference (EPOCHS=5000, LR_INIT=1e-3,
    LR_PATIENCE=100, COMPLETION_PATIENCE=500, BATCH_SIZE=16): Adam with a
    ReduceLROnPlateau stepped ONCE PER EPOCH on the validation loss
    (torch semantics: relative improvement threshold 1e-4, patience
    counted in epochs, the stale count reset at each cut).

    The train/validation split is np.random.default_rng(seed)'s
    permutation, the JAX package's indices. The initialisation draws
    from a torch.Generator seeded with `seed`, each epoch's permutation
    from a second one seeded with seed + 1 (JAX: PRNGKey(seed) and
    PRNGKey(seed + 1)), both on the CPU so that every device trains
    from the same draws.

    resume: warm-start from an existing `model_path` checkpoint: restore
    the best parameters and the loss history and continue the epoch
    count; Adam's moments restart from zero and `lr` is the learning
    rate the interrupted run had reached.
    """
    device = resolve_device(device)
    q_p = np.asarray(q_p)
    q_s = np.asarray(q_s)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(q_p.shape[0])
    n_train = int(train_frac * q_p.shape[0])
    tr, va = perm[:n_train], perm[n_train:]
    td = getattr(torch, np.dtype(train_dtype).name)
    qp_tr = as_tensor(q_p[tr], device=device, dtype=td)
    qs_tr = as_tensor(q_s[tr], device=device, dtype=td)
    qp_va = as_tensor(q_p[va], device=device, dtype=td)
    qs_va = as_tensor(q_s[va], device=device, dtype=td)

    module = init_rnm(q_p.shape[1], q_s.shape[1],
                      generator=torch.Generator().manual_seed(seed),
                      dtype=td, device=device)
    monitor = TrainingMonitor(model_path, patience)
    start_epoch = 0
    if resume and os.path.exists(model_path):
        module = monitor.load_from_path(model_path, module).to(td)
        start_epoch = monitor.epoch
        if verbose:
            print(f"  resumed {model_path}: epoch {start_epoch}, "
                  f"best val {monitor.best_crit:.3e}, lr {lr:.2e}")
    opt_state = adam_init_module(module)
    batch_size = min(batch_size, n_train)
    if device.type == "cuda":
        graph = _EpochGraph(module, opt_state, qp_tr, qs_tr, batch_size)

        def epoch_step(state, perm_e, cur_lr):
            return graph.run(module, qp_tr, qs_tr, perm_e, cur_lr)
    else:
        def epoch_step(state, perm_e, cur_lr):
            return _train_epoch(module, state, qp_tr, qs_tr, perm_e,
                                batch_size, cur_lr)
    gen = torch.Generator().manual_seed(seed + 1)

    cur_lr = lr
    plateau_best = monitor.best_crit if start_epoch else np.inf
    plateau_stale = 0
    t0 = time.time()
    for epoch in range(start_epoch, epochs):
        perm_e = torch.randperm(n_train, generator=gen).to(device)
        opt_state, train_loss = epoch_step(opt_state, perm_e, cur_lr)
        val = _eval_loss(module, qp_va, qs_va) if va.size else train_loss
        # the epoch's one host read
        train_loss, val_loss = torch.stack([train_loss, val]).tolist()
        # torch ReduceLROnPlateau(mode='min', threshold_mode='rel')
        if val_loss < plateau_best * (1.0 - plateau_threshold):
            plateau_best = val_loss
            plateau_stale = 0
        else:
            plateau_stale += 1
            if plateau_stale > plateau_patience and cur_lr > min_lr:
                cur_lr = max(cur_lr * plateau_factor, min_lr)
                plateau_stale = 0
                if verbose:
                    print(f"  epoch {epoch}: lr -> {cur_lr:.2e}")
        if verbose and epoch % 50 == 0:
            print(f"  epoch {epoch}: train {train_loss:.3e} "
                  f"val {val_loss:.3e} lr {cur_lr:.2e}")
        if monitor.check_for_completion(train_loss, val_loss, module):
            break
    if verbose:
        ran = monitor.epoch - start_epoch
        elapsed = time.time() - t0
        print(f"  trained {ran} epochs in {elapsed:.2f} s "
              f"({elapsed / max(ran, 1):.4f} s/epoch), best val "
              f"{monitor.best_crit:.3e}")

    module = monitor.load_from_path(model_path, module)
    return module, monitor
