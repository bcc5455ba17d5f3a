"""Full-autoencoder training (PyTorch).

Counterpart of finitedifference_tpu/training/ae_train.py (the reference's
TestAE trainer, AE/train_autoencoder.py:95-174): standardise the inputs,
MSE Adam at a constant learning rate (optax's form, optim.py), a 90/10
split, the best checkpoint on the validation loss, a patience early
stop. The MSE is taken on the *unscaled* reconstruction, as the
reference's forward pass through scale_out.

An epoch is minibatch.train_epoch's loop over one flat parameter vector
on the CPU, and on the card one step captured in a CUDA graph and
replayed (minibatch.EpochGraph), as rnm_train trains the RNM; one host
read an epoch (the losses).
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from finitedifference_tpu_torch.closures.autoencoder import (
    Autoencoder,
    ScaledAE,
    ae_apply,
    init_autoencoder,
)
from finitedifference_tpu_torch.device import as_tensor, resolve_device
from finitedifference_tpu_torch.optim import AdamState
from finitedifference_tpu_torch.training.minibatch import (
    EpochGraph,
    adam_init_flat,
    train_epoch,
)
from finitedifference_tpu_torch.training.monitor import TrainingMonitor


def _forward(params, x, mu, sig):
    """The unscaled reconstruction of the rows x through the network with
    parameters params (module.parameters()'s order: the encoder's layers,
    then the decoder's)."""
    xs = (x - mu) / sig
    half = len(params) // 2
    recon = ae_apply(params[half:], ae_apply(params[:half], xs))
    return recon * sig + mu


def _loss(mu, sig):
    def loss_fn(leaves, x):
        return torch.mean((_forward(leaves, x, mu, sig) - x) ** 2)
    return loss_fn


def _train_epoch(module: Autoencoder, opt_state: AdamState, x, mu, sig,
                 perm, batch_size: int, learning_rate: float = 1e-3):
    """One epoch: the rows perm[:num_batches * batch_size] of x in
    minibatches of batch_size (the rest dropped), one Adam step each at
    learning_rate on the MSE of the unscaled reconstruction. Updates the
    module's parameters in place; returns (opt_state, the mean of the
    batch losses taken before each update) with the loss a 0-d tensor on
    the device."""
    return train_epoch(_loss(mu, sig), module, opt_state, (x,), perm,
                       batch_size, learning_rate)


@torch.no_grad()
def _eval_loss(module: Autoencoder, x, mu, sig):
    """MSE of the unscaled reconstruction of the rows x."""
    return torch.mean((_forward(tuple(module.parameters()), x, mu, sig)
                       - x) ** 2)


def train_autoencoder(snaps_t, latent_dim: int, *, epochs: int = 500,
                      lr: float = 1e-3, batch_size: int = 16,
                      train_frac: float = 0.9, patience: int = 50,
                      seed: int = 1234557, model_path: str = "autoencoder.pt",
                      train_dtype="float32", verbose: bool = False,
                      device=None) -> Tuple[ScaledAE, TrainingMonitor]:
    """Train the autoencoder on `device` (default: the card). snaps_t:
    (n_samples, dim) rows. Returns (ScaledAE, monitor), the module
    holding the best checkpoint.

    The rows are cast to train_dtype on the host, and mu_in and sig_in
    are their NumPy mean and standard deviation (+ 1e-10), as in the JAX
    package; the parameters stay float32 (Flax's), each layer computing
    in the promotion of its input's dtype and theirs. The
    train/validation split is np.random.default_rng(seed)'s permutation,
    the JAX package's rows. The initialisation draws from a
    torch.Generator seeded with `seed`, each epoch's permutation from a
    second one seeded with seed + 1 (JAX: PRNGKey(seed) and
    PRNGKey(seed + 1)), both on the CPU so that every device trains from
    the same draws.
    """
    device = resolve_device(device)
    snaps_t = np.asarray(snaps_t, dtype=np.dtype(train_dtype))
    mu = as_tensor(snaps_t.mean(axis=0), device=device)
    sig = as_tensor(snaps_t.std(axis=0) + 1e-10, device=device)

    rng = np.random.default_rng(seed)
    perm = rng.permutation(snaps_t.shape[0])
    n_train = int(train_frac * snaps_t.shape[0])
    x_tr = as_tensor(snaps_t[perm[:n_train]], device=device)
    x_va = as_tensor(snaps_t[perm[n_train:]], device=device)

    module = init_autoencoder(snaps_t.shape[1], latent_dim,
                              generator=torch.Generator().manual_seed(seed),
                              device=device)
    opt_state = adam_init_flat(module)
    monitor = TrainingMonitor(model_path, patience)
    batch_size = min(batch_size, n_train)
    loss_fn = _loss(mu, sig)
    if device.type == "cuda":
        graph = EpochGraph(loss_fn, module, opt_state, (x_tr,), batch_size)

        def epoch_step(state, perm_e):
            return graph.run(module, (x_tr,), perm_e, lr)
    else:
        def epoch_step(state, perm_e):
            return train_epoch(loss_fn, module, state, (x_tr,), perm_e,
                               batch_size, lr)
    gen = torch.Generator().manual_seed(seed + 1)

    t0 = time.time()
    for epoch in range(epochs):
        perm_e = torch.randperm(n_train, generator=gen).to(device)
        opt_state, train_loss = epoch_step(opt_state, perm_e)
        val = _eval_loss(module, x_va, mu, sig) if x_va.shape[0] \
            else train_loss
        # the epoch's one host read
        train_loss, val_loss = torch.stack([train_loss, val]).tolist()
        if verbose and epoch % 20 == 0:
            print(f"  epoch {epoch}: train {train_loss:.3e} "
                  f"val {val_loss:.3e}")
        if monitor.check_for_completion(train_loss, val_loss, module):
            break
    if verbose:
        elapsed = time.time() - t0
        print(f"  trained {monitor.epoch} epochs in {elapsed:.2f} s "
              f"({elapsed / max(monitor.epoch, 1):.4f} s/epoch), best val "
              f"{monitor.best_crit:.3e}")

    module = monitor.load_from_path(model_path, module)
    return ScaledAE(module=module, mu_in=mu, sig_in=sig), monitor
