"""Full nonlinear-manifold autoencoder (PyTorch): the AE-LSPG ROM's model.

Counterpart of finitedifference_tpu/closures/autoencoder.py (the
reference's ScaledAutoencoder, TestAE AE/train_autoencoder.py:35-73): an
ELU MLP input -> 512 -> 256 -> 128 -> 64 -> z and the mirrored decoder,
with per-feature standardisation (the training snapshots' mean and
standard deviation) applied around the network. The decoder Jacobian is
torch.func.jacfwd, as the JAX package takes jax.jacfwd. Matmuls run in
full f32 (precision.py keeps TF32 off), the counterpart of the JAX
layers' Precision.HIGHEST.

The parameters start from Flax's default initialisation
(closures/ann.flax_init_), encoder layers first, and are float32 unless
asked otherwise, whatever the data's dtype: Flax keeps float32
parameters and computes each layer in the promotion of its input's and
its parameters' dtypes, as ae_apply does. convert.ae_from_flax carries a
Flax network across exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from finitedifference_tpu_torch.closures.ann import (
    flax_init_,
    linear_stack,
    rnm_apply,
)
from finitedifference_tpu_torch.device import resolve_device

HIDDEN = (512, 256, 128, 64)


def ae_apply(params: Sequence[torch.Tensor], x):
    """The ELU MLP of closures/ann.rnm_apply on x (..., in) with params
    (W0, b0, W1, b1, ...), in the promotion of x's and the parameters'
    dtypes (a float64 input through float32 parameters runs in float64,
    as a Flax Dense does)."""
    dt = torch.promote_types(x.dtype, params[0].dtype)
    return rnm_apply([p.to(dt) for p in params], x.to(dt))


class Encoder(nn.Module):
    def __init__(self, input_dim: int, latent_dim: int,
                 hidden: Sequence[int] = HIDDEN, dtype=torch.float32):
        super().__init__()
        self.layers = linear_stack((input_dim, *hidden, latent_dim), dtype)

    def forward(self, x):
        return ae_apply(tuple(self.parameters()), x)


class Decoder(nn.Module):
    def __init__(self, latent_dim: int, output_dim: int,
                 hidden: Sequence[int] = HIDDEN[::-1], dtype=torch.float32):
        super().__init__()
        self.layers = linear_stack((latent_dim, *hidden, output_dim), dtype)

    def forward(self, z):
        return ae_apply(tuple(self.parameters()), z)


class Autoencoder(nn.Module):
    """Encoder and decoder on *standardised* inputs. The parameters are
    drawn as Flax's Autoencoder.init draws them (module docstring) from
    `generator` (seeded with 0 when None), on the CPU, then moved to
    `device` (default: the card)."""

    def __init__(self, input_dim: int, latent_dim: int, *,
                 dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.encoder = Encoder(input_dim, latent_dim, dtype=dtype)
        self.decoder = Decoder(latent_dim, input_dim, dtype=dtype)
        flax_init_([*self.encoder.layers, *self.decoder.layers], generator)
        self.to(resolve_device(device))

    def encode(self, x_scaled):
        return self.encoder(x_scaled)

    def decode(self, z):
        return self.decoder(z)

    def forward(self, x_scaled):
        return self.decode(self.encode(x_scaled))


def _frozen(part: nn.Module):
    return tuple(p.detach() for p in part.parameters())


def _rows(x):
    """A vector as it is, a batch of columns (dim, T) as rows (T, dim)."""
    return x.T if x.ndim == 2 else x


class ScaledAE(NamedTuple):
    """Trained autoencoder bundle: the module (holding the parameters) and
    the standardisation. Each method takes one vector or a batch of
    columns (dim, T) and returns the same layout (the JAX package maps a
    batch with jax.vmap); the network runs on its parameters without
    grad."""
    module: Autoencoder
    mu_in: torch.Tensor     # (input_dim,)
    sig_in: torch.Tensor    # (input_dim,)

    @property
    def net_dtype(self):
        return next(self.module.parameters()).dtype

    def _scaled(self, x):
        return ((_rows(x) - self.mu_in) / self.sig_in).to(self.net_dtype)

    def forward(self, x):
        xs = self._scaled(x)
        z = ae_apply(_frozen(self.module.encoder), xs)
        recon = ae_apply(_frozen(self.module.decoder), z).to(x.dtype)
        return _rows(recon * self.sig_in + self.mu_in)

    def encode(self, x):
        z = ae_apply(_frozen(self.module.encoder), self._scaled(x))
        return _rows(z.to(x.dtype))

    def decode(self, z):
        recon = ae_apply(_frozen(self.module.decoder),
                         _rows(z).to(self.net_dtype))
        return _rows(recon.to(z.dtype) * self.sig_in + self.mu_in)


def init_autoencoder(input_dim: int, latent_dim: int,
                     generator: torch.Generator | None = None,
                     device=None, dtype=torch.float32) -> Autoencoder:
    """A new Autoencoder with Flax's default initialisation drawn from
    `generator` (seeded with 0 when None), its parameters in `dtype`
    (float32, Flax's parameter dtype, whatever the data's) on `device`
    (default: the card)."""
    return Autoencoder(input_dim, latent_dim, dtype=dtype, device=device,
                       generator=generator)


def ae_decoder_fns(ae: ScaledAE):
    """(decode, dec_jac, encode) for the AE-LSPG ROM (manifold_rom);
    dec_jac(z, w=None) is torch.func.jacfwd of decode, (input_dim,
    latent_dim)."""
    decode = ae.decode
    jac = torch.func.jacfwd(decode)

    def dec_jac(z, w=None):
        return jac(z)

    return decode, dec_jac, ae.encode
