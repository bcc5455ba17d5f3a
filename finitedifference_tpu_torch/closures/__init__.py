"""Nonlinear closure models for manifold ROMs (PyTorch).

Counterpart of finitedifference_tpu/closures. Every closure maps primary
reduced coordinates q_p to secondary coordinates q_s, giving the decoder

    w(y) = U_p @ y + U_s @ closure(y)

A closure is a pair of callables (predict, jacobian), with an optional
fused form; `manifold_decoder` composes them with the POD blocks into the
(decode, dec_jac) pair that solvers.gauss_newton consumes. Ported so far:
the global and kNN RBF closures (closures/rbf.py), the Matérn GP
closures with their four fits (closures/gp.py) and the RNM network
closure (closures/ann.py: RNM_NN, an nn.Module, with Flax's init and its
jacfwd Jacobian). closures/autoencoder.py holds the AE-LSPG ROM's full
autoencoder, whose decoder is the whole manifold rather than a closure.
"""

from finitedifference_tpu_torch.closures.common import (
    Closure,
    MinMaxScaler,
    fit_minmax,
    manifold_decoder,
    manifold_decoder_fused,
)

__all__ = ["Closure", "MinMaxScaler", "fit_minmax", "manifold_decoder",
           "manifold_decoder_fused"]
