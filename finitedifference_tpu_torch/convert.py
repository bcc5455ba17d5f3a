"""Carrying state across from the JAX package, without importing jax.

Grids, layouts, sampled meshes, factored blocks, the tensor HPROM's
operators, results and the RBF and GP closure models are read field by field
from any object that has the fields; arrays go through numpy onto the
CUDA device unless a `device` is given (device="cpu" for the CPU). The
FOM and the linear ROMs have no learned weights: the POD basis (and the
padded layouts made from it) is the state carried across. The RBF
closures' fitted state (weights, scaled training set, scaler) comes
across with global_rbf_from_jax / knn_rbf_from_jax, or through the
shared .npz model file (training/rbf_train.load_global_rbf); the GP
closures' (training inputs or inducing points, alpha, length scales,
amplitude, noise, nu, scaler) with gp_from_jax or the shared
pod_gp_model.npz (training/gp_train.load_gp). A Flax RNM network's
parameter tree becomes an RNM_NN with rnm_from_flax, a Flax Autoencoder's
with its standardisation a ScaledAE with ae_from_flax; the port's own
checkpoints are torch state dicts (training/monitor.py).
"""

from __future__ import annotations

import numpy as np
import torch

from finitedifference_tpu_torch.closures.ann import RNM_NN
from finitedifference_tpu_torch.closures.autoencoder import (
    Autoencoder,
    ScaledAE,
)
from finitedifference_tpu_torch.closures.common import MinMaxScaler
from finitedifference_tpu_torch.closures.gp import GPModel, PerModeGPModel
from finitedifference_tpu_torch.closures.rbf import GlobalRBF, KNNRBF
from finitedifference_tpu_torch.device import resolve_device
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.sampled import SampledMesh
from finitedifference_tpu_torch.ops.skewed import SkewedLayout
from finitedifference_tpu_torch.rom import ROMResult
from finitedifference_tpu_torch.rom_factored import FactoredBlocks
from finitedifference_tpu_torch.rom_tensor import HPROMTensors


def grid_from_jax(g) -> Grid2D:
    """A Grid2D with the fields of `g` (e.g. finitedifference_tpu's)."""
    return Grid2D(nx=int(g.nx), ny=int(g.ny),
                  x_low=float(g.x_low), x_up=float(g.x_up),
                  y_low=float(g.y_low), y_up=float(g.y_up))


def layout_from_jax(lay) -> SkewedLayout:
    """A SkewedLayout with the fields of `lay`."""
    return SkewedLayout(nx=int(lay.nx), ny=int(lay.ny),
                        nd_pad=int(lay.nd_pad), ny_pad=int(lay.ny_pad))


def to_torch(a, device=None, dtype=None) -> torch.Tensor:
    """A copy of an array (numpy, or anything np.asarray takes) as a
    tensor on `device` (default: the CUDA device)."""
    return torch.tensor(np.asarray(a), dtype=dtype,
                        device=resolve_device(device))


_MESH_BOOL = ("has_west", "has_south", "is_left")


def mesh_from_jax(mesh, device=None) -> SampledMesh:
    """A SampledMesh with the fields of `mesh`: index maps as int64,
    masks as bool, on `device`."""
    return SampledMesh(*(
        to_torch(getattr(mesh, f), device=device,
                 dtype=torch.bool if f in _MESH_BOOL else torch.int64)
        for f in SampledMesh._fields))


def blocks_from_jax(blocks, device=None, dtype=None) -> FactoredBlocks:
    """FactoredBlocks with the p6 array of `blocks`."""
    return FactoredBlocks(p6=to_torch(blocks.p6, device=device,
                                      dtype=dtype))


def tensors_from_jax(tensors, device=None, dtype=None) -> HPROMTensors:
    """HPROMTensors with the vs, h and basis_aug arrays of `tensors`."""
    return HPROMTensors(*(to_torch(getattr(tensors, f), device=device,
                                   dtype=dtype)
                          for f in HPROMTensors._fields))


def rom_result_from_jax(res, device=None) -> ROMResult:
    """A ROMResult with the red_coords and total_gn_its of `res`."""
    return ROMResult(red_coords=to_torch(res.red_coords, device=device),
                     total_gn_its=int(res.total_gn_its))


def scaler_from_jax(scaler, device=None) -> MinMaxScaler:
    """A MinMaxScaler with the scale_ and min_ arrays of `scaler`."""
    return MinMaxScaler(scale_=to_torch(scaler.scale_, device=device),
                        min_=to_torch(scaler.min_, device=device))


def global_rbf_from_jax(model, device=None) -> GlobalRBF:
    """A GlobalRBF with the weights, scaled training set, epsilon, kernel
    and scaler of `model` (the JAX package's GlobalRBF)."""
    return GlobalRBF(w_global=to_torch(model.w_global, device=device),
                     q_p_train=to_torch(model.q_p_train, device=device),
                     epsilon=float(model.epsilon), kernel=str(model.kernel),
                     scaler=scaler_from_jax(model.scaler, device=device))


def knn_rbf_from_jax(model, device=None) -> KNNRBF:
    """A KNNRBF with the scaled training pairs, epsilon, neighbour count,
    kernel, scaler and ridge of `model` (the JAX package's KNNRBF)."""
    return KNNRBF(q_p_train=to_torch(model.q_p_train, device=device),
                  q_s_train=to_torch(model.q_s_train, device=device),
                  epsilon=float(model.epsilon),
                  neighbors=int(model.neighbors), kernel=str(model.kernel),
                  scaler=scaler_from_jax(model.scaler, device=device),
                  ridge=float(model.ridge))


def gp_from_jax(model, device=None):
    """A GPModel, or a PerModeGPModel where `model` is the JAX package's
    PerModeGPModel, with the fields of `model`."""
    cls = PerModeGPModel if type(model).__name__ == "PerModeGPModel" \
        else GPModel
    return cls(x_train=to_torch(model.x_train, device=device),
               alpha=to_torch(model.alpha, device=device),
               length_scale=to_torch(model.length_scale, device=device),
               amplitude=to_torch(model.amplitude, device=device),
               noise=float(model.noise),
               scaler=scaler_from_jax(model.scaler, device=device),
               nu=float(model.nu))


def rnm_from_flax(params, device=None) -> RNM_NN:
    """An RNM_NN holding a Flax RNM_NN's parameters: each
    params["params"]["Dense_i"]["kernel"], (in, out), becomes Linear i's
    weight as (out, in), the biases as they are, in their own dtype; the
    hidden widths are read from the kernels' shapes."""
    dense = params["params"]
    kernels = [np.asarray(dense[f"Dense_{i}"]["kernel"])
               for i in range(len(dense))]
    module = RNM_NN(kernels[0].shape[0], kernels[-1].shape[1],
                    hidden=[k.shape[1] for k in kernels[:-1]],
                    dtype=getattr(torch, kernels[0].dtype.name), device="cpu")
    module.load_state_dict(_dense_state(dense, "layers"), assign=True)
    return module.to(resolve_device(device))


def _dense_state(dense, prefix):
    """{prefix.i.weight, prefix.i.bias} from Flax's Dense_i kernels (in,
    out), transposed to nn.Linear's (out, in), and biases."""
    state = {}
    for i in range(len(dense)):
        k = np.asarray(dense[f"Dense_{i}"]["kernel"])
        state[f"{prefix}.{i}.weight"] = torch.from_numpy(k.T.copy())
        state[f"{prefix}.{i}.bias"] = torch.from_numpy(
            np.asarray(dense[f"Dense_{i}"]["bias"]).copy())
    return state


def ae_from_flax(params, mu_in, sig_in, device=None) -> ScaledAE:
    """A ScaledAE holding a Flax Autoencoder's parameters (each
    params["params"]["encoder" | "decoder"]["Dense_i"] kernel, (in, out),
    becomes that part's Linear i weight as (out, in)), in their own dtype,
    and the standardisation mu_in, sig_in in theirs, on `device`."""
    enc, dec = params["params"]["encoder"], params["params"]["decoder"]
    k0 = np.asarray(enc["Dense_0"]["kernel"])
    latent = np.asarray(enc[f"Dense_{len(enc) - 1}"]["kernel"]).shape[1]
    module = Autoencoder(k0.shape[0], latent,
                         dtype=getattr(torch, k0.dtype.name), device="cpu")
    module.load_state_dict({**_dense_state(enc, "encoder.layers"),
                            **_dense_state(dec, "decoder.layers")},
                           assign=True)
    return ScaledAE(module=module.to(resolve_device(device)),
                    mu_in=to_torch(mu_in, device=device),
                    sig_in=to_torch(sig_in, device=device))


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x if x is None else np.asarray(x)


def result_to_numpy(res):
    """A FOMResult, NewtonResult, GNResult or ROMResult with every field
    as a numpy array (None stays None)."""
    return type(res)(*(_to_numpy(x) for x in res))
