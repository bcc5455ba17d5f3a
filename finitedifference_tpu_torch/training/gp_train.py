"""GP closure training (PyTorch): fit a Matérn GP from scaled q_p to q_s,
persist, reload.

Counterpart of finitedifference_tpu/training/gp_train.py (the reference's
POD-GP trainers, POD-GP/train_gp.py and compute_gp_models*.py). The fit
runs on the device the caller names (default: the card; the JAX package
moves it to the host CPU because a TPU emulates f64). The .npz model file
has the JAX package's keys, so each package loads the other's
pod_gp_model.npz.
"""

from __future__ import annotations

import numpy as np
import torch

from finitedifference_tpu_torch.closures.common import MinMaxScaler
from finitedifference_tpu_torch.closures.gp import (
    GPModel,
    PerModeGPModel,
    fit_gp,
    fit_gp_full_per_mode,
    fit_gp_per_mode,
    fit_gp_variational,
)
from finitedifference_tpu_torch.device import resolve_device, to_host
from finitedifference_tpu_torch.training.rbf_train import remove_duplicates

PER_MODE = ("none", "scales", "full", "variational")


def train_gp(q_p, q_s, *, noise: float = 1e-8, num_steps: int = 300,
             dedup: bool = True, ard: bool = True, nu: float = 1.5,
             per_mode: str = "none", num_inducing: int = 64,
             device=None, verbose: bool = False):
    """Fit the GP closure model on `device` (default: the card).

    ard=True (default) learns per-dimension length scales; per_mode
    selects the output-mode treatment:
      none        — one shared kernel and (amp, noise) for all outputs;
      scales      — shared ARD length scales, an exact (amp, noise) per
                    mode in the kernel eigenbasis (a GPModel);
      full        — independent per-mode ARD GPs (PerModeGPModel);
      variational — the sparse variational GP with `num_inducing`
                    learned inducing points (a GPModel on them).
    Another per_mode raises ValueError."""
    if per_mode not in PER_MODE:
        raise ValueError(f"unknown per_mode {per_mode!r}; use one of "
                         f"{PER_MODE}")
    dev = resolve_device(device)
    q_p = to_host(q_p)
    q_s = to_host(q_s)
    if dedup:
        q_p, q_s = remove_duplicates(q_p, q_s)
    q_p = torch.as_tensor(q_p, device=dev)
    if per_mode == "variational":
        model = fit_gp_variational(q_p, q_s, noise=noise,
                                   num_inducing=num_inducing,
                                   num_steps=num_steps, nu=nu)
    elif per_mode == "full":
        model = fit_gp_full_per_mode(q_p, q_s, noise=noise,
                                     num_steps=num_steps, nu=nu)
    elif per_mode == "scales":
        model = fit_gp_per_mode(q_p, q_s, noise=noise,
                                num_steps=num_steps, ard=ard, nu=nu)
    else:
        model = fit_gp(q_p, q_s, noise=noise, num_steps=num_steps,
                       ard=ard, nu=nu)
    if verbose:
        print(f"  gp: amplitude={np.round(to_host(model.amplitude), 4)} "
              f"length_scale={np.round(to_host(model.length_scale), 4)}")
    return model


def save_gp(model, path: str) -> None:
    """Persist as an .npz with the JAX package's keys."""
    np.savez(path,
             x_train=to_host(model.x_train),
             alpha=to_host(model.alpha),
             length_scale=to_host(model.length_scale),
             amplitude=to_host(model.amplitude),
             noise=model.noise, nu=model.nu,
             per_mode=isinstance(model, PerModeGPModel),
             scaler_scale=to_host(model.scaler.scale_),
             scaler_min=to_host(model.scaler.min_))


def load_gp(path: str, device=None):
    """The model of save_gp (of either package), on `device` (default: the
    card): a PerModeGPModel where the file says per_mode, else a GPModel;
    a file without nu has nu 1.5."""
    dev = resolve_device(device)
    z = np.load(path)

    def arr(key):
        return torch.as_tensor(z[key], device=dev)

    cls = PerModeGPModel if ("per_mode" in z.files and bool(z["per_mode"])) \
        else GPModel
    return cls(
        x_train=arr("x_train"),
        alpha=arr("alpha"),
        length_scale=arr("length_scale"),
        amplitude=arr("amplitude"),
        noise=float(z["noise"]),
        nu=float(z["nu"]) if "nu" in z.files else 1.5,
        scaler=MinMaxScaler(scale_=arr("scaler_scale"),
                            min_=arr("scaler_min")),
    )
