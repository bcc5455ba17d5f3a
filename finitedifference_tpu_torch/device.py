"""Where the port's entry points run: on the card unless asked for the CPU.

A tensor stays on its own device. Anything else (a numpy array, a list, a
float) goes to the device the caller names, and by default to the CUDA
device. A caller asks for the CPU with CPU tensors or device="cpu"; there
is no silent fallback to the CPU when no card is present.
"""

from __future__ import annotations

import numpy as np
import torch


def default_device() -> torch.device:
    """The CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass CPU tensors or "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA device (raises when
    there is none)."""
    return default_device() if device is None else torch.device(device)


def to_host(x) -> np.ndarray:
    """x as a host NumPy array; a tensor is waited for and copied from its
    device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """torch.as_tensor, where anything but a tensor goes to
    `device or default_device()` and a tensor stays on its device unless
    `device` is given."""
    if device is None and not isinstance(x, torch.Tensor):
        device = default_device()
    return torch.as_tensor(x, dtype=dtype, device=device)
