"""Training monitor (PyTorch): best-checkpoint saving, patience-based early
stop, loss-history tracking.

Counterpart of finitedifference_tpu/training/monitor.py (the reference's
TrainingMonitor, train_utils.py:21-85): persist the network whenever the
validation criterion improves, stop after `patience` epochs without
improvement, and resume from a checkpoint path. The checkpoint is
torch.save of the module's state_dict() with its tensors on the CPU (the
JAX package writes Flax msgpack, which this package does not read); the
scalar histories land in the same sidecar <path>.json, with the same four
keys, so they stay human-readable.
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn


class TrainingMonitor:
    def __init__(self, model_path: str, patience: int):
        self.model_path = model_path
        self.patience = patience
        self.best_crit = float("inf")
        self.its_since_improvement = 0
        self.epoch = 0
        self.train_losses: list = []
        self.test_crits: list = []

    def check_for_completion(self, train_loss: float, test_crit: float,
                             module: nn.Module) -> bool:
        """Record one epoch; checkpoint on improvement; True = stop now."""
        self.epoch += 1
        self.its_since_improvement += 1
        self.train_losses.append(float(train_loss))
        self.test_crits.append(float(test_crit))
        if test_crit < self.best_crit:
            self.best_crit = float(test_crit)
            self.its_since_improvement = 0
            self.save_checkpoint(module)
        return self.its_since_improvement > self.patience

    def save_checkpoint(self, module: nn.Module) -> None:
        os.makedirs(os.path.dirname(self.model_path) or ".", exist_ok=True)
        torch.save({k: v.detach().cpu()
                    for k, v in module.state_dict().items()},
                   self.model_path)
        meta = {
            "epoch": self.epoch,
            "best_crit": self.best_crit,
            "train_losses": self.train_losses,
            "test_crits": self.test_crits,
        }
        with open(self.model_path + ".json", "w") as f:
            json.dump(meta, f)

    def load_from_path(self, path: str, module: nn.Module) -> nn.Module:
        """Load the checkpoint into `module` (load_checkpoint) and restore
        the epoch and the histories from the sidecar."""
        module = load_checkpoint(path, module)
        meta_path = path + ".json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.epoch = meta["epoch"]
            self.train_losses = meta["train_losses"]
            self.test_crits = meta["test_crits"]
            self.best_crit = min(self.test_crits) if self.test_crits \
                else float("inf")
        return module


def load_checkpoint(path: str, module: nn.Module) -> nn.Module:
    """Load a saved state_dict into `module`, on the module's device. The
    tensors keep the checkpoint's dtype, as Flax's from_bytes keeps the
    saved arrays' dtype whatever the template's."""
    device = next(module.parameters()).device
    state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(state, assign=True)
    return module.to(device)
