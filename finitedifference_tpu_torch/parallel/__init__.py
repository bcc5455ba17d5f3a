from finitedifference_tpu_torch.parallel.sweep import (
    pad_to_multiple,
    sweep_fom,
    sweep_hprom,
    sweep_lspg,
)

__all__ = [
    "pad_to_multiple",
    "sweep_fom",
    "sweep_hprom",
    "sweep_lspg",
]
