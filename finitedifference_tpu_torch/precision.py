"""Matmul-precision policy (PyTorch).

Counterpart of finitedifference_tpu/precision.py. On the TPU the default
f32 matmul multiplies in bfloat16 passes, and that default wrecked
reduced-model trajectories by 6-11% (ops/pallas_gn.py in the JAX
package). On an NVIDIA card the same trap is TF32: cuBLAS and cuDNN may
round f32 operands to a 10-bit mantissa. Importing this module (the
package's __init__ does) pins full f32 for every matmul and convolution
of the process:

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

so every Gram, GEMV and projection of the port runs in true f32 (or f64).
"""

from __future__ import annotations

import torch


def pin_full_precision() -> None:
    """Turn TF32 off for matmuls and convolutions, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def precision_flags() -> dict:
    """The three settings the policy pins, as they stand now."""
    return {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


def hi_matmul(a, b):
    """a @ b. Full f32 accumulation holds because the policy above is
    pinned; the name keeps the JAX package's call sites."""
    return torch.matmul(a, b)


pin_full_precision()
