"""The runner CLIs of the port (PyTorch), run as package modules:

    python -m finitedifference_tpu_torch.runners.run_fom [--device cpu]
    python -m finitedifference_tpu_torch.runners.run_prom ...
    python -m finitedifference_tpu_torch.runners.run_hprom ...
    python -m finitedifference_tpu_torch.runners.run_sweep ...

Counterparts of the JAX package's runners/ scripts, with the same flags
(`--device {cuda,cpu}` in place of `--platform`) and the same artifact
files, so the two packages read each other's bases, weights and
snapshots.
"""
