from finitedifference_tpu_torch.parallel.mesh import (
    Mesh,
    local_mesh,
    make_mesh,
    spawn,
)
from finitedifference_tpu_torch.parallel.spatial import (
    make_sharded_residual,
    sharded_fom_step,
    sharded_skewed_fom,
    sharded_sweep_fom_step,
)
from finitedifference_tpu_torch.parallel.sweep import (
    make_sweep_mesh,
    pad_to_multiple,
    sharded_factored_hprom,
    sweep_fom,
    sweep_hprom,
    sweep_lspg,
    sweep_manifold,
)

__all__ = [
    "Mesh",
    "local_mesh",
    "make_mesh",
    "make_sharded_residual",
    "make_sweep_mesh",
    "pad_to_multiple",
    "sharded_factored_hprom",
    "sharded_fom_step",
    "sharded_skewed_fom",
    "sharded_sweep_fom_step",
    "spawn",
    "sweep_fom",
    "sweep_hprom",
    "sweep_lspg",
    "sweep_manifold",
]
