from finitedifference_tpu_torch.ops.stencil import (
    ddx_upwind,
    ddy_upwind,
    shift_west,
    shift_south,
    source_term,
    inflow_bc_term,
    burgers_residual,
    burgers_residual_flat,
    apply_jacobian,
    apply_jacobian_flat,
    jacobian_times_basis,
)

__all__ = [
    "ddx_upwind",
    "ddy_upwind",
    "shift_west",
    "shift_south",
    "source_term",
    "inflow_bc_term",
    "burgers_residual",
    "burgers_residual_flat",
    "apply_jacobian",
    "apply_jacobian_flat",
    "jacobian_times_basis",
]
