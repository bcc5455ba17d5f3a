"""finitedifference_tpu_torch: the PyTorch/CUDA port of finitedifference_tpu.

The same modules, function names and signatures as the JAX package, in
PyTorch's idiom: plain functions on tensors, the device taken from the
input tensors, Python loops in place of lax.while_loop and lax.scan.
Every TPU kernel on the ported path is a kernel written by hand for
NVIDIA Hopper (csrc/), built with nvcc at first use; on CPU tensors each
kernel's plain PyTorch version runs instead.

Ported so far:
- the implicit full-order model: config, grid, ops/stencil,
  ops/wavefront, ops/skewed, ops/cuda_wavefront, fom;
- the reduced models: precision, solvers, pod, snapshots, ops/sampled,
  rom, ecsw, rom_factored, rom_tensor, with the
  Gauss-Newton system kernels in ops/gn_full + ops/cuda_gn_full and
  ops/gn + ops/cuda_gn, and the whole-trajectory kernel
  (rom_factored.pallas_traj_hprom);
- the μ sweeps: parallel/sweep (sweep_fom, sweep_lspg, sweep_hprom), with
  the segmented wavefront solve behind the FOM's `seg > 0`;
- the users' workflow: the runner CLIs (runners/run_fom, run_prom,
  run_hprom, run_sweep; `python -m finitedifference_tpu_torch.runners.X`),
  the rest of ecsw (FISTA, ECM, the sequential, multilevel and
  device-resident weight recipes) and utils (timers, profiling);
- the POD-RBF closure ROMs: closures (the global and kNN RBF closures,
  the manifold decoder), rom.manifold_rom, solvers.fit_reduced_coords,
  ecsw.ecsw_training_matrix_closure, training (the RBF fits) and the
  runners run_pod_rbf_global, run_pod_rbf_hprom and run_pod_rbf;
- the POD-GP closure ROM and the other global-RBF searches (closures/gp,
  training/gp_train, optim, training/svr, run_pod_gp_hprom);
- the POD-ANN closures (closures/ann, training/rnm_train, run_rnm,
  run_hrnm, parallel/sweep.sweep_manifold);
- AE-LSPG (closures/autoencoder, training/data, training/ae_train,
  run_ae_prom), the regression drivers (run_tests, run_tests_hprom),
  check_derivatives, and entry, the twin of __graft_entry__.entry;
- convert, which carries grids, layouts, meshes, padded inputs, arrays,
  results and the closure models and networks across from the JAX
  package.
Entry points run on the CUDA device unless given CPU tensors or
device="cpu" (device.py): arrays that are not tensors never land on the
CPU by default. Importing the package pins full-f32 matmuls (no TF32;
precision.py). This package never imports jax.
"""

from finitedifference_tpu_torch import precision  # noqa: F401 (pins TF32 off)
from finitedifference_tpu_torch.config import BurgersConfig, DEFAULT_CONFIG
from finitedifference_tpu_torch.grid import Grid2D, make_2d_grid

__version__ = "0.3.0"

__all__ = [
    "BurgersConfig",
    "DEFAULT_CONFIG",
    "Grid2D",
    "make_2d_grid",
    "__version__",
]
