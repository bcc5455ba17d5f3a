"""AE-LSPG ROM: full nonlinear autoencoder manifold (reference TestAE
run_ae_prom.py: train ScaledAutoencoder on snapshots, LSPG over the
decoder with jacfwd decoder Jacobians).

Offline (--retrain, or when the model file is missing): the autoencoder
trained on the 9 training trajectories (training/ae_train), its best
checkpoint saved as ae_model.pt (ae_model_{N}x{N}.pt away from 250^2), a
torch state dict, with the JAX package's JSON sidecar beside it. Online:
the manifold LSPG ROM over the decoder at (mu1, mu2), truncated-SVD
least squares with backtracking, against the cached FOM.

    python -m finitedifference_tpu_torch.runners.run_ae_prom [--device cpu]
        [--retrain] [--epochs 300] [--latent-dim 10]

As in the JAX runner, the online state takes the dtype of the
standardisation: float32 after training (the trainer casts the
snapshots to float32), float64 when the checkpoint is loaded (the
standardisation is then taken from the float64 snapshots); the network
is float32 either way. --f32 is accepted and changes nothing, as in the
JAX runner.
"""

import os
import time

import torch

from finitedifference_tpu_torch.closures.autoencoder import (
    ScaledAE,
    ae_decoder_fns,
    init_autoencoder,
)
from finitedifference_tpu_torch.rom import manifold_rom
from finitedifference_tpu_torch.runners.common import (
    base_parser,
    default_config,
    make_problem,
    report,
    res_path,
    runner_device,
)
from finitedifference_tpu_torch.snapshots import (
    collect_snapshots,
    load_or_compute_snaps,
)
from finitedifference_tpu_torch.training.ae_train import train_autoencoder
from finitedifference_tpu_torch.training.monitor import load_checkpoint

MODEL_PATH = "ae_model.pt"


def main(mu1=4.75, mu2=0.02, latent_dim=10, epochs=300, retrain=False,
         num_cells=None, num_steps=None, f32=False, device="cuda"):
    dev = runner_device(device)
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)
    # per-resolution model file: a 20^2-input AE must never shadow the
    # 50^2 one
    model_path = res_path(cfg, MODEL_PATH)
    w0_d = torch.as_tensor(w0, device=dev)

    snaps = collect_snapshots(cfg.mu_samples(), grid, w0_d, cfg.dt,
                              cfg.num_steps, snap_folder=cfg.snap_folder)
    if retrain or not os.path.exists(model_path):
        t0 = time.time()
        ae, _ = train_autoencoder(snaps.T, latent_dim, epochs=epochs,
                                  batch_size=cfg.batch_size,
                                  train_frac=cfg.train_frac,
                                  patience=50, seed=cfg.seed,
                                  model_path=model_path, verbose=True,
                                  device=dev)
        print(f"ae fit time: {time.time() - t0:.2f}s "
              f"({snaps.shape[1]} snapshots)")
    else:
        mu_in = torch.as_tensor(snaps.T.mean(axis=0), device=dev)
        sig_in = torch.as_tensor(snaps.T.std(axis=0) + 1e-10, device=dev)
        module = load_checkpoint(model_path,
                                 init_autoencoder(snaps.shape[0],
                                                  latent_dim, device=dev))
        ae = ScaledAE(module=module, mu_in=mu_in, sig_in=sig_in)
    del snaps

    decode, dec_jac, encode = ae_decoder_fns(ae)
    z0 = encode(w0_d.to(ae.mu_in.dtype))
    print(f"online state: {z0.dtype}")

    t0 = time.time()
    # truncated-SVD LS + backtracking: the AE decoder Jacobian can be
    # numerically rank-deficient and the full GN step can leave the
    # decoder's training region (solvers.lstsq_svd docstring)
    res = manifold_rom(grid, z0, decode, dec_jac, cfg.dt, cfg.num_steps,
                       mu1, mu2, ls_method="svd", line_search=True)
    rom_snaps = decode(res.red_coords).cpu()
    elapsed = time.time() - t0
    print(f"Total GN iterations: {int(res.total_gn_its)}")

    hdm = load_or_compute_snaps([mu1, mu2], grid, w0_d, cfg.dt,
                                cfg.num_steps, snap_folder=cfg.snap_folder)
    return report("AE-PROM", rom_snaps, hdm, elapsed, (mu1, mu2),
                  save_prefix="ae_prom")


if __name__ == "__main__":
    p = base_parser(__doc__)
    p.add_argument("--latent-dim", type=int, default=10)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--retrain", action="store_true")
    a = p.parse_args()
    main(a.mu1, a.mu2, a.latent_dim, a.epochs, a.retrain, a.num_cells,
         a.num_steps, a.f32, a.device)
