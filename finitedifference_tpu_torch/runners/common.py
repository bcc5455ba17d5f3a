"""Shared runner plumbing (PyTorch): device, basis build-or-load, reporting.

Counterpart of runners/common.py. Runners are thin argparse CLIs over the
library with the JAX runners' artifact protocol, so the two packages
read each other's files:
- basis{res_suffix}.npy and sigma{res_suffix}.npy (the POD basis and its
  singular values);
- ecsw_weights_lspg[_method]{res_suffix}.npy (the HPROM weight fields);
- param_snaps{res_suffix}/mu1_X+mu2_Y.npy (cached FOM trajectories);
- {prefix}_snaps_mu1_X_mu2_Y.npy (a runner's reconstructed trajectory);
- pod_rbf_global_model[_{search}]{res_suffix}.npz and
  ecsw_weights_rbf_{variant}_{method}{res_suffix}.npy (the POD-RBF
  closure models and their HPROM weights);
- pod_gp_model{res_suffix}.npz and ecsw_weights_gp_{method}{res_suffix}.npy
  (the POD-GP closure model, one file for every --per-mode variant, and
  its HPROM weights);
- rnm_model{res_suffix}.pt with its sidecar .pt.json and
  ecsw_weights_rnm_{method}{res_suffix}.npy (the RNM network, a torch
  state dict where the JAX runners write Flax msgpack, and its HRNM
  weights).
Everything runs on the CUDA device unless the caller asks for the CPU
(`--device cpu`, `device="cpu"`); without a card, asking for it raises
at once (device.default_device). Precision is pinned when the package is
imported (precision.py), so there is no setup step.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from finitedifference_tpu_torch.config import DEFAULT_CONFIG
from finitedifference_tpu_torch.device import default_device, resolve_device, to_host
from finitedifference_tpu_torch.grid import grid_from_config
from finitedifference_tpu_torch.pod import pod, split_basis
from finitedifference_tpu_torch.snapshots import (
    collect_snapshots,
    load_or_compute_snaps,
    relative_error_pct,
)


def runner_device(device="cuda") -> torch.device:
    """The device a runner was asked for: "cuda" (the card; raises
    without one) or "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        default_device()
    elif dev.type != "cpu":
        raise ValueError(f"unknown device {device!r}; use 'cuda' or 'cpu'")
    return dev


def default_ls(device) -> dict:
    """Gauss-Newton least-squares kwargs for the device.

    On the card: normal equations (a Gram and a Cholesky solve) in the
    state's dtype — every LSPG system here is J@V = V + O(dt) with
    near-orthonormal V, so squaring the condition number costs a few
    digits of a very small number, and the H100 has FP64, so an f64 state
    keeps an f64 solve (the JAX package solves in f32 on a TPU, where f64
    QR was ~30x slower). On the CPU: tall-skinny QR in the run precision
    (reference-faithful), as in the JAX package."""
    if torch.device(device).type == "cpu":
        return {"ls_dtype": None, "ls_method": "qr"}
    return {"ls_dtype": None, "ls_method": "normal"}


def make_problem(cfg):
    """(grid, w0): the grid of `cfg` and the uniform initial state, a
    float64 host array as in the JAX runners."""
    grid = grid_from_config(cfg)
    w0 = np.ones(grid.state_dim)
    return grid, w0


def default_config(num_cells: int | None = None,
                   num_steps: int | None = None):
    cfg = DEFAULT_CONFIG
    if num_cells:
        cfg = cfg.with_cells(num_cells)
    if num_steps:
        cfg = dataclasses.replace(cfg, num_steps=num_steps)
    return cfg


def res_path(cfg, path: str) -> str:
    """Per-resolution artifact filename: 'x.npy' -> 'x_50x50.npy' at
    non-default resolutions, so a 12^2 model or weight file never
    shadows the 250^2 one (BurgersConfig.res_suffix)."""
    stem, ext = os.path.splitext(path)
    return f"{stem}{cfg.res_suffix}{ext}"


def get_or_build_basis(cfg, grid, w0, num_modes: int,
                       path: str = None, method: str = "rsvd",
                       load_basis: bool = True, device=None) -> np.ndarray:
    """basis.npy protocol (reference run_prom.py:44-120): load if present,
    else collect the 9 training trajectories, POD them, save the basis
    and its singular values. Non-default resolutions get their own file.

    The FOMs and the POD run on `device` (the CUDA device when None),
    whatever the size of the snapshot set: 9 x 501 x 125,000 float64
    values at 250^2 (4.5 GB) fit the card. Returns a float64 host array.
    """
    if path is None:
        path = res_path(cfg, "basis.npy")

    if load_basis and os.path.exists(path):
        full = np.load(path, allow_pickle=True)
        if full.shape[1] >= num_modes:
            return full[:, :num_modes]
        print(f"{path} has {full.shape[1]} modes < {num_modes}; rebuilding")

    device = resolve_device(device)
    w0 = torch.as_tensor(w0, device=device)
    snaps = collect_snapshots(cfg.mu_samples(), grid, w0, cfg.dt,
                              cfg.num_steps, snap_folder=cfg.snap_folder)
    t0 = time.time()
    snaps = torch.as_tensor(snaps, device=device)
    basis, sigma = pod(snaps, num_modes=num_modes, method=method,
                       random_state=cfg.seed)
    basis = to_host(basis)
    print(f"POD ({method}, {num_modes} modes): {time.time() - t0:.3e} s")
    del snaps
    np.save(path, basis)
    np.save(path.replace("basis", "sigma"), to_host(sigma))
    return basis


def report(name: str, rom_snaps, hdm_snaps, elapsed: float, mu,
           save_prefix: str | None = None):
    """Final error print + snapshot save, mirroring every reference
    runner's epilogue (e.g. run_prom.py:104-126)."""
    rom_snaps = to_host(rom_snaps)
    rel = relative_error_pct(rom_snaps, to_host(hdm_snaps))
    print(f"Elapsed {name} time: {elapsed:.3e} s")
    print(f"Relative error: {rel:.2f}%")
    if save_prefix:
        fn = f"{save_prefix}_snaps_mu1_{mu[0]:.2f}_mu2_{mu[1]:.3f}.npy"
        np.save(fn, rom_snaps)
        print(f"Snapshot saved as {fn}")
    return elapsed, rel


def warm_enabled() -> bool:
    """Warm-timing protocol: run the online solve once untimed, then time
    a second run. Toggled by the runners' --warm flag via FDTPU_WARM,
    shared with the JAX runners, so drivers can set it uniformly across
    subprocesses."""
    return os.environ.get("FDTPU_WARM", "") == "1"


def split_training(cfg, grid, w0, num_total: int, num_primary: int,
                   num_secondary: int | None = None, basis_path=None,
                   max_pairs: int = 1500, qcoords_dir: str | None = None,
                   device=None):
    """POD split + projected training pairs for all closure ROMs.

    Returns (u_p, u_s, q_p, q_s) as host float64 arrays: the primary and
    secondary POD blocks and the (n_samples, n_p) / (n_samples, n_s)
    regression pairs from the 9 training trajectories (their FOMs and the
    basis run on `device`, the card when None).

    qcoords_dir: a directory of pre-projected (num_steps+1, num_total)
    coordinate files (*.npz with key "q"; files named test_* are
    skipped), the mu-densified training set: the pairs then come from
    every file there, subsampled per trajectory so that max_pairs spreads
    evenly, and the basis stays the on-disk one they were projected on.

    Pairs beyond `max_pairs` are stride-subsampled: kernel fits are cubic
    in the pair count, and ~1.5k well-spread points along the
    trajectories saturate the interpolation's accuracy.
    """
    from finitedifference_tpu_torch.training.rnm_train import (
        project_snapshots,
    )

    device = resolve_device(device)
    basis = get_or_build_basis(cfg, grid, w0, num_total, path=basis_path,
                               device=device)
    u_p, u_s = split_basis(basis, num_primary, num_secondary)
    if qcoords_dir:
        import glob

        files = sorted(
            f for f in glob.glob(os.path.join(qcoords_dir, "*.npz"))
            if not os.path.basename(f).startswith("test_"))
        if not files:
            raise FileNotFoundError(
                f"--qcoords-dir {qcoords_dir}: no training *.npz "
                f"coordinate files")
        per_traj = max(1, (max_pairs or 10 ** 9) // len(files))
        qs = []
        for f in files:
            q = np.load(f)["q"][:, :num_total]
            stride = max(1, -(-q.shape[0] // per_traj))
            qs.append(q[::stride])
        q = np.concatenate(qs, axis=0)
        n_s = (num_total - num_primary if num_secondary is None
               else num_secondary)
        q_p, q_s = q[:, :num_primary], q[:, num_primary:
                                         num_primary + n_s]
        return np.asarray(u_p), np.asarray(u_s), q_p, q_s
    snaps = collect_snapshots(cfg.mu_samples(), grid,
                              torch.as_tensor(w0, device=device), cfg.dt,
                              cfg.num_steps, snap_folder=cfg.snap_folder)
    q_p, q_s = project_snapshots(basis, snaps.T, num_primary,
                                 num_secondary)
    if max_pairs and q_p.shape[0] > max_pairs:
        stride = -(-q_p.shape[0] // max_pairs)
        q_p, q_s = q_p[::stride], q_s[::stride]
    return np.asarray(u_p), np.asarray(u_s), q_p, q_s


def run_manifold(cfg, grid, w0, u_p, u_s, closure, mu1=None, mu2=None, *,
                 f32=False, weights_full=None, label="ROM",
                 save_prefix=None, warm_q1=None, device=None):
    """Online manifold-ROM run (full or hyper-reduced) + report.

    The state is float64 unless `f32` (the closure cores keep the model's
    dtype through their precision bridge), on `device` (the card when
    None); the Gauss-Newton least squares follow default_ls(device).

    warm_q1: optional projected coordinates of a training trajectory at
    t=1, used as the state after the first step (the reference's POD-RBF
    and POD-GP steppers overwrite their step-0 Gauss-Newton result with
    them, hypernet2D.py:1100-1102): every trajectory starts from the same
    w0=1 whatever mu, so the training trajectory's first step is a
    faithful warm start.

    Returns (elapsed, rel): the online seconds and the error in percent
    against the FOM at (mu1, mu2).
    """
    from finitedifference_tpu_torch.closures.common import (
        manifold_decoder,
        manifold_decoder_fused,
    )
    from finitedifference_tpu_torch.ops.sampled import (
        augmented_state_indices,
        build_sampled_mesh,
    )
    from finitedifference_tpu_torch.rom import make_manifold_stepper

    device = resolve_device(device)
    dtype = torch.float32 if f32 else torch.float64

    u_p_d = torch.as_tensor(u_p, dtype=dtype, device=device)
    u_s_d = torch.as_tensor(u_s, dtype=dtype, device=device)
    decode_full, dec_jac_full = manifold_decoder(u_p_d, u_s_d, closure)
    y0 = torch.as_tensor(np.asarray(u_p).T @ w0, dtype=dtype,
                         device=device)
    num_steps = cfg.num_steps
    y_start = y0
    if warm_q1 is not None:
        y_start = torch.as_tensor(warm_q1, dtype=dtype, device=device)
        num_steps = cfg.num_steps - 1

    ls_kw = default_ls(device)
    if weights_full is None:
        decode, dec_jac = decode_full, dec_jac_full
        fused = manifold_decoder_fused(u_p_d, u_s_d, closure)
        mesh = sample_weights = None
    else:
        sample_inds = np.where(weights_full != 0)[0]
        mesh = build_sampled_mesh(grid, sample_inds, device=device)
        idx = augmented_state_indices(mesh, grid.n_cells)
        decode, dec_jac = manifold_decoder(u_p_d[idx], u_s_d[idx], closure)
        fused = manifold_decoder_fused(u_p_d[idx], u_s_d[idx], closure)
        sample_weights = torch.as_tensor(weights_full[sample_inds],
                                         dtype=dtype, device=device)
    run = make_manifold_stepper(grid, decode, dec_jac, cfg.dt, num_steps,
                                dtype=dtype, mesh=mesh,
                                sample_weights=sample_weights,
                                decode_and_jac=fused, **ls_kw)
    w0_d = torch.as_tensor(w0, device=device)

    def solve():
        red_d, its = run(y_start, mu1, mu2)
        return red_d.cpu(), its

    # timed to the reduced coordinates on the host; the full-state
    # reconstruction below stays outside the timer
    if warm_enabled():
        solve()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    red_h, total_its = solve()
    elapsed = time.time() - t0

    red = red_h.to(device)
    if warm_q1 is not None:
        red = torch.cat((y0[:, None], red), dim=1)
    rom_snaps = torch.func.vmap(decode_full, in_dims=1, out_dims=1)(red)
    print(f"Total GN iterations: {int(total_its)}")

    hdm = load_or_compute_snaps([mu1, mu2], grid, w0_d, cfg.dt,
                                cfg.num_steps, snap_folder=cfg.snap_folder)
    return report(label, rom_snaps, hdm, elapsed, (mu1, mu2),
                  save_prefix=save_prefix)


def closure_ecsw_weights(cfg, grid, w0, u_p, u_s, closure, *,
                         weights_path, method="nnls", bc_w=10.0,
                         mu_train=(4.25, 0.0225), compute=False,
                         device=None):
    """Compute-or-load ECSW weights for a nonlinear-closure ROM (reference
    compute_ECSW_training_matrix_2D_{rnm,rbf_*,gp} + the runners' NNLS /
    ECM recipes).

    mu_train: the (mu1, mu2) of the one training trajectory (the
    reference's recipe), every 10th snapshot of which gives a block of
    rows. The training matrix is built on `device` (the card when None),
    each snapshot's coordinates fitted by solvers.fit_reduced_coords; the
    weights are solved by ecsw.compute_ecsw_weights and saved.
    """
    from finitedifference_tpu_torch.closures.common import manifold_decoder
    from finitedifference_tpu_torch.ecsw import (
        compute_ecsw_weights,
        ecsw_training_matrix_closure,
    )
    from finitedifference_tpu_torch.solvers import fit_reduced_coords

    if not compute and os.path.exists(weights_path):
        return np.load(weights_path)

    device = resolve_device(device)
    u_p_d = torch.as_tensor(u_p, device=device)
    decode, dec_jac = manifold_decoder(
        u_p_d, torch.as_tensor(u_s, device=device), closure)
    u_p_t = u_p_d.T

    def fit_y0(snap):
        """Projection start + the reference's inner Gauss-Newton fit of q
        to the snapshot through the decoder (hypernet2D.py:2765-2773)."""
        return fit_reduced_coords(decode, dec_jac, u_p_t @ snap, snap).y

    m1, m2 = mu_train
    t = cfg.num_steps
    snaps = load_or_compute_snaps([m1, m2], grid,
                                  torch.as_tensor(w0, device=device),
                                  cfg.dt, cfg.num_steps,
                                  snap_folder=cfg.snap_folder)
    snaps = torch.as_tensor(snaps, device=device)
    t0 = time.time()
    c = ecsw_training_matrix_closure(
        grid, snaps[:, 3:t:10], snaps[:, 0:t - 3:10],
        decode, dec_jac, fit_y0, m1, m2, cfg.dt)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.time() - t0
    del snaps
    print(f"closure training matrix {tuple(c.shape)}: {build_s:.2f}s")
    t0 = time.time()
    weights = compute_ecsw_weights(c, grid, bc_w=bc_w, method=method,
                                   rel_err_thresh=1e-4)
    print(f"weight solve time: {time.time() - t0:.2f}s")
    np.save(weights_path, weights)
    return weights


def base_parser(desc: str) -> argparse.ArgumentParser:
    """The JAX runners' common flags, with --device in place of
    --platform."""
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--mu1", type=float, default=5.19)
    p.add_argument("--mu2", type=float, default=0.026)
    p.add_argument("--num-cells", type=int, default=None)
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--f32", action="store_true",
                   help="run the online state in float32")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default: the CUDA device; fails "
                        "at once without one)")

    class _SetWarm(argparse.Action):
        def __call__(self, parser, ns, values, option_string=None):
            os.environ["FDTPU_WARM"] = "1"
            setattr(ns, self.dest, True)

    p.add_argument("--warm", nargs=0, default=False, action=_SetWarm,
                   help="warm-timing protocol: run once untimed, report "
                        "the second run's time")
    return p
