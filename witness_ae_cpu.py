#!/usr/bin/env python3
"""The AE-LSPG witnesses on the CPU: the JAX package's trainer and ROM
and the port's on one network.

    JAX_PLATFORMS=cpu python3 witness_ae_cpu.py [DIR]
    JAX_PLATFORMS=cpu python3 witness_ae_cpu.py --wide
    JAX_PLATFORMS=cpu python3 witness_ae_cpu.py --wide-epoch [DIR]

In DIR (a new temporary directory by default; an earlier run's is
reused), as scripts/record_ae_rows.py runs it: the JAX runner at 50^2,
500 steps, latent 10 and (5.19, 0.026) trains the autoencoder with the
runner's recipe (300 epochs, patience 50) unless DIR holds its
ae_model_50x50.msgpack, then runs (4.75, 0.02) on the checkpoint (the
load path: float64 state, float32 network). That network is carried
into the port (convert.ae_from_flax, saved as the port's
ae_model_50x50.pt) and the port's runner runs (4.75, 0.02) on the CPU in
DIR/port, on a copy of the JAX snapshot cache. Prints both errors, both
GN totals and the two trajectories' relative difference.

--wide: the same comparison at 250^2 (input width 125,000, the JAX
runner's default, 128.5 M parameters) on a row subset. The rows are the
first WIDE_ROWS steps of the port's 250^2 FOM at (4.75, 0.02),
standardised as train_autoencoder does; the network is Flax's
initialisation at the runner's seed, carried into the port. Both
trainers run WIDE_PARITY epochs of the runner's recipe (batch 16, Adam
at 1e-3) from JAX's epoch permutations, in float64 and then in float32:
each epoch's mean loss, the parameters after it and _eval_loss on the
held-out rows are compared. JAX's float32 trainer then goes on alone for
WIDE_EPOCHS epochs, the network is carried across again, and both
manifold ROMs (truncated-SVD least squares with the line search, as
run_ae_prom calls them) run WIDE_STEPS steps at (4.75, 0.02) on the
float64 state of the load path and on the float32 state of the retrain
path: GN totals and trajectories are compared. ~4 minutes, peak memory
~6 GB.

--wide-epoch: the first epoch of both trainers on the runner's whole
250^2 training set (the port's 9 training FOMs, computed on the CPU and
cached in DIR/param_snaps; 4,058 training rows, 253 steps), from one
Flax initialisation and JAX's permutation, beside the first epoch of the
JAX sidecar ae_model.msgpack.json. ~25 minutes for the FOMs, ~8 for the
epochs, peak memory ~14 GB.
"""

import contextlib
import io
import json
import os
import re
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N, MU_TRAIN, MU = 50, (5.19, 0.026), (4.75, 0.02)
SNAPS = f"param_snaps_{N}x{N}"
JMODEL = f"ae_model_{N}x{N}.msgpack"
TMODEL = f"ae_model_{N}x{N}.pt"
TRAJ = "ae_prom_snaps_mu1_4.75_mu2_0.020.npy"
WIDE_N, WIDE_ROWS, WIDE_TRAIN, WIDE_PARITY, WIDE_EPOCHS, WIDE_STEPS = (
    250, 96, 80, 2, 30, 10)


def run(main, *args, **kw):
    """main(*args, **kw), its stdout echoed and kept: (err %, GN total)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, err = main(*args, **kw)
    out = buf.getvalue()
    print(out, end="")
    return err, int(re.findall(r"Total GN iterations: (\d+)", out)[-1])


def main():
    import flax.serialization
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.join(ROOT, "runners"))
    os.environ.setdefault("FDTPU_PLATFORM", "cpu")
    import run_ae_prom as jrun

    from finitedifference_tpu.closures.autoencoder import init_autoencoder
    from finitedifference_tpu_torch import convert
    from finitedifference_tpu_torch.runners import run_ae_prom as trun
    from finitedifference_tpu_torch.training.monitor import TrainingMonitor

    work = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="ae_witness_")
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    if not os.path.exists(JMODEL):
        err, gn = run(jrun.main, *MU_TRAIN, num_cells=N)
        print(f"[witness] JAX run_ae_prom at {MU_TRAIN}, trained here "
              f"(float32 state): error {err:.4f}%, {gn} GN its")
    j_err, j_gn = run(jrun.main, *MU, num_cells=N)
    j_traj = np.load(TRAJ)
    _, template = init_autoencoder(2 * N * N, 10)
    with open(JMODEL, "rb") as f:
        params = flax.serialization.from_bytes(template, f.read())
    shutil.rmtree("port", ignore_errors=True)
    os.makedirs("port")
    shutil.copytree(SNAPS, os.path.join("port", SNAPS))
    os.chdir("port")
    TrainingMonitor(TMODEL, 1).save_checkpoint(convert.ae_from_flax(
        params, np.zeros(1), np.ones(1), device="cpu").module)
    t_err, t_gn = run(trun.main, *MU, num_cells=N, device="cpu")
    t_traj = np.load(TRAJ)
    rel = np.linalg.norm(t_traj - j_traj) / np.linalg.norm(j_traj)
    print(f"[witness] {N}x{N} 500 steps at {MU}, the JAX-trained float32 "
          f"network, float64 state: JAX {j_err:.4f}% ({j_gn} GN its), port "
          f"{t_err:.4f}% ({t_gn} GN its); trajectories rel {rel:.3e} "
          f"(in {work})")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _wide_setup():
    """The 250^2 problem, the JAX and port modules the wide modes use."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from finitedifference_tpu_torch.runners.common import (
        default_config,
        make_problem,
    )

    cfg = default_config(WIDE_N)
    grid, w0 = make_problem(cfg)
    return cfg, grid, w0


def _epoch_pair(module, params, opt, ostate, port, pstate, x_tr, x_va, mu,
                sig, sub, bs=16):
    """One epoch of each trainer from the same parameters and JAX's
    permutation of sub: (params, ostate, pstate, JAX loss, port loss, JAX
    _eval_loss, port _eval_loss, parameters rel, JAX s, port s)."""
    import time

    import jax
    import jax.numpy as jnp
    import torch

    from finitedifference_tpu.training import ae_train as jtrain
    from finitedifference_tpu_torch import convert
    from finitedifference_tpu_torch.training import ae_train as ttrain
    from finitedifference_tpu_torch.training import minibatch

    n = x_tr.shape[0]
    nb = n // bs
    jmu, jsig = jnp.asarray(mu), jnp.asarray(sig)
    tmu, tsig = torch.as_tensor(mu), torch.as_tensor(sig)
    t0 = time.time()
    params, ostate, jloss = jtrain._train_epoch(
        module, opt, params, ostate, jnp.asarray(x_tr), jmu, jsig, sub, bs)
    jloss = float(jloss)
    tj = time.time() - t0
    order = np.asarray(jax.random.permutation(sub, n))[:nb * bs]
    t0 = time.time()
    pstate, ploss = ttrain._train_epoch(
        port.module, pstate, torch.as_tensor(x_tr), tmu, tsig,
        torch.as_tensor(order.copy()), bs)
    tp = time.time() - t0
    carried = convert.ae_from_flax(params, mu, sig, device="cpu")
    prel = rel(minibatch.flat_params(port.module)[0],
               minibatch.flat_params(carried.module)[0])
    jval = float(jtrain._eval_loss(module, params, jnp.asarray(x_va), jmu,
                                   jsig))
    pval = float(ttrain._eval_loss(port.module, torch.as_tensor(x_va), tmu,
                                   tsig))
    return (params, ostate, pstate, jloss, float(ploss), jval, pval, prel,
            tj, tp)


def _flax_init(dim, seed, dtype):
    import jax

    from finitedifference_tpu.closures import autoencoder as jae

    module, params = jae.init_autoencoder(dim, 10,
                                          key=jax.random.PRNGKey(seed))
    return module, jax.tree_util.tree_map(lambda a: a.astype(dtype), params)


def wide():
    import time

    import jax
    import jax.numpy as jnp
    import optax
    import torch

    cfg, grid, w0 = _wide_setup()
    from finitedifference_tpu.closures import autoencoder as jae
    from finitedifference_tpu.config import DEFAULT_CONFIG
    from finitedifference_tpu.grid import grid_from_config
    from finitedifference_tpu.rom import manifold_rom as jrom
    from finitedifference_tpu.training import ae_train as jtrain
    from finitedifference_tpu_torch import convert
    from finitedifference_tpu_torch import fom as tfom
    from finitedifference_tpu_torch.closures import autoencoder as tae
    from finitedifference_tpu_torch.rom import manifold_rom as trom
    from finitedifference_tpu_torch.training import minibatch

    jgrid = grid_from_config(DEFAULT_CONFIG.with_cells(WIDE_N))
    t0 = time.time()
    rows = tfom.inviscid_burgers_implicit2d(
        grid, torch.as_tensor(w0), cfg.dt, WIDE_ROWS, *MU).snaps.T.numpy()
    print(f"[wide] {rows.shape[0]} FOM rows of width {rows.shape[1]} in "
          f"{time.time() - t0:.1f} s")
    perm = np.random.default_rng(cfg.seed).permutation(rows.shape[0])
    opt = optax.adam(1e-3)
    for dtype in (np.float64, np.float32):
        x = rows.astype(dtype)
        mu, sig = x.mean(axis=0), x.std(axis=0) + 1e-10
        x_tr, x_va = x[perm[:WIDE_TRAIN]], x[perm[WIDE_TRAIN:]]
        module, params = _flax_init(x.shape[1], cfg.seed, dtype)
        ostate = opt.init(params)
        port = convert.ae_from_flax(params, mu, sig, device="cpu")
        pstate = minibatch.adam_init_flat(port.module)
        key = jax.random.PRNGKey(cfg.seed + 1)
        for epoch in range(WIDE_PARITY):
            key, sub = jax.random.split(key)
            (params, ostate, pstate, jloss, ploss, jval, pval, prel, tj,
             tp) = _epoch_pair(module, params, opt, ostate, port, pstate,
                               x_tr, x_va, mu, sig, sub)
            print(f"[wide] {np.dtype(dtype).name} epoch {epoch} "
                  f"({WIDE_TRAIN // 16} steps; JAX {tj:.1f} s, port "
                  f"{tp:.1f} s): loss JAX {jloss:.9e} port {ploss:.9e}; "
                  f"parameters rel {prel:.2e}; _eval_loss JAX {jval:.9e} "
                  f"port {pval:.9e}")
        del port, pstate
    jx, jmu, jsig = jnp.asarray(x_tr), jnp.asarray(mu), jnp.asarray(sig)
    for epoch in range(WIDE_EPOCHS):
        key, sub = jax.random.split(key)
        params, ostate, jloss = jtrain._train_epoch(
            module, opt, params, ostate, jx, jmu, jsig, sub, 16)
    print(f"[wide] JAX's float32 trainer alone to epoch "
          f"{WIDE_PARITY + WIDE_EPOCHS}: loss {float(jloss):.3e}")

    for state_dtype, stats in (("float64", rows), ("float32", x)):
        smu = stats.mean(axis=0)
        ssig = stats.std(axis=0) + 1e-10
        jae_ = jae.ScaledAE(module=module, params=params,
                            mu_in=jnp.asarray(smu), sig_in=jnp.asarray(ssig))
        jdec, jjac, jenc = jae.ae_decoder_fns(jae_)
        t0 = time.time()
        jres = jrom(jgrid, jenc(jnp.asarray(w0, smu.dtype)), jdec, jjac,
                    cfg.dt, WIDE_STEPS, *MU, ls_method="svd",
                    line_search=True)
        jred = np.asarray(jres.red_coords)
        tj = time.time() - t0
        pae = convert.ae_from_flax(params, smu, ssig, device="cpu")
        pdec, pjac, penc = tae.ae_decoder_fns(pae)
        t0 = time.time()
        pres = trom(grid, penc(torch.as_tensor(w0, dtype=pae.mu_in.dtype)),
                    pdec, pjac, cfg.dt, WIDE_STEPS, *MU, ls_method="svd",
                    line_search=True)
        tp = time.time() - t0
        pred = pres.red_coords.numpy()
        wj = np.asarray(jax.vmap(jdec, in_axes=1, out_axes=1)(jres.red_coords))
        wp = pdec(pres.red_coords).numpy()
        print(f"[wide] {WIDE_N}x{WIDE_N} ROM, {WIDE_STEPS} steps at {MU}, "
              f"{state_dtype} state ({jred.dtype} / {pred.dtype}; JAX "
              f"{tj:.1f} s, port {tp:.1f} s): GN its JAX "
              f"{int(jres.total_gn_its)} port {pres.total_gn_its}; reduced "
              f"coordinates rel {rel(pred, jred):.2e}, states rel "
              f"{rel(wp, wj):.2e}; error against the FOM rows JAX "
              f"{100 * rel(wj, rows[:WIDE_STEPS + 1].T):.4f}% port "
              f"{100 * rel(wp, rows[:WIDE_STEPS + 1].T):.4f}%")


def wide_epoch(work):
    """The first epoch of both trainers at 250^2 on the runner's whole
    training set, from one Flax initialisation and JAX's permutation,
    beside the JAX sidecar's first epoch."""
    import jax
    import optax
    import torch

    from finitedifference_tpu_torch import convert
    from finitedifference_tpu_torch.snapshots import collect_snapshots
    from finitedifference_tpu_torch.training import minibatch

    cfg, grid, w0 = _wide_setup()
    os.makedirs(work, exist_ok=True)
    x = np.asarray(collect_snapshots(
        cfg.mu_samples(), grid, torch.as_tensor(w0), cfg.dt, cfg.num_steps,
        snap_folder=os.path.join(work, "param_snaps")).T, np.float32)
    mu, sig = x.mean(axis=0), x.std(axis=0) + 1e-10
    perm = np.random.default_rng(cfg.seed).permutation(x.shape[0])
    n_train = int(cfg.train_frac * x.shape[0])
    x_tr, x_va = x[perm[:n_train]], x[perm[n_train:]]
    del x
    module, params = _flax_init(x_tr.shape[1], cfg.seed, np.float32)
    opt = optax.adam(1e-3)
    port = convert.ae_from_flax(params, mu, sig, device="cpu")
    _, key = jax.random.split(jax.random.PRNGKey(cfg.seed + 1))
    (_, _, _, jloss, ploss, jval, pval, prel, tj, tp) = _epoch_pair(
        module, params, opt, opt.init(params), port,
        minibatch.adam_init_flat(port.module), x_tr, x_va, mu, sig, key)
    side = json.load(open(os.path.join(ROOT, "ae_model.msgpack.json")))
    print(f"[wide-epoch] {WIDE_N}x{WIDE_N}, {x_tr.shape[0]} training and "
          f"{x_va.shape[0]} validation rows, epoch 0 of "
          f"{x_tr.shape[0] // 16} steps (JAX {tj:.1f} s, port {tp:.1f} s): "
          f"train loss JAX {jloss:.6e} port {ploss:.6e}, validation JAX "
          f"{jval:.6e} port {pval:.6e}, parameters rel {prel:.2e}; JAX "
          f"sidecar ae_model.msgpack.json epoch 0: train "
          f"{side['train_losses'][0]:.6e}, validation "
          f"{side['test_crits'][0]:.6e}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--wide"]:
        wide()
    elif sys.argv[1:2] == ["--wide-epoch"]:
        wide_epoch(sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp(
            prefix="ae_wide_"))
    else:
        main()
