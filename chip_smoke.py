#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (finitedifference_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py spatial    # [spatial] alone, every visible card

Phases, each printing its own lines:
1. environment: torch/CUDA versions, the card's name and power limit,
   TF32 off;
2. build the CUDA kernels from csrc/ (nvcc, at first use);
3. the wavefront kernel against its plain PyTorch version on the card,
   at the 750^2 main-path layout (1536, 768) and on layouts that stress
   the hand-off between its warps (ny far below and far above nx, warps
   that do not fill the cluster's CTAs evenly, more warps in a CTA than
   it has schedulers), in float32 and float64: error, exact zeros off
   the band, two runs bit-equal, and at the main layout both times (CUDA
   events, median of 3); then [residual] R1, the residual kernels of the
   skewed Newton loop (csrc/skewed_residual.cu), at the main-path
   layout, f32 and f64: a step's constant, an update and the
   extrapolated guess's residual against the eager expressions (fields
   bit-equal, norms within NORM_TOL, the same stop flag, two runs
   bit-equal), each kernel timed in turns with its eager composition
   beside the bound of its fields;
4. [entry] the entry step through the port's twin of
   __graft_entry__.entry (finitedifference_tpu_torch/entry.py): newton_step
   at 250^2 with a float32 state, max_its 20, on the card against the same
   step on the CPU, its B2 launches one a Newton iteration and no B1
   launch; then B2 (the solve on unskewed fields, one launch of
   csrc/wavefront.cu on the (ny, nx) fields in place) at that shape, f32
   and f64: error against its plain version, bit-equal to B1 between a
   skew and an unskew, two runs bit-equal, the times of B2, the
   composition and the plain version; the same checks but the times on
   UNSKEWED_SHAPES; then the
   standard engine (inviscid_burgers_implicit2d) at 250^2, float64, for
   STANDARD_STEPS steps: one B2 launch a Newton iteration, no B1 launch,
   snapshots within 1e-10 of the skewed engine's;
5. the main path: inviscid_burgers_implicit2d_skewed at 750^2 with a
   float64 state and float32 snapshots, (a) with float32 solves and
   (b) with float64 solves; 5 warm-up steps, then 3 runs of 100 steps:
   steps/s, Newton iterations per step, one B1 and one R1 launch per
   iteration and one R1 step constant per step;
6. a 64^2 float64 trajectory on the card against the CPU (R1 counted as
   in 5);
7. the Gauss-Newton system kernels against their plain PyTorch versions
   on the card, in float32 and float64: B3 (gn_full) at the 250^2 and
   750^2 95-mode layouts (two runs bit-equal) and at a 150 x 149, 40-mode
   layout whose chunks do not divide among the CTAs and whose k + 1 is
   no multiple of the lane granularity, B4 (gn_sampled_system) and B5
   (gn_sampled_step) at the 250^2 synthetic-mesh layout (1508 sampled
   cells, 95 modes): error, two runs bit-equal, the eager time launch to
   launch and the plain version's (CUDA events, median of 3), the device
   time a call from a CUDA graph of 50 calls, and one device kernel a
   call (torch.profiler); then B4 and B5 at 150 modes on 1000 cells,
   whose short last chunk and 63 chunks do not divide among the CTAs;
   then [b2-kernels] one device kernel a call of B2 at 250^2, f32 and f64
   (torch.profiler, after every other profiled phase);
8. the 250^2 ROM path: FOM snapshots at (4.25, 0.0225), a 95-mode rSVD
   POD basis, then 500 steps at (4.75, 0.02) of lspg_prom and
   pallas_prom, and on the bench.py mesh (512 interior cells and the
   boundary ring) ecsw_hprom, factored_hprom and pallas_hprom (normal,
   unroll 3 + cg for CUT_STEPS steps, unroll 3 + fused): steps/s (median
   of 3; the host-bound lspg_prom, ecsw_hprom, factored_hprom and unroll
   3 + cg SLOW_REPS runs), GN its/step,
   kernel launches (equal to the kernel calls), the difference against
   the generic engine of the family and the error against the FOM;
9. the 750^2 streaming PROM: a 95-mode basis from a 500-step 750^2 FOM
   trajectory, pallas_prom for 500 steps and lspg_prom for
   FINE_LSPG_STEPS (SLOW_REPS runs);
10. the ECSW offline recipe at 64^2: training matrix on the card, host
   NNLS (nnls_gram, rel_err_thresh 1e-4), prepare_hprom, then ecsw_hprom
   and pallas_hprom on the card against the same runs on the CPU;
11. [seg-kernel] the overlapping-segment wavefront kernel (B7) against its
   plain version at the 750^2 layout, n_seg 8, overlap 64, f32 and f64:
   error, zeros off the band, two runs bit-equal, difference from B1's
   exact solve, both kernels' times; then the same checks on SEG_LAYOUTS
   (ny_pad no multiple of a warp's rows, ny far below and above nx, n_seg
   not dividing nd_pad, overlap 0 and >= seg_len, trailing segments that
   own nothing, one segment within KERNEL_TOL of B1);
12. [main-seg] the 750^2 trajectory with seg=8, seg_overlap=64 (f32
   solves, f64 Newton, f32 snapshots): steps/s, Newton its/step, one B7
   and one R1 launch per Newton iteration, one R1 step constant per
   step, final state against the exact chain;
13. [traj-kernel] the whole-trajectory kernel (B6) against its plain
   version on the 250^2 bench mesh layout (6, 1536, 128), 50 steps, 1
   and 9 trajectories, f32 and f64: error, two runs bit-equal, the b = 1
   run bit-equal to its row of the b = 9 launch, and both times (the plain
   version's, seconds long, from the one run compared); then k = 150 in
   f32 on a layout whose 7 chunks do not divide among the cluster's CTAs;
14. [rom] pallas_traj_hprom (one launch for 500 steps) and tensor_hprom on
   the bench mesh, against ecsw_hprom and the FOM, and tensor_hprom
   against ecsw_hprom once more in float64;
15. [sweep] the 9-point μ grid of bench.py at 250^2: sweep_hprom
   pallas_traj (one launch for all 9 points) for 500 steps, generic and
   factored for CUT_STEPS, each point held against its own run, and
   sweep_fom(engine="skewed", seg=8) for 100 steps: aggregate steps/s,
   one R1 launch per B7 launch and one step constant per step.
16. [spatial] the multi-rank paths: run_fom --spatial-shard over one NCCL
   rank a card at 750^2 for SPATIAL_NCCL_STEPS steps, its snapshots
   against the unsharded skewed engine (B1) in float64; with more than
   one card, run_sweep's card mesh against one card, bit for bit, and
   entry.dryrun_multichip over NCCL, one rank a card; two gloo ranks
   (sharing card 0 on one card), their halos staged through the host:
   sharded_skewed_fom at 750^2, float64, SPATIAL_STEPS steps (within
   SPATIAL_TOL of B1's unsharded engine, equal Newton counts; ms a step
   and an exchange), the
   skewed sweep_fom of SPATIAL_SWEEP_MUS at 250^2 over a dp mesh, and the
   9-point sweep_hprom pallas_traj on [rom]'s bench mesh over the dp mesh,
   each row bit-equal to the unsharded launch, every rank's B1 and B6
   launch counts read back (each > 0, counted in the kernels line); then
   entry.dryrun_multichip(4) over four gloo ranks (dp 2 x sp 2, each
   phase against its unsharded twin).
17. [weights] the other weight methods at 64^2 on phase 10's training
   matrix: compute_ecsw_weights(method="ecm") (rank-800 sketch on the
   card, cubature on the host), multilevel_nnls_weights (FISTA screening
   on the card), sequential_nnls_weights, and lawson_hanson_weights_device
   on a float32 training matrix built on the card: N_e, the training
   residual (each must reach 1e-4) and the time;
18. [runners] the users' workflow through the runner main()s at 250^2 and
   the runners' defaults in a fresh temporary directory: run_fom at (5.19,
   0.026), run_prom --engine generic (building the 9-trajectory basis)
   then pallas, run_hprom --compute-ecsw --weights-method nnls --engine
   generic then pallas (on the saved weights), run_sweep --model hprom
   over the 3x3 grid for CUT_STEPS steps: wall time, steps/s, Newton / GN
   iterations, N_e, the weight solve time and the error against the FOM
   beside the JAX package's records; B1 launched in run_fom and the basis
   build, B3 in run_prom pallas, B4 in run_hprom pallas; the PROM error
   under 2%, the HPROM's under 3%, each kernel engine within ENGINE_TOL of
   its generic engine.
19. [closures] the POD-RBF closure ROMs through the runner main()s at
   250^2, 500 steps, (5.19, 0.026) and 10 + 140 modes in a fresh
   temporary directory: run_pod_rbf_global (the 150-mode basis from the 9
   training FOMs through B1, the (epsilon x kernel) grid-search fit on the
   card, 499 online steps after the warm_q1 re-seed), run_pod_rbf_hprom
   --compute-ecsw (global variant, nnls, bc_w 10), run_pod_rbf (kNN,
   epsilon 0.01, k 100; then again with --f32) and run_pod_rbf_hprom
   --variant knn --compute-ecsw (then again with --f32 on its weights):
   wall time, online steps/s, GN iterations, the error against the FOM
   beside the JAX package's record, the fit's time and choice, N_e and
   the times of the closure training matrix and the NNLS, the B1
   launches; each error finite and, but for the kNN HPROM's two witness
   runs, under twice the JAX record (CLOSURE_LIMIT).
20. [gp] in [closures]' directory, on its basis and snapshot cache:
   run_pod_gp_hprom --compute-ecsw (the shared-kernel ARD GP, noise 1e-6)
   and --retrain --per-mode full --compute-ecsw (one ARD GP per secondary
   mode): the GP fit's time, amplitudes and length scales, N_e, the
   training matrix's and the NNLS's times, online steps/s, GN its, the
   error under twice the JAX record (GP_LIMIT); then run_pod_rbf_global
   --search cv, bayesian, aniso and svr: the fit's time and choice, the
   PROM error (finite; no JAX record at 250^2).
21. [rnm] in the same directory, on its basis and snapshot cache: run_rnm
   --retrain at (4.75, 0.02) on all 4,509 projected pairs for RNM_EPOCHS
   of the recipe's 5000 epochs (batch 16), then run_hrnm --compute-ecsw at
   (5.19, 0.026) on the checkpoint it saved: the seconds an epoch, the
   first and last validation loss printed, the sidecar's best epoch, N_e,
   the training matrix's and the NNLS's times, online steps/s, GN its, the
   error against the FOM beside the JAX package's 3932-epoch records
   (finite; the validation loss must fall); then sweep_manifold of the
   trained closure over the three canonical points for CUT_STEPS steps,
   each row within RNM_SWEEP_TOL of a lone manifold_rom at its point.
22. [ae] AE-LSPG through run_ae_prom at 50^2, 500 steps, latent 10 in a
   fresh temporary directory, in the order of the JAX package's records
   (scripts/record_ae_rows.py): at (5.19, 0.026) it trains the
   autoencoder (the 9 training FOMs through B1, the recipe's 300 epochs
   with patience 50, each minibatch step a CUDA graph replay) and steps a
   float32 state; at (4.56, 0.019) and (4.75, 0.02) it loads the
   checkpoint and steps a float64 state: seconds an epoch, epochs run, the
   validation loss falling and its best beside JAX's sidecar, the state's
   dtype, online steps/s, GN iterations, the B1 launches of the 12 FOMs,
   each error under twice the JAX record (AE_LIMIT).
23. [drivers] in [ae]'s directory, on its 50^2 FOM cache, at the
   DRIVER_POINTS of the three test points: run_tests --models prom (a FOM
   and a PROM a point, each a runner process on the card) and again,
   skipping every key; run_tests_hprom --models hprom; every point with
   no retry, so that a failed point fails the phase; then
   check_derivatives on the card, every verdict OK.
Each main path runs with the kernels' counts set to 0 just before it and
read just after (in each rank's process for [spatial]); it fails if a
kernel of the path was not launched.

Then one JSON line on the seven kernels and R1's two (B2's launches are
the entry step's, beside those of the standard engine's run; B1's every
other path's; R1's those of 5, 6, 12 and 15; with each kernel's bound:
the larger
of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s in f32 or
34 TFLOP/s in f64, the H100 SXM data sheet's rates), the card line, and
last {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device the script fails at once and prints no
result.
"""

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from finitedifference_tpu_torch import rom_factored as rf
from finitedifference_tpu_torch import rom_tensor as rt
from finitedifference_tpu_torch.config import TEST_POINTS, BurgersConfig
from finitedifference_tpu_torch.ecsw import (
    compute_ecsw_weights,
    ecsw_training_matrix,
    ecsw_training_matrix_device,
    interior_mask,
    lawson_hanson_weights_device,
    multilevel_nnls_weights,
    sequential_nnls_weights,
)
from finitedifference_tpu_torch.fom import (
    inviscid_burgers_implicit2d_skewed,
    newton_step,
)
from finitedifference_tpu_torch.grid import Grid2D, grid_from_config
from finitedifference_tpu_torch.ops import _build, gn
from finitedifference_tpu_torch.ops import cuda_gn as cg
from finitedifference_tpu_torch.ops import cuda_gn_full as cgf
from finitedifference_tpu_torch.ops import cuda_skewed as cr
from finitedifference_tpu_torch.ops import cuda_wavefront as cw
from finitedifference_tpu_torch.ops import gn_full as gf
from finitedifference_tpu_torch.ops import skewed as sk
from finitedifference_tpu_torch.parallel.sweep import sweep_fom, sweep_hprom
from finitedifference_tpu_torch.pod import pod
from finitedifference_tpu_torch.precision import precision_flags
from finitedifference_tpu_torch.rom import (
    ecsw_hprom,
    lspg_prom,
    prepare_hprom,
)

DT = 0.05
MU = (4.75, 0.02)
MAIN_N = 750
WARM_STEPS = 5
MEAS_STEPS = 100
REPS = 3
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
F32, F64 = torch.float32, torch.float64
# R1's norms against torch.sum's: both sum in the working type, in other
# orders (its fields are the eager expressions' bits)
NORM_TOL = {F32: 1e-6, F64: 1e-13}
DEVICE = "cuda"

# the reduced models (bench.py rom_metrics / fine_rom_metrics)
ROM_N = 250
FINE_N = 750
RECIPE_N = 64
MODES = 95
ROM_STEPS = 500
FINE_LSPG_STEPS = 20
MU_TRAIN = (4.25, 0.0225)
MESH_INTERIOR = 512        # bench.py:424-431: random interior cells
RING_WEIGHT = 50.0         # and the boundary ring at the fixed weight
SNAP_STRIDE = 10           # runners/run_hprom.py:56-59
# kernel vs plain: both sum the same rows' partial Grams in the working
# type, over different chunks and orders, then reduce in float64
GN_TOL = {F32: 5e-5, F64: 1e-12}
# engines of one family on the same f32 problem: the same equations,
# solved with different rounding, over 500 steps
ENGINE_TOL = 1e-2
GN_KERNELS = ("gn_full", "gn_sampled_system", "gn_sampled_step", "gn_traj")

# the segmented solve and the μ sweeps (bench.py:168-200, 549-551)
SEG = 8
SEG_OVERLAP = 64
TRAJ_STEPS = 50
SWEEP_MUS = [(m1, m2) for m1 in (4.4, 4.9, 5.4) for m2 in (0.016, 0.022,
                                                           0.028)]
SWEEP_FOM_STEPS = 100
# [spatial]: the multi-rank paths. One NCCL rank a card runs run_fom
# --spatial-shard at 750^2; two gloo ranks share card 0 for the sharded
# skewed trajectory (float64, against B1's unsharded engine), the FOM
# sweep and the whole-trajectory sweep; four gloo ranks run
# entry.dryrun_multichip(4)
SPATIAL_N = 750
SPATIAL_STEPS = 3
SPATIAL_NCCL_STEPS = 2
SPATIAL_TOL = 1e-12
SPATIAL_SWEEP_MUS = SWEEP_MUS[:2]
SPATIAL_SWEEP_STEPS = 20
SPATIAL_GLOO_RANKS = 2
SPATIAL_DRYRUN_RANKS = 4
SPATIAL_TIMEOUT = 300.0

# the users' workflow through the runners (README): 250^2, the runners'
# defaults, at the first canonical test point; the JAX package's records
# there, from runs on a TPU v5e (RESULTS.md:125-126,171), printed beside
# the port's numbers, and the limits the port's errors must stay under
RUNNER_N = 250
RUNNER_STEPS = 500
RUNNER_MU = (5.19, 0.026)
RUNNER_ROM_FILE = "rom_snaps_mu1_5.19_mu2_0.026.npy"
RUNNER_HPROM_FILE = "hprom_snaps_mu1_5.19_mu2_0.026.npy"
JAX_RECORD = {"prom": 1.02, "hprom": 1.20, "n_e": 2016}
PROM_LIMIT = 2.0           # percent
HPROM_LIMIT = 3.0
# every weight method's stopping target at 64^2: the recipe's 1e-4
WEIGHT_TARGET = 1e-4
# [closures]: the runners' defaults; the JAX package's records at (5.19,
# 0.026) (RESULTS.md: POD-RBF global 2.03%, its HPROM 3.27%, kNN with
# eps 0.01 and k 100 5.72%); a run fails above twice the record. The kNN
# PROM runs twice: with the float64 state, then with --f32, whose error
# shows how much of the gap to the JAX record (taken with a float32
# online state) the state's precision accounts for. The kNN HPROM (record
# rom_results_hprom.npz key pod_rbf_hprom_knn_5.19_0.026) runs as a
# witness, with the float64 and the float32 state: at eps 0.01 its local
# systems have a condition number near 1e10, and its error moves with the
# rounding of its inputs (PERF.md §7: 11.99% with a float64 state, 5.23%
# with float32, on the card and on the CPU alike; the port's run equals
# the JAX package's at 12^2, tests/test_torch_runners_closures.py), so
# its error is printed beside the record and must be finite, with no
# limit
CLOSURE_RECORD = {"global": 2.03, "hprom": 3.27, "knn": 5.72,
                  "knn_f32": 5.72, "hprom_knn": 4.301,
                  "hprom_knn_f32": 4.301}
CLOSURE_WITNESS = ("hprom_knn", "hprom_knn_f32")
CLOSURE_LIMIT = {key: 2 * rec for key, rec in CLOSURE_RECORD.items()
                 if key not in CLOSURE_WITNESS}
# [gp]: the POD-GP HPROM at the runners' defaults (noise 1e-6, NNLS, ring
# 10), the JAX package's records (rom_results_hprom.npz keys
# pod_gp_hprom_5.19_0.026 and pod_gp_hprom_pm_5.19_0.026), and the
# global-RBF searches, which have no 250^2 record: their errors must be
# finite
GP_RECORD = {"none": 1.66, "full": 1.89}
GP_LIMIT = {key: 2 * rec for key, rec in GP_RECORD.items()}
GP_SEARCHES = ("cv", "bayesian", "aniso", "svr")
# [rnm]: the POD-ANN closure at the runners' defaults, trained for
# RNM_EPOCHS of the recipe's 5000 (the cut of this phase's depth); the
# JAX package's records (RESULTS.md:128,139) come from a network that
# trained to epoch 3932 (rnm_model.msgpack.json): RNM 1.00% at (4.75,
# 0.02) (1.98% at (5.19, 0.026)), HRNM 2.48% at (5.19, 0.026). The errors
# must be finite; the sweep's rows must equal lone runs
RNM_EPOCHS = 100
RNM_MU = (4.75, 0.02)
RNM_RECORD = {"rnm": 1.00, "hrnm": 2.48}
RNM_SWEEP_MUS = [(5.19, 0.026), (4.56, 0.019), (4.75, 0.02)]
RNM_SWEEP_TOL = 1e-12
# Depth cuts that make room for [ae] and [drivers] within the script's
# time (PERF.md §4): RNM_EPOCHS above (200 before [ae] joined); the RNM
# sweep and its lone runs, and the generic and factored HPROM sweeps and
# their single-point runs, take CUT_STEPS of the 500 steps (every row held
# against a lone run of as many steps); the host-bound generic engines of
# [rom] (lspg_prom at 250^2 and 750^2, ecsw_hprom, factored_hprom) and
# pallas_hprom unroll3 cg (~40 steps/s) are timed SLOW_REPS times after
# their warm-up run, not REPS. To make room for [spatial]: pallas_hprom
# unroll3 cg and [runners]' run_sweep --model hprom take CUT_STEPS steps,
# the 750^2 lspg_prom FINE_LSPG_STEPS, and [drivers]' run_tests and
# run_tests_hprom run at DRIVER_POINTS, the first of the three test
# points (each point is a runner process, mostly its start-up)
CUT_STEPS = 100
SLOW_REPS = 1
DRIVER_POINTS = TEST_POINTS[:1]
# [ae]: AE-LSPG at the JAX package's record configuration (50^2, 500
# steps, latent 10, the runner's recipe: 300 epochs, patience 50, batch
# 16, Adam at 1e-3, seed 1234557), in the order scripts/record_ae_rows.py
# ran it: the first point trains (a float32 online state), the other two
# load the checkpoint (a float64 state). The JAX records
# (rom_results_ae.npz, the JAX CPU backend) and its sidecar
# (ae_model_50x50.msgpack.json: best validation loss 3.567e-04 at epoch
# 94); each error must be finite and under twice the record (AE_LIMIT)
AE_N = 50
AE_LATENT = 10
AE_EPOCHS = 300
AE_MUS = [(5.19, 0.026), (4.56, 0.019), (4.75, 0.02)]
AE_RECORD = {(5.19, 0.026): 0.4746, (4.56, 0.019): 0.4236,
             (4.75, 0.02): 0.4129}
AE_LIMIT = {mu: 2 * rec for mu, rec in AE_RECORD.items()}
AE_JAX_BEST = (3.567e-04, 94)

# the card's peak rates (NVIDIA H100 SXM data sheet, at 700 W): HBM, and
# FP32 / FP64 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {F32: 67e12, F64: 34e12}
# operations of the wavefront step per band cell: the 2x2 block and its
# determinant (18), the reciprocal (1), two right-hand sides (18), the
# solve (8)
WAVEFRONT_OPS = 45


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def bound(nbytes, ops, dtype):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of `nbytes` over its memory rate and `ops` over its peak rate
    for `dtype`."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def gram_ops(rows, k):
    """Operations of the symmetric Gram of `rows` rows over k + 1 lanes."""
    return rows * (k + 1) * (k + 2)


def rel_err(got, want):
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def cuda_ms(fn, calls):
    """Median over REPS of the mean time of `calls` calls (CUDA events)."""
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def cuda_ms_once(fn):
    """(ms, fn()) of one call (CUDA events): for plain versions that take
    seconds, timed on the run that is compared with the kernel."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def phase_environment():
    check(torch.cuda.is_available(), "no CUDA device: this smoke run "
          "needs an NVIDIA GPU")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"{torch.cuda.get_device_name(0)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    flags = precision_flags()
    check(not flags["cuda.matmul.allow_tf32"]
          and not flags["cudnn.allow_tf32"]
          and flags["float32_matmul_precision"] == "highest",
          f"the package did not pin full-f32 matmuls: {flags}")
    print(f"[env] precision pinned by the package: {flags}")
    return card


def phase_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] {path.name} ready in {time.perf_counter() - t0:.2f} s")


def skewed_inputs(lay, dtype, seed):
    """u, v in [1, 2] and a normal right-hand side, zero off the band."""
    rng = np.random.default_rng(seed)
    band = sk.valid_mask(lay, F64).numpy()
    shape = (lay.nd_pad, lay.ny_pad)
    arrs = (1 + rng.uniform(size=shape), 1 + rng.uniform(size=shape),
            rng.normal(size=shape), rng.normal(size=shape))
    return [torch.tensor(a * band, dtype=dtype, device="cuda")
            for a in arrs]


def unskewed_inputs(nx, ny, dtype, seed):
    """u, v in [1, 2] and a normal right-hand side, each (ny, nx), on the
    card."""
    rng = np.random.default_rng(seed)
    shape = (ny, nx)
    return [torch.tensor(a, dtype=dtype, device="cuda") for a in (
        1 + rng.uniform(size=shape), 1 + rng.uniform(size=shape),
        rng.normal(size=shape), rng.normal(size=shape))]


def skew_b1_unskew(args, grid):
    """B2's composition on (u, v, fu, fv): the fields skewed and padded,
    B1's kernel, the results unskewed."""
    lay = sk.make_layout(grid, block=1)
    sdu, sdv = cw.solve_skewed_cuda(*(sk.to_skewed(x, lay) for x in args),
                                    DT, grid, lay)
    return sk.from_skewed(sdu, lay), sk.from_skewed(sdv, lay)


# [kernel] layouts beside the main one: ny above 1024; ny far below nx (two
# warps, one hand-off); ny far above nx (short bands through many warps); 36
# warps over 8 CTAs (uneven); 68 warps, 9 a CTA (more than its schedulers)
KERNEL_LAYOUTS = ((200, 1100), (1000, 40), (30, 900), (40, 1100), (20, 2100))


def phase_kernel_vs_plain(card):
    """Returns {dtype: numbers} at the main-path layout."""
    main = {}
    for nx, ny in ((MAIN_N, MAIN_N),) + KERNEL_LAYOUTS:
        is_main = (nx, ny) == (MAIN_N, MAIN_N)
        grid = Grid2D(nx=nx, ny=ny)
        lay = sk.make_layout(grid)
        off_band = ~sk.valid_mask(lay, torch.bool, "cuda")
        for dtype in (F32, F64):
            args = skewed_inputs(lay, dtype, seed=nx + ny)
            got = cw.solve_skewed_cuda(*args, DT, grid, lay)
            again = cw.solve_skewed_cuda(*args, DT, grid, lay)
            want = sk.solve_skewed_ref(*args, DT, grid, lay)
            torch.cuda.synchronize()
            rel = max(rel_err(g, w) for g, w in zip(got, want))
            abs_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  "kernel output not finite")
            check(rel <= KERNEL_TOL[dtype],
                  f"kernel vs plain {nx}x{ny} {dtype}: rel {rel}")
            check(all(bool((g[off_band] == 0).all()) for g in got),
                  f"kernel {nx}x{ny} {dtype}: nonzero off the band")
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"kernel {nx}x{ny} {dtype}: two runs differ")
            ms = cuda_ms(lambda: cw.solve_skewed_cuda(*args, DT, grid, lay),
                         calls=20)
            line = (f"[kernel] {nx}x{ny} layout {lay.nd_pad}x{lay.ny_pad} "
                    f"{str(dtype)[6:]}: rel {rel:.3e} max_abs {abs_err:.3e}, "
                    f"zeros off band ok, two runs bit-equal; kernel "
                    f"{ms:.4f} ms")
            if is_main:
                plain_ms = cuda_ms(
                    lambda: sk.solve_skewed_ref(*args, DT, grid, lay),
                    calls=1)
                # each of the band's cells read and written once: the
                # skew's padding is not the function's data
                bound_ms, bound_by = bound(
                    6 * nx * ny * args[0].element_size(),
                    WAVEFRONT_OPS * nx * ny, dtype)
                line += (f", plain {plain_ms:.2f} ms, bound {bound_ms:.4f} "
                         f"ms ({bound_by})")
                main[dtype] = dict(max_abs_err=abs_err, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
            print(f"{line} ({card})")
    return main


def residual_inputs(n, dtype):
    """R1 at the n^2 layout: (grid, lay, valid, workspace, fields), the
    fields u, v in [1, 2] with an update du, dv 1e-3 of a normal one, the
    source and the inflow term, zero off the band."""
    grid = Grid2D(nx=n, ny=n)
    lay = sk.make_layout(grid)
    u, v, fu, fv = skewed_inputs(lay, dtype, seed=n)
    f = dict(u=u, v=v, du=1e-3 * fu, dv=1e-3 * fv,
             src=sk.skewed_source(lay, grid, MU[1], DT, dtype, DEVICE),
             lbc=sk.skewed_inflow_bc(lay, grid, MU[0], DT, dtype, DEVICE))
    return (grid, lay, sk.valid_mask(lay, dtype, DEVICE),
            cr.ResidualWorkspace(lay, dtype, DEVICE), f)


def phase_residual_kernel(card):
    """[residual] R1 (csrc/skewed_residual.cu) against the eager
    expressions on the card at the 750^2 main-path layout, f32 and f64:
    a step's constant and an update (and the extrapolated guess's
    residual, no update and no stagnation term) with their norms and the
    stop flag. Fields bit-equal, norms within NORM_TOL, the same stop,
    two runs bit-equal; then each kernel and its eager composition in
    turns (kernel, eager, eager, kernel; CUDA events, median of 3 x 50
    calls) beside the bound of its fields (10 an update, 8 a step
    constant). Returns {dtype: {"update": numbers, "step_constant":
    numbers}}."""
    out = {}
    for dtype in (F32, F64):
        grid, lay, valid, ws, f = residual_inputs(MAIN_N, dtype)
        cases = {
            "step_constant": (
                lambda: cr.step_constant_cuda(
                    f["u"], f["v"], DT, grid, lay, f["src"], f["lbc"],
                    workspace=ws),
                lambda: sk.skewed_step_constant_norm_ref(
                    f["u"], f["v"], DT, grid, f["src"], f["lbc"], valid),
                8)}
        cp_u, cp_v, _, _, init = cases["step_constant"][1]()
        for key, du, dv, rn_prev in (("update", f["du"], f["dv"], init),
                                     ("guess", None, None, None)):
            kw = dict(init_norm=init, rn_prev=rn_prev, cutoff=1e-12)
            cases[key] = (
                lambda du=du, dv=dv, kw=kw: cr.update_residual_cuda(
                    f["u"], f["v"], du, dv, cp_u, cp_v, DT, grid, lay,
                    workspace=ws, **kw),
                lambda du=du, dv=dv, kw=kw: sk.skewed_update_residual_ref(
                    f["u"], f["v"], du, dv, cp_u, cp_v, DT, grid, valid,
                    **kw),
                10)
        numbers = {}
        for key, (kernel, eager, n_fields) in cases.items():
            label = f"{key} {str(dtype)[6:]}"
            got, again, want = kernel(), kernel(), eager()
            torch.cuda.synchronize()
            fields = [i for i, w in enumerate(want)
                      if w.dim() == 2]
            norm = fields[-1] + 1
            check(all(torch.equal(got[i], want[i]) for i in fields),
                  f"R1 {label}: fields differ from the eager expressions")
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"R1 {label}: two runs differ")
            err = rel_err(got[norm], want[norm])
            check(err <= NORM_TOL[dtype], f"R1 {label}: norm rel {err}")
            if key != "step_constant":
                check(bool(got[5]) == bool(want[5]),
                      f"R1 {label}: stop {bool(got[5])} against "
                      f"{bool(want[5])}")
            line = (f"[residual] R1 {key} {MAIN_N}x{MAIN_N} layout "
                    f"{lay.nd_pad}x{lay.ny_pad} {str(dtype)[6:]}: fields "
                    f"bit-equal to eager, norm rel {err:.3e}, two runs "
                    f"bit-equal")
            if key != "guess":
                t = [cuda_ms(fn, calls=50)
                     for fn in (kernel, eager, eager, kernel)]
                bound_ms, bound_by = bound(
                    n_fields * got[0].numel() * got[0].element_size(), 0,
                    dtype)
                numbers[key] = dict(max_abs_err=0.0, norm_rel_err=err,
                                    ms=statistics.median((t[0], t[3])),
                                    plain_ms=statistics.median((t[1], t[2])),
                                    bound_ms=bound_ms, bound_by=bound_by)
                line += (f"; kernel {t[0]:.4f} / {t[3]:.4f} ms, eager "
                         f"{t[1]:.4f} / {t[2]:.4f} ms (in turns), bound "
                         f"{bound_ms:.4f} ms ({n_fields} fields, "
                         f"{bound_by})")
            print(f"{line} ({card})")
        out[dtype] = numbers
    return out


def reset_residual_counts():
    cr.RESIDUAL_LAUNCHES = 0
    cr.STEP_CONSTANT_LAUNCHES = 0


def residual_counts(label, updates, steps):
    """R1's launches since reset_residual_counts, checked: one an update,
    one a step. Returns them (updates, steps)."""
    got = (cr.RESIDUAL_LAUNCHES, cr.STEP_CONSTANT_LAUNCHES)
    check(got == (updates, steps) and steps > 0,
          f"{label}: R1 launched {got[0]} updates and {got[1]} step "
          f"constants for {updates} Newton iterations and {steps} steps")
    return got


def phase_entry_step(card):
    """The entry step through the port's twin of __graft_entry__.entry
    (finitedifference_tpu_torch.entry): its 250^2 float32 Newton step on
    the card, against the same step on the CPU, with B2's and B1's
    counts set to 0 just before it; then B2, the solve on unskewed
    fields, at the step's shape and on UNSKEWED_SHAPES
    (unskewed_solve_vs_plain), and the standard engine's trajectory
    (standard_engine). Returns (the step's B2 launches, {dtype: B2's
    numbers}, the standard engine's B2 launches)."""
    from finitedifference_tpu_torch.entry import entry

    step, args = entry()
    cw.LAUNCHES = 0
    cw.UNSKEWED_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = step(*args)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, b1_launches = cw.UNSKEWED_LAUNCHES, cw.LAUNCHES
    cpu_step, cpu_args = entry(device="cpu")
    want = cpu_step(*cpu_args)
    rel = rel_err(got.cpu(), want)
    check(got.dtype == F32 and bool(torch.isfinite(got).all()),
          "entry step not finite")
    check(rel <= 1e-5, f"entry step GPU vs CPU: rel {rel}")
    check(launches > 0, "entry step launched no B2 kernel")
    check(b1_launches == 0, f"entry step launched B1 {b1_launches} times")
    print(f"[entry] entry() newton_step 250x250 f32, max_its 20: "
          f"{launches} B2 launches (one a Newton iteration), {b1_launches} "
          f"B1, rel vs CPU {rel:.3e}, {elapsed * 1e3:.1f} ms incl. "
          f"first-call set-up ({card})")
    numbers = unskewed_solve_vs_plain(card)
    return launches, numbers, standard_engine(card)


# B2's shapes (nx, ny) beside the entry step's: tiny; ny far above and far
# below nx; the main path's 750^2; ny far above nx and no multiple of 32;
# ny above 768 over uneven CTAs; 66 warps, 9 a CTA
UNSKEWED_SHAPES = ((8, 6), (13, 5), (5, 40), (40, 5), (750, 750), (3, 300),
                   (40, 1100), (20, 2100))
STANDARD_STEPS = 20


def unskewed_check(grid, dtype):
    """B2 (solve_jacobian_wavefront) on one grid: within KERNEL_TOL of its
    plain version, bit-equal to skew -> B1 -> unskew, two runs bit-equal.
    Returns (args, rel, max_abs)."""
    from finitedifference_tpu_torch.ops.wavefront import (
        solve_jacobian_wavefront,
        solve_jacobian_wavefront_ref,
    )

    nx, ny = grid.nx, grid.ny
    args = unskewed_inputs(nx, ny, dtype, seed=nx + ny)
    got = solve_jacobian_wavefront(*args, DT, grid)
    again = solve_jacobian_wavefront(*args, DT, grid)
    composed = skew_b1_unskew(args, grid)
    want = solve_jacobian_wavefront_ref(*args, DT, grid)
    torch.cuda.synchronize()
    rel = max(rel_err(g, w) for g, w in zip(got, want))
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"B2 {nx}x{ny} {dtype}: not finite")
    check(rel <= KERNEL_TOL[dtype], f"B2 vs plain {nx}x{ny} {dtype}: rel "
          f"{rel}")
    check(all(torch.equal(g, c) for g, c in zip(got, composed)),
          f"B2 {nx}x{ny} {dtype}: differs from skew, B1, unskew")
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"B2 {nx}x{ny} {dtype}: two runs differ")
    return args, rel, abs_err


def unskewed_solve_vs_plain(card):
    """B2 at the entry step's 250^2 fields, f32 and f64 (unskewed_check),
    and the times of B2, its composition (in turns: B2, composition,
    composition, B2) and its plain version; then unskewed_check on
    UNSKEWED_SHAPES. Returns {dtype: B2's numbers at 250^2}."""
    from finitedifference_tpu_torch.ops.wavefront import (
        solve_jacobian_wavefront,
        solve_jacobian_wavefront_ref,
    )

    grid = grid_from_config(BurgersConfig())
    n = grid.nx
    out = {}
    for dtype in (F32, F64):
        args, rel, abs_err = unskewed_check(grid, dtype)

        def b2():
            return solve_jacobian_wavefront(*args, DT, grid)

        def composed():
            return skew_b1_unskew(args, grid)

        t = [cuda_ms(fn, calls=20) for fn in (b2, composed, composed, b2)]
        plain_ms = cuda_ms(lambda: solve_jacobian_wavefront_ref(
            *args, DT, grid), calls=1)
        # the function's data: four fields read, two written
        bound_ms, bound_by = bound(6 * grid.n_cells * args[0].element_size(),
                                   WAVEFRONT_OPS * grid.n_cells, dtype)
        out[dtype] = dict(max_abs_err=abs_err, ms=statistics.median(
            (t[0], t[3])), plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, composition_ms=statistics.median((t[1], t[2])))
        print(f"[entry] B2 solve_jacobian_wavefront {n}x{n} "
              f"{str(dtype)[6:]}: rel {rel:.3e} max_abs {abs_err:.3e} vs "
              f"plain, bit-equal to skew -> B1 -> unskew, two runs "
              f"bit-equal; B2 "
              f"{t[0]:.4f} / {t[3]:.4f} ms, skew -> B1 -> unskew {t[1]:.4f} "
              f"/ {t[2]:.4f} ms (in turns), plain {plain_ms:.2f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}) ({card})")
    for nx, ny in UNSKEWED_SHAPES:
        for dtype in (F32, F64):
            rel = unskewed_check(Grid2D(nx=nx, ny=ny), dtype)[1]
            print(f"[entry] B2 {nx}x{ny} {str(dtype)[6:]}: rel {rel:.3e} vs "
                  f"plain, bit-equal to skew -> B1 -> unskew, two runs "
                  f"bit-equal")
    return out


def standard_engine(card):
    """The standard engine (fom.inviscid_burgers_implicit2d, run_fom
    --engine standard and sweep_fom's default) at 250^2 with a float64
    state for STANDARD_STEPS steps, B2's and B1's counts set to 0 just
    before it: one B2 launch a Newton iteration and none of B1, the
    snapshots within 1e-10 of the skewed engine's. Returns its B2
    launches."""
    from finitedifference_tpu_torch.fom import inviscid_burgers_implicit2d

    grid = grid_from_config(BurgersConfig())
    w0 = grid.initial_state(dtype=F64)
    cw.LAUNCHES = 0
    cw.UNSKEWED_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    std = inviscid_burgers_implicit2d(grid, w0, DT, STANDARD_STEPS, *MU)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, b1_launches = cw.UNSKEWED_LAUNCHES, cw.LAUNCHES
    skewed = inviscid_burgers_implicit2d_skewed(grid, w0, DT, STANDARD_STEPS,
                                                *MU)
    rel = rel_err(std.snaps, skewed.snaps)
    check(bool(torch.isfinite(std.snaps).all()), "standard engine not finite")
    check(launches == std.total_newton_its > 0,
          f"standard engine: {launches} B2 launches for "
          f"{std.total_newton_its} Newton iterations")
    check(b1_launches == 0, f"standard engine launched B1 {b1_launches} "
          f"times")
    check(rel <= 1e-10, f"standard vs skewed engine: rel {rel}")
    print(f"[entry] standard engine {grid.nx}x{grid.ny} f64, "
          f"{STANDARD_STEPS} steps: {std.total_newton_its} Newton its "
          f"(skewed engine {skewed.total_newton_its}), {launches} B2 "
          f"launches, 0 B1, snapshots vs the skewed engine rel {rel:.3e}, "
          f"{STANDARD_STEPS / elapsed:.2f} steps/s incl. set-up ({card})")
    return launches


def phase_main_path(card):
    """The 750^2 trajectory with f32 and with f64 solves; returns the
    B1 launches of all its runs, R1's [update, step constant] launches
    and the final state of the last f32-solve run."""
    grid = Grid2D(nx=MAIN_N, ny=MAIN_N)
    w0 = torch.ones(grid.state_dim, dtype=F64, device="cuda")
    total_launches = 0
    r1 = [0, 0]
    finals = {}
    for label, solve_dtype in (("a: f32 solve", F32),
                               ("b: f64 solve", None)):
        def run(steps):
            nonlocal total_launches
            cw.LAUNCHES = 0
            reset_residual_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = inviscid_burgers_implicit2d_skewed(
                grid, w0, DT, steps, MU[0], MU[1], solve_dtype=solve_dtype,
                snaps_dtype=F32)
            checksum = float(res.snaps.sum(dtype=F64))
            elapsed = time.perf_counter() - t0
            launches = cw.LAUNCHES
            total_launches += launches
            check(launches == res.total_newton_its > 0,
                  f"{label}: {launches} launches for "
                  f"{res.total_newton_its} Newton iterations")
            for i, n in enumerate(residual_counts(
                    label, res.total_newton_its, steps)):
                r1[i] += n
            check(np.isfinite(checksum), f"{label}: trajectory not finite")
            check(tuple(res.snaps.shape) == (grid.state_dim, steps + 1),
                  f"{label}: snapshot shape {tuple(res.snaps.shape)}")
            return res, elapsed

        run(WARM_STEPS)
        rates, its, worst = [], [], []
        for _ in range(REPS):
            res, elapsed = run(MEAS_STEPS)
            rates.append(MEAS_STEPS / elapsed)
            its.append(res.total_newton_its / MEAS_STEPS)
            worst.append(float(res.max_final_relnorm))
        if solve_dtype is None:
            check(max(worst) < 1e-12,
                  f"{label}: a step did not converge ({max(worst)})")
        finals[label] = res.snaps[:, -1]
        print(f"[main] 750x750 {label}, f64 Newton, f32 snapshots: "
              f"{statistics.median(rates):.3f} steps/s (median of "
              f"{REPS} x {MEAS_STEPS} steps; runs "
              f"{', '.join(f'{r:.3f}' for r in rates)}), "
              f"{statistics.median(its):.2f} Newton its/step, "
              f"max_final_relnorm {max(worst):.3e} ({card})")
    a, b = finals.values()
    print(f"[main] final f32 snapshot (a) vs (b): rel {rel_err(a, b):.3e}, "
          f"{int((a != b).sum())} of {a.numel()} entries differ, max abs "
          f"difference {float((a - b).abs().max()):.3e}; R1 launched once "
          f"an update and once a step ({r1[0]} + {r1[1]})")
    return total_launches, r1, a


def phase_gpu_vs_cpu():
    """A 64^2 float64 trajectory on the card (B1 and R1) against the CPU
    (the plain versions); returns R1's [update, step constant] launches."""
    grid = Grid2D(nx=64, ny=64)
    w0 = torch.ones(grid.state_dim, dtype=F64)
    reset_residual_counts()
    gpu = inviscid_burgers_implicit2d_skewed(grid, w0.cuda(), DT, 20, *MU)
    r1 = residual_counts("64x64 GPU", gpu.total_newton_its, 20)
    cpu = inviscid_burgers_implicit2d_skewed(grid, w0, DT, 20, *MU)
    rel = rel_err(gpu.snaps.cpu(), cpu.snaps)
    check(rel < 1e-12, f"64x64 GPU vs CPU: rel {rel}")
    check(gpu.total_newton_its == cpu.total_newton_its,
          f"64x64 Newton its GPU {gpu.total_newton_its} vs CPU "
          f"{cpu.total_newton_its}")
    print(f"[slice] 64x64 f64 20 steps GPU vs CPU: rel {rel:.3e}, "
          f"{gpu.total_newton_its} Newton its on both")
    return list(r1)


# ----------------------------------------------------------------------
# the reduced models: Gauss-Newton system kernels B3, B4, B5
# ----------------------------------------------------------------------

def reset_gn_counts():
    cgf.LAUNCHES = 0
    cg.SYSTEM_LAUNCHES = 0
    cg.STEP_LAUNCHES = 0
    cg.TRAJ_LAUNCHES = 0


def gn_counts():
    return {"gn_full": cgf.LAUNCHES, "gn_sampled_system": cg.SYSTEM_LAUNCHES,
            "gn_sampled_step": cg.STEP_LAUNCHES,
            "gn_traj": cg.TRAJ_LAUNCHES}


def full_system_inputs(n, dtype, seed):
    """B3 at the n^2, 95-mode layout: unit-scale basis columns, a y whose
    scalars are O(1), an O(1) step constant zero on dead cells."""
    grid = Grid2D(nx=n, ny=n)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    cells = grid.n_cells
    basis = torch.randn((2 * cells, MODES), generator=gen, dtype=dtype,
                        device=DEVICE) / cells ** 0.5
    vu, vv, tr = gf.pad_basis_full(basis, grid, 4, dtype=dtype)
    del basis
    dmask = gf.row_mask(grid, tr, dtype, DEVICE)
    nxp, _, tile = gf.full_layout(grid, tr)
    y = (1 + 0.1 * torch.randn(MODES, generator=gen, dtype=dtype,
                               device=DEVICE)) * (cells / MODES) ** 0.5
    cp = 0.1 * torch.randn((vu.shape[0], 2), generator=gen, dtype=dtype,
                           device=DEVICE) * dmask
    return (vu, vv, y, cp, dmask, MODES, nxp, tile,
            0.5 * DT / grid.dx, 0.5 * DT / grid.dy)


def sampled_system_inputs(dtype, seed):
    """B4/B5 at the 250^2 synthetic-mesh layout: 512 interior cells plus
    the 996-cell ring, 95 modes, padded to (6, 1536, 128)."""
    n_s = MESH_INTERIOR + 4 * (ROM_N - 1)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    p6 = torch.randn((6, n_s, MODES), generator=gen, dtype=dtype,
                     device=DEVICE) / MODES ** 0.5
    wgt = 1 + torch.rand(n_s, generator=gen, dtype=dtype, device=DEVICE)
    p6p, wgt_p = gn.pad_factored_inputs(p6, wgt, dtype=dtype)
    y = torch.randn(MODES, generator=gen, dtype=dtype, device=DEVICE)
    cp = 0.1 * torch.randn((p6p.shape[1], 2), generator=gen, dtype=dtype,
                           device=DEVICE)
    grid = Grid2D(nx=ROM_N, ny=ROM_N)
    return (p6p, y, cp, wgt_p, MODES, 0.5 * DT / grid.dx,
            0.5 * DT / grid.dy)


def compare(label, got, want, tol, card, ms, plain_ms, nbytes, ops, dtype):
    """Hold a kernel's outputs against its plain version's; `dtype` is
    the working type, whose peak rate the bound takes (B3's Gram comes
    out in float64 whatever it was computed in)."""
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{label}: kernel output not finite")
    rel = max(rel_err(g, w) for g, w in zip(got, want))
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(rel <= tol, f"{label}: kernel vs plain rel {rel} > {tol}")
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    print(f"[gn-kernel] {label}: rel {rel:.3e} max_abs {abs_err:.3e} "
          f"(tol {tol:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}) ({card})")
    return {"max_abs_err": abs_err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_gn_kernels(card):
    """Each Gauss-Newton kernel against its plain version; returns
    {kernel: {(layout, dtype): numbers}}."""
    out = {k: {} for k in GN_KERNELS}
    for n in (ROM_N, FINE_N):
        for dtype in (F32, F64):
            args = full_system_inputs(n, dtype, seed=n)
            vu, vv, y, cp, dmask, k, nxp, tile, hdx, hdy = args
            slbc = 0.01 * dmask
            g0, cp0 = gf.gn_full_first(vu, vv, y, slbc, dmask, k, nxp, tile,
                                       hdx, hdy)
            w0, wcp = gf.gn_full_ref(vu, vv, y, slbc, dmask, k, nxp, tile,
                                     hdx, hdy, True)
            got = gf.gn_full_system(*args)
            want = gf.gn_full_ref(*args, False)[0]
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: gf.gn_full_system(*args), calls=20)
            plain_ms = cuda_ms(lambda: gf.gn_full_ref(*args, False), calls=3)
            kp = vu.shape[1]
            # what the function needs: the live lanes of the two basis
            # halves on the live rows, y, their cp and mask, the float64
            # Gram; a GEMV per half, the rows pass, the symmetric Gram
            n_live = int(torch.count_nonzero(dmask))
            nbytes = (2 * n_live * k + k + 3 * n_live) * vu.element_size() \
                + 8 * kp * kp
            ops = gram_ops(2 * n_live, k) + 22 * n_live * k
            out["gn_full"][(n, dtype)] = compare(
                f"gn_full {n}x{n} layout {tuple(vu.shape)} "
                f"{str(dtype)[6:]}", (got, g0, cp0), (want, w0, wcp),
                GN_TOL[dtype], card, ms, plain_ms, nbytes, ops, dtype)
            again = gf.gn_full_system(*args)
            check(torch.equal(got, again),
                  f"gn_full {n}x{n} {dtype}: two runs differ")
            del vu, vv, args
    phase_gn_full_ragged(card)
    for dtype in (F32, F64):
        args = sampled_system_inputs(dtype, seed=1)
        layout = tuple(args[0].shape)
        _, n_p, kp = layout
        k, e = args[4], args[0].element_size()
        ws = gn.sampled_workspace(args[0], k)
        # what the function needs: the live lanes of the blocks on the
        # cells of nonzero weight, y, their cp and weights; six dot
        # products a cell, the rows, the symmetric Gram; the system writes
        # gext (kp, kp), the step adds the CG and writes dy and rn
        n_live = int(torch.count_nonzero(args[3]))
        inputs = (6 * n_live * k + k + 3 * n_live) * e
        system_ops = gram_ops(2 * n_live, k) + 30 * n_live * k
        cg_ops = rf.CG_ITERS * (2 * k * k + 10 * k)
        for name, fn, ref, tol, nbytes, ops in (
                ("gn_sampled_system",
                 lambda: (gn.gn_system(*args, workspace=ws),),
                 lambda: (gn.gn_system_ref(*args),), GN_TOL[dtype],
                 inputs + kp * kp * e, system_ops),
                # the CG carries the Gram's rounding through 24 iterations
                ("gn_sampled_step", lambda: gn.gn_step(*args, workspace=ws),
                 lambda: gn.gn_step_ref(*args), 100 * GN_TOL[dtype],
                 inputs + (k + 1) * e, system_ops + cg_ops)):
            got = fn()
            want = ref()
            again = fn()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {dtype}: two runs differ")
            ms = cuda_ms(fn, calls=50)
            plain_ms = cuda_ms(ref, calls=10)
            ms_device = graph_ms(fn, calls=50)
            per_call, kernels = device_kernels_per_call({name: fn})[name]
            check(per_call == 1, f"{name} {dtype}: {per_call} device "
                  f"kernels a call ({kernels})")
            out[name][(ROM_N, dtype)] = compare(
                f"{name} {ROM_N}x{ROM_N} mesh layout {layout} "
                f"{str(dtype)[6:]}", got, want, tol, card, ms, plain_ms,
                nbytes, ops, dtype)
            out[name][(ROM_N, dtype)]["ms_device"] = ms_device
            print(f"[gn-kernel] {name} {str(dtype)[6:]}: device "
                  f"{ms_device:.4f} ms a call (CUDA graph of 50 calls), "
                  f"eager {ms:.4f} ms launch to launch, {per_call} device "
                  f"kernel a call ({kernels[0]}), two runs bit-equal "
                  f"({card})")
        del ws
    phase_gn_sampled_ragged(card)
    return out


def b2_device_kernels(card):
    """One device kernel a call of B2 (solve_jacobian_wavefront) at the
    entry step's 250^2 fields, f32 and f64, counted by torch.profiler
    (device_kernels_per_call). main runs it after phase_gn_kernels: a
    profiler session of B2 early in the process once left [gn-kernel]
    reading 0.9 kernels a call in all its windows, a dropped event (on an
    H100, PERF.md)."""
    from finitedifference_tpu_torch.ops.wavefront import (
        solve_jacobian_wavefront,
    )

    grid = grid_from_config(BurgersConfig())
    for dtype in (F32, F64):
        args = unskewed_inputs(grid.nx, grid.ny, dtype, seed=1)
        per_call, kernels = device_kernels_per_call({"b2": lambda: (
            solve_jacobian_wavefront(*args, DT, grid))})["b2"]
        check(per_call == 1, f"B2 {dtype}: {per_call} device kernels a call "
              f"({kernels})")
        print(f"[b2-kernels] B2 solve_jacobian_wavefront {grid.nx}x{grid.ny} "
              f"{str(dtype)[6:]}: {per_call:g} device kernel a call "
              f"({kernels[0]}) ({card})")


def graph_ms(fn, calls):
    """Device ms a call: `calls` calls captured in one CUDA graph and
    replayed under CUDA events (median of REPS replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = cuda_ms(graph.replay, calls=1) / calls
    del graph
    return ms


def device_kernels_per_call(fns, calls=10, windows=3):
    """{name: (device kernels a call, their names)} for each function of
    `fns`, counted by torch.profiler over `calls` calls after a warm-up
    call. The profiler has dropped a kernel event now and then on the
    H100 (9 kernels for 10 calls once): a function is counted in up to
    `windows` windows and the largest count kept, since a dropped event
    can only lower a count."""
    out = {}
    for name, fn in fns.items():
        best = (-1.0, [])
        for _ in range(windows):
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            rows = [(e.key, e.count) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            count = sum(c for _, c in rows) / calls
            if count > best[0]:
                best = (count, [key[:60] for key, _ in rows])
            if count >= 1:
                break
        out[name] = best
    return out


def phase_gn_sampled_ragged(card):
    """B4 and B5 where their geometry is uneven: 150 modes (kp 256, 160
    live lanes) on 1000 cells, so the last chunk is short and the 63
    chunks do not divide among the clusters' CTAs; f32 and f64, two runs
    bit-equal."""
    n_s, k = 1000, 150
    for dtype in (F32, F64):
        gen = torch.Generator(device=DEVICE).manual_seed(n_s)
        p6 = torch.randn((6, n_s, k), generator=gen, dtype=dtype,
                         device=DEVICE) / k ** 0.5
        wgt = 1 + torch.rand(n_s, generator=gen, dtype=dtype, device=DEVICE)
        p6p, wgt_p = gn.pad_factored_inputs(p6, wgt, tile=8, dtype=dtype)
        y = torch.randn(k, generator=gen, dtype=dtype, device=DEVICE)
        cp = 0.1 * torch.randn((p6p.shape[1], 2), generator=gen,
                               dtype=dtype, device=DEVICE)
        args = (p6p, y, cp, wgt_p, k, 0.5 * DT, 0.25 * DT)
        n_p = p6p.shape[1]
        geo = cg.sampled_geometry(n_p, k, p6p.element_size())
        check(n_p % geo.cells != 0
              and geo.n_chunks % (geo.n_clusters * geo.cluster) != 0,
              f"gn_sampled ragged layout is even: {geo}")
        ws = gn.sampled_workspace(p6p, k)
        got = gn.gn_system(*args, workspace=ws)
        again = gn.gn_system(*args, workspace=ws)
        dy, rn = gn.gn_step(*args, workspace=ws)
        dy2, rn2 = gn.gn_step(*args, workspace=ws)
        want = gn.gn_system_ref(*args, 8)
        wdy, wrn = gn.gn_step_ref(*args, 8)
        torch.cuda.synchronize()
        rel_sys = rel_err(got, want)
        rel_step = max(rel_err(dy, wdy), rel_err(rn, wrn))
        check(rel_sys <= GN_TOL[dtype], f"gn_sampled_system ragged {dtype}: "
              f"rel {rel_sys}")
        check(rel_step <= 100 * GN_TOL[dtype], f"gn_sampled_step ragged "
              f"{dtype}: rel {rel_step}")
        check(torch.equal(got, again) and torch.equal(dy, dy2)
              and torch.equal(rn, rn2), f"gn_sampled ragged {dtype}: two "
              f"runs differ")
        check(bool((got[k + 1:] == 0).all() and (got[:, k + 1:] == 0).all()),
              f"gn_sampled_system ragged {dtype}: nonzero beyond lane k")
        print(f"[gn-kernel] gn_sampled {n_s} cells k {k} layout "
              f"{tuple(p6p.shape)} {str(dtype)[6:]}: {geo.n_chunks} chunks "
              f"of {geo.cells} cells over {geo.n_clusters} clusters "
              f"of {geo.cluster} CTAs, {geo.lanes} live lanes: system rel "
              f"{rel_sys:.3e} (tol {GN_TOL[dtype]:g}), step rel "
              f"{rel_step:.3e} (tol {100 * GN_TOL[dtype]:g}), two runs "
              f"bit-equal, zeros beyond lane k ({card})")


def phase_gn_full_ragged(card):
    """B3 where its geometry is uneven: 150 x 149 cells in chunks that do
    not divide among the card's CTAs, and 40 modes, so that k + 1 = 41
    is no multiple of the 16-lane granularity."""
    nx, ny, k = 150, 149, 40
    grid = Grid2D(nx=nx, ny=ny)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (F32, F64):
        gen = torch.Generator(device=DEVICE).manual_seed(nx)
        cells = grid.n_cells
        basis = torch.randn((2 * cells, k), generator=gen, dtype=dtype,
                            device=DEVICE) / cells ** 0.5
        vu, vv, tr = gf.pad_basis_full(basis, grid, 4, dtype=dtype)
        dmask = gf.row_mask(grid, tr, dtype, DEVICE)
        nxp, _, tile = gf.full_layout(grid, tr)
        y = (1 + 0.1 * torch.randn(k, generator=gen, dtype=dtype,
                                   device=DEVICE)) * (cells / k) ** 0.5
        slbc = 0.01 * dmask
        hd = (0.5 * DT / grid.dx, 0.5 * DT / grid.dy)
        geo = cgf.full_geometry(vu.shape[0], k, vu.element_size(), sms)
        check(geo.n_chunks % geo.n_ctas != 0 and geo.lanes != k + 1,
              f"gn_full ragged layout is even: {geo}")
        g0, cp = gf.gn_full_first(vu, vv, y, slbc, dmask, k, nxp, tile, *hd)
        w0, wcp = gf.gn_full_ref(vu, vv, y, slbc, dmask, k, nxp, tile, *hd,
                                 True)
        g1 = gf.gn_full_system(vu, vv, y, cp, dmask, k, nxp, tile, *hd)
        again = gf.gn_full_system(vu, vv, y, cp, dmask, k, nxp, tile, *hd)
        w1 = gf.gn_full_ref(vu, vv, y, cp, dmask, k, nxp, tile, *hd,
                            False)[0]
        torch.cuda.synchronize()
        rel = max(rel_err(g, w) for g, w in ((g0, w0), (cp, wcp), (g1, w1)))
        check(rel <= GN_TOL[dtype], f"gn_full ragged {dtype}: rel {rel}")
        check(torch.equal(g1, again), f"gn_full ragged {dtype}: two runs "
              f"differ")
        check(bool((g1[k + 1:] == 0).all() and (g1[:, k + 1:] == 0).all()),
              f"gn_full ragged {dtype}: nonzero beyond lane k")
        print(f"[gn-kernel] gn_full {nx}x{ny} k {k} layout "
              f"{tuple(vu.shape)} {str(dtype)[6:]}: {geo.n_chunks} chunks of "
              f"{geo.chunk} cells over {geo.n_ctas} CTAs, {geo.lanes} live "
              f"lanes: rel {rel:.3e} (tol {GN_TOL[dtype]:g}), two runs "
              f"bit-equal, zeros beyond lane k ({card})")


def run_engine(label, fn, kernel, steps, launches, generic=None,
               basis=None, hdm=None, reps=REPS):
    """A warm-up run, then `reps` timed runs of fn() -> ROMResult, each
    with the kernel counts set to 0 just before it and read just after.
    With `kernel`, every Gauss-Newton call of the engine must have
    launched that kernel once (ROMResult.gn_evals) and no other; the
    launches of the timed runs are added to `launches`. Prints steps/s
    (median), GN its/step, the difference against the generic engine's
    result and the error against the FOM snapshots; returns the result.
    """
    def once():
        reset_gn_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        checksum = float(res.red_coords.sum(dtype=F64))
        elapsed = time.perf_counter() - t0
        counts = gn_counts()
        check(np.isfinite(checksum), f"{label}: reduced coords not finite")
        check(tuple(res.red_coords.shape[1:]) == (steps + 1,),
              f"{label}: red_coords shape {tuple(res.red_coords.shape)}")
        expect = {k: 0 for k in GN_KERNELS}
        if kernel is not None:
            expect[kernel] = res.gn_evals
            check(res.gn_evals > 0, f"{label}: no kernel call")
        check(counts == expect, f"{label}: launches {counts}, expected "
              f"{expect}")
        return res, elapsed, counts

    once()
    rates, its = [], []
    for _ in range(reps):
        res, elapsed, counts = once()
        rates.append(steps / elapsed)
        its.append(res.total_gn_its / steps)
        for k, v in counts.items():
            launches[k] += v
    line = (f"[rom] {label}: {statistics.median(rates):.2f} steps/s "
            f"(median of {reps} x {steps} steps; runs "
            f"{', '.join(f'{r:.2f}' for r in rates)}), "
            f"{statistics.median(its):.3f} GN its/step")
    if kernel == "gn_traj":
        line += ", 1 gn_traj launch per run (the whole trajectory)"
    elif kernel is not None:
        line += (f", {counts[kernel]} {kernel} launches per run "
                 f"(= its {res.total_gn_its} + stopping checks)")
    if generic is not None:
        cols = min(generic.red_coords.shape[1], steps + 1)
        diff = rel_err(res.red_coords[:, :cols],
                       generic.red_coords[:, :cols])
        check(diff < ENGINE_TOL, f"{label}: rel {diff} vs generic engine")
        line += f", rel vs generic engine {diff:.3e}"
    if hdm is not None:
        line += f", error vs FOM {err_pct(basis, res, hdm):.4f}%"
    print(line)
    return res


def err_pct(basis, res, hdm):
    """100 ||FOM - V y|| / ||FOM|| over the trajectory, on the device."""
    rom = basis @ res.red_coords.to(basis.dtype)
    fom = hdm[:, :rom.shape[1]]
    return 100 * rel_err(rom, fom.to(rom.dtype))


def rom_basis(grid, card, solve_dtype=None):
    """FOM snapshots at the training and test points, and the rSVD POD
    basis of the training trajectory (f64 Newton, f32 snapshots)."""
    w0 = torch.ones(grid.state_dim, dtype=F64, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train = inviscid_burgers_implicit2d_skewed(
        grid, w0, DT, ROM_STEPS, *MU_TRAIN, solve_dtype=solve_dtype,
        snaps_dtype=F32)
    t1 = time.perf_counter()
    basis, svals = pod(train.snaps, num_modes=MODES, method="rsvd",
                       random_state=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del train
    hdm = inviscid_burgers_implicit2d_skewed(
        grid, w0, DT, ROM_STEPS, *MU, solve_dtype=solve_dtype,
        snaps_dtype=F32).snaps
    check(tuple(basis.shape) == (grid.state_dim, MODES)
          and bool(torch.isfinite(basis).all()), "POD basis malformed")
    ortho = float((basis.T.double() @ basis.double()
                   - torch.eye(MODES, dtype=F64, device=DEVICE)).abs().max())
    check(ortho < 1e-4, f"POD basis not orthonormal ({ortho})")
    print(f"[rom] {grid.nx}x{grid.ny}: FOM {ROM_STEPS} steps at "
          f"{MU_TRAIN} in {t1 - t0:.2f} s, rSVD {MODES} modes in "
          f"{t2 - t1:.2f} s (s[0] {float(svals[0]):.4e}, s[-1] "
          f"{float(svals[-1]):.4e}, |V^T V - I| {ortho:.1e}); FOM at {MU} "
          f"for the errors ({card})")
    return basis, hdm


def bench_mesh(grid, basis):
    """bench.py's HPROM mesh on the ROM_N^2 grid: MESH_INTERIOR random
    interior cells and the boundary ring at RING_WEIGHT; (mesh, f32
    weights, augmented basis)."""
    rng = np.random.default_rng(0)
    weights = np.zeros(grid.n_cells)
    interior = np.zeros((ROM_N, ROM_N), dtype=bool)
    interior[1:-1, 1:-1] = True
    weights[rng.choice(np.flatnonzero(interior.ravel()), MESH_INTERIOR,
                       replace=False)] = 1.0
    weights[~interior.ravel()] = RING_WEIGHT
    mesh, sw, ba = prepare_hprom(grid, weights, basis)
    print(f"[rom] {ROM_N}x{ROM_N} mesh: {mesh.n_sample} sampled cells "
          f"({MESH_INTERIOR} interior + ring at weight {RING_WEIGHT}), "
          f"{mesh.n_aug} augmented")
    return mesh, sw.to(F32), ba


def phase_rom_250(card, launches):
    """The 250^2 PROM and HPROM engines at the test point; returns what
    the later phases reuse: the grid, basis, FOM snapshots, bench mesh,
    its f32 weights and blocks, y0 and the ecsw_hprom result."""
    grid = Grid2D(nx=ROM_N, ny=ROM_N)
    basis, hdm = rom_basis(grid, card)
    w0 = torch.ones(grid.state_dim, dtype=F32, device=DEVICE)
    y0 = basis.T @ w0
    steps = ROM_STEPS

    def engine(label, fn, kernel=None, generic=None, reps=REPS):
        return run_engine(f"{ROM_N}x{ROM_N} {label} f32", fn, kernel, steps,
                          launches, generic, basis, hdm, reps)

    prom = engine("lspg_prom normal", lambda: lspg_prom(
        grid, w0, DT, steps, *MU, basis, ls_method="normal"),
        reps=SLOW_REPS)
    vu, vv, dmask, tr = rf.precompute_prom_pallas(grid, basis)
    engine("pallas_prom normal", lambda: rf.pallas_prom(
        grid, vu, vv, dmask, y0, DT, steps, *MU, tile_rows=tr),
        "gn_full", prom)
    del vu, vv

    mesh, sw32, ba = bench_mesh(grid, basis)
    hprom = engine("ecsw_hprom normal", lambda: ecsw_hprom(
        grid, mesh, sw32, y0, ba, DT, steps, *MU, ls_method="normal"),
        reps=SLOW_REPS)
    blocks = rf.precompute_factored_blocks(mesh, ba)
    engine("factored_hprom normal", lambda: rf.factored_hprom(
        grid, mesh, sw32, y0, blocks, DT, steps, *MU, ls_method="normal"),
        generic=hprom, reps=SLOW_REPS)
    p6p, wgt_p = rf.precompute_pallas_system(blocks, sw32)
    for label, kernel, kw, reps, n in (
            ("normal", "gn_sampled_system", dict(ls_method="normal"), REPS,
             steps),
            ("unroll3 cg", "gn_sampled_system",
             dict(ls_method="cg", unroll_its=3), SLOW_REPS, CUT_STEPS),
            ("unroll3 fused", "gn_sampled_step",
             dict(ls_method="fused", unroll_its=3), REPS, steps)):
        run_engine(f"{ROM_N}x{ROM_N} pallas_hprom {label} f32",
                   lambda kw=kw, n=n: rf.pallas_hprom(
                       grid, mesh, p6p, wgt_p, y0, DT, n, *MU, **kw),
                   kernel, n, launches, hprom, basis, hdm, reps)
    return dict(grid=grid, basis=basis, hdm=hdm, mesh=mesh, sw32=sw32,
                ba=ba, p6p=p6p, wgt_p=wgt_p, y0=y0, hprom=hprom)


def phase_fine_prom(card, launches):
    """The 750^2 streaming PROM (the case B3 was written for) against
    the generic LSPG PROM over its first FINE_LSPG_STEPS steps."""
    grid = Grid2D(nx=FINE_N, ny=FINE_N)
    basis, hdm = rom_basis(grid, card, solve_dtype=F32)
    w0 = torch.ones(grid.state_dim, dtype=F32, device=DEVICE)
    y0 = basis.T @ w0
    vu, vv, dmask, tr = rf.precompute_prom_pallas(grid, basis)
    prom = run_engine(
        f"{FINE_N}x{FINE_N} lspg_prom normal f32", lambda: lspg_prom(
            grid, w0, DT, FINE_LSPG_STEPS, *MU, basis, ls_method="normal"),
        None, FINE_LSPG_STEPS, launches, None, basis, hdm, SLOW_REPS)
    run_engine(f"{FINE_N}x{FINE_N} pallas_prom normal f32",
               lambda: rf.pallas_prom(grid, vu, vv, dmask, y0, DT,
                                      ROM_STEPS, *MU, tile_rows=tr),
               "gn_full", ROM_STEPS, launches, prom, basis, hdm)


def phase_ecsw_recipe(card, launches):
    """The HPROM offline recipe end to end at 64^2 (f64): training
    matrix on the card, host NNLS, the HPROM on the card and on the
    CPU. Returns the grid, basis, snapshot pairs and training matrix for
    the weight-method phase."""
    grid = Grid2D(nx=RECIPE_N, ny=RECIPE_N)
    w0 = torch.ones(grid.state_dim, dtype=F64, device=DEVICE)
    snaps = inviscid_burgers_implicit2d_skewed(grid, w0, DT, ROM_STEPS,
                                               *MU_TRAIN).snaps
    basis, _ = pod(snaps, num_modes=MODES)
    t = ROM_STEPS
    pairs = (snaps[:, 3:t:SNAP_STRIDE], snaps[:, 0:t - 3:SNAP_STRIDE])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = ecsw_training_matrix(grid, *pairs, basis, *MU_TRAIN, DT)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    c_cpu = ecsw_training_matrix(grid, *(p.cpu() for p in pairs),
                                 basis.cpu(), *MU_TRAIN, DT)
    diff = rel_err(c.cpu(), c_cpu)
    check(diff < 1e-12, f"training matrix card vs CPU: rel {diff}")
    t2 = time.perf_counter()
    weights = compute_ecsw_weights(c, grid, bc_w=RING_WEIGHT,
                                   rel_err_thresh=1e-4)
    t3 = time.perf_counter()
    n_e = int((weights > 0).sum())
    check(0 < n_e < grid.n_cells and bool(np.all(weights >= 0)),
          f"ECSW weights: {n_e} positive of {grid.n_cells}")
    print(f"[ecsw] {RECIPE_N}x{RECIPE_N}, {MODES} modes: training matrix "
          f"{tuple(c.shape)} on the card in {t1 - t0:.3f} s (rel vs CPU "
          f"{diff:.1e}); host nnls_gram in {t3 - t2:.2f} s: N_e {n_e} "
          f"({card})")
    hdm = inviscid_burgers_implicit2d_skewed(grid, w0, DT, ROM_STEPS,
                                             *MU).snaps
    runs = {}
    for dev in (DEVICE, "cpu"):
        b = basis.to(dev)
        mesh, sw, ba = prepare_hprom(grid, weights, b)
        y0 = b.T @ w0.to(dev)
        p6p, wgt_p = rf.precompute_pallas_system(
            rf.precompute_factored_blocks(mesh, ba), sw, dtype=F64)
        reset_gn_counts()
        generic = ecsw_hprom(grid, mesh, sw, y0, ba, DT, ROM_STEPS, *MU,
                             ls_method="normal")
        kernel = rf.pallas_hprom(grid, mesh, p6p, wgt_p, y0, DT, ROM_STEPS,
                                 *MU)
        counts = gn_counts()
        runs[dev] = (generic, kernel)
        if dev == DEVICE:
            check(counts["gn_sampled_system"] == kernel.gn_evals > 0,
                  f"recipe HPROM: {counts} launches for {kernel.gn_evals} "
                  f"calls")
            launches["gn_sampled_system"] += counts["gn_sampled_system"]
    (g_card, k_card), (g_cpu, k_cpu) = runs[DEVICE], runs["cpu"]
    for label, a, b in (("ecsw_hprom", g_card, g_cpu),
                        ("pallas_hprom", k_card, k_cpu)):
        diff = rel_err(a.red_coords.cpu(), b.red_coords)
        check(diff < 1e-10 and a.total_gn_its == b.total_gn_its,
              f"recipe {label} card vs CPU: rel {diff}, its "
              f"{a.total_gn_its} vs {b.total_gn_its}")
        print(f"[ecsw] {label} f64 {ROM_STEPS} steps card vs CPU: rel "
              f"{diff:.3e}, {a.total_gn_its} GN its on both, error vs FOM "
              f"{err_pct(basis, a, hdm):.4f}%")
    diff = rel_err(k_card.red_coords, g_card.red_coords)
    check(diff < 1e-10, f"recipe pallas_hprom vs ecsw_hprom: rel {diff}")
    print(f"[ecsw] pallas_hprom vs ecsw_hprom on the card: rel {diff:.3e}")
    return grid, basis, pairs, c


# ----------------------------------------------------------------------
# the segmented wavefront solve (B7), the whole-trajectory
# kernel (B6) and the μ sweeps
# ----------------------------------------------------------------------

def band_cells_per_diagonal(lay):
    return sk.valid_mask(lay, F64).sum(dim=1).long().tolist()


def seg_cells(lay, n_seg, overlap):
    """Band cells the segmented solve processes, warm-ups included."""
    per_diag = band_cells_per_diagonal(lay)
    seg_len = sk.segment_length(lay, n_seg)
    total = 0
    for g in range(n_seg):
        lo = max(0, g * seg_len - overlap)
        hi = min(lay.nd_pad, (g + 1) * seg_len)
        total += sum(per_diag[lo:hi])
    return total


# [seg-kernel] layouts, (nx, ny, n_seg, overlap): the main path's; ny_pad
# 1024 (2 rows a lane, 16 warps) and 2176 (8 rows a lane, 9 warps, the last
# one half empty: no multiple of the 256 rows a warp holds); ny far below
# and far above nx; n_seg not dividing nd_pad; overlap 0 and overlap >=
# seg_len; trailing segments that own nothing; one segment (the exact
# solve, B1's bits) in each band of rows a lane (ny_pad 128, 1152, 2048,
# 2176)
SEG_LAYOUTS = [(750, 750, 8, 64), (750, 750, 16, 64), (40, 1000, 4, 32),
              (20, 2100, 16, 8), (1000, 40, 8, 64), (30, 900, 8, 64),
              (750, 750, 7, 64), (750, 750, 8, 0), (200, 200, 8, 100),
              (13, 5, 14, 0), (13, 5, 4, 16), (64, 64, 1, 0),
              (40, 1100, 1, 0), (20, 2000, 1, 0), (20, 2100, 1, 0)]


def seg_layout_check(nx, ny, n_seg, overlap, dtype):
    """B7 against its plain version on one layout: within KERNEL_TOL,
    exact zeros off the band, two runs bit-equal, and with one segment
    and no overlap bit-equal to B1's exact solve. Returns the relative
    error."""
    grid = Grid2D(nx=nx, ny=ny)
    lay = sk.make_layout(grid)
    off_band = ~sk.valid_mask(lay, torch.bool, DEVICE)
    kw = dict(n_seg=n_seg, overlap=overlap)
    args = skewed_inputs(lay, dtype, seed=nx + ny)
    got = cw.solve_skewed_seg_cuda(*args, DT, grid, lay, **kw)
    again = cw.solve_skewed_seg_cuda(*args, DT, grid, lay, **kw)
    want = sk.solve_skewed_seg_ref(*args, DT, grid, lay, **kw)
    torch.cuda.synchronize()
    what = f"seg kernel {nx}x{ny} {kw} {dtype}"
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{what}: not finite")
    rel = max(rel_err(g, w) for g, w in zip(got, want))
    check(rel <= KERNEL_TOL[dtype], f"{what}: rel {rel}")
    check(all(bool((g[off_band] == 0).all()) for g in got),
          f"{what}: nonzero off the band")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: two runs differ")
    if n_seg == 1 and overlap == 0:
        exact = cw.solve_skewed_cuda(*args, DT, grid, lay)
        check(all(torch.equal(g, e) for g, e in zip(got, exact)),
              f"{what}: one segment differs from B1")
    return rel


def phase_seg_kernel(card):
    """B7 against its plain version and beside B1 at the 750^2 layout;
    returns {dtype: numbers}."""
    grid = Grid2D(nx=MAIN_N, ny=MAIN_N)
    lay = sk.make_layout(grid)
    off_band = ~sk.valid_mask(lay, torch.bool, DEVICE)
    cells = seg_cells(lay, SEG, SEG_OVERLAP)
    out = {}
    for dtype in (F32, F64):
        args = skewed_inputs(lay, dtype, seed=7)
        kw = dict(n_seg=SEG, overlap=SEG_OVERLAP)
        got = cw.solve_skewed_seg_cuda(*args, DT, grid, lay, **kw)
        want = sk.solve_skewed_seg_ref(*args, DT, grid, lay, **kw)
        exact = cw.solve_skewed_cuda(*args, DT, grid, lay)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got),
              "seg kernel output not finite")
        rel = max(rel_err(g, w) for g, w in zip(got, want))
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(rel <= KERNEL_TOL[dtype], f"seg kernel vs plain {dtype}: rel "
              f"{rel}")
        check(all(bool((g[off_band] == 0).all()) for g in got),
              f"seg kernel {dtype}: nonzero off the band")
        again = cw.solve_skewed_seg_cuda(*args, DT, grid, lay, **kw)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"seg kernel {dtype}: two runs differ")
        vs_exact = max(rel_err(g, e) for g, e in zip(got, exact))
        check(vs_exact < 1e-4, f"seg kernel {dtype} vs the exact solve: rel "
              f"{vs_exact}")
        ms = cuda_ms(lambda: cw.solve_skewed_seg_cuda(*args, DT, grid, lay,
                                                      **kw), calls=50)
        b1_ms = cuda_ms(lambda: cw.solve_skewed_cuda(*args, DT, grid, lay),
                        calls=50)
        plain_ms = cuda_ms(lambda: sk.solve_skewed_seg_ref(
            *args, DT, grid, lay, **kw), calls=1)
        nbytes = 6 * grid.n_cells * args[0].element_size()
        bound_ms, bound_by = bound(nbytes, WAVEFRONT_OPS * cells, dtype)
        print(f"[seg-kernel] {MAIN_N}x{MAIN_N} layout {lay.nd_pad}x"
              f"{lay.ny_pad} n_seg {SEG} overlap {SEG_OVERLAP} "
              f"{str(dtype)[6:]}: rel {rel:.3e} max_abs {abs_err:.3e} vs "
              f"plain, zeros off band ok, rel {vs_exact:.3e} vs B1's exact "
              f"solve; kernel {ms:.4f} ms (B1 {b1_ms:.4f} ms), plain "
              f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
              f"({card})")
        out[dtype] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                          b1_ms=b1_ms, rel_vs_exact=vs_exact,
                          bound_ms=bound_ms, bound_by=bound_by)
    for layout in SEG_LAYOUTS[1:]:
        rels = [seg_layout_check(*layout, dtype) for dtype in (F32, F64)]
        print(f"[seg-kernel] (nx, ny, n_seg, overlap) {layout}: rel "
              f"{rels[0]:.3e} f32, {rels[1]:.3e} f64 vs plain, zeros off "
              f"band, two runs bit-equal ({card})")
    return out


def phase_main_seg(card, exact_final):
    """The 750^2 trajectory with the segmented solve (bench.py:168-200);
    returns its B7 launches and R1's [update, step constant] launches."""
    grid = Grid2D(nx=MAIN_N, ny=MAIN_N)
    w0 = torch.ones(grid.state_dim, dtype=F64, device=DEVICE)
    total = 0
    r1 = [0, 0]

    def run(steps):
        nonlocal total
        cw.LAUNCHES = 0
        cw.SEG_LAUNCHES = 0
        reset_residual_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inviscid_burgers_implicit2d_skewed(
            grid, w0, DT, steps, MU[0], MU[1], solve_dtype=F32,
            snaps_dtype=F32, seg=SEG, seg_overlap=SEG_OVERLAP)
        checksum = float(res.snaps.sum(dtype=F64))
        elapsed = time.perf_counter() - t0
        check(cw.SEG_LAUNCHES == res.total_newton_its > 0
              and cw.LAUNCHES == 0,
              f"main-seg: {cw.SEG_LAUNCHES} seg and {cw.LAUNCHES} exact "
              f"launches for {res.total_newton_its} Newton iterations")
        check(np.isfinite(checksum), "main-seg: trajectory not finite")
        total += cw.SEG_LAUNCHES
        for i, n in enumerate(residual_counts(
                "main-seg", res.total_newton_its, steps)):
            r1[i] += n
        return res, elapsed

    run(WARM_STEPS)
    rates, its = [], []
    for _ in range(REPS):
        res, elapsed = run(MEAS_STEPS)
        rates.append(MEAS_STEPS / elapsed)
        its.append(res.total_newton_its / MEAS_STEPS)
    diff = rel_err(res.snaps[:, -1], exact_final)
    check(diff < 1e-4, f"main-seg: final state rel {diff} vs the exact "
          f"chain")
    print(f"[main-seg] {MAIN_N}x{MAIN_N} seg={SEG} overlap={SEG_OVERLAP}, "
          f"f32 solves, "
          f"f64 Newton, f32 snapshots: {statistics.median(rates):.3f} "
          f"steps/s (median of {REPS} x {MEAS_STEPS} steps; runs "
          f"{', '.join(f'{r:.3f}' for r in rates)}), "
          f"{statistics.median(its):.2f} Newton its/step, one B7 and one "
          f"R1 launch per iteration, final state rel {diff:.3e} vs the "
          f"exact chain ({card})")
    return total, r1


def traj_inputs(n, k, n_cells, dtype, b, seed=11, device="cuda"):
    """B6 on an n^2 grid: a random orthonormal k-mode basis, n_cells
    weighted sampled cells, the padded blocks, and b μ points' y0 and
    source columns (the shape of tests/test_torch_cuda_traj.py's problem;
    n = 250, n_cells = 1508 is the bench mesh's layout (6, 1536, 128))."""
    grid = Grid2D(nx=n, ny=n)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((grid.state_dim, k), generator=gen,
                                       dtype=F64, device=device))
    weights = np.zeros(grid.n_cells)
    weights[rng.choice(grid.n_cells, size=n_cells, replace=False)] = \
        1 + rng.uniform(size=n_cells)
    basis = q.to(dtype)
    mesh, sw, ba = prepare_hprom(grid, weights, basis)
    # the bench mesh pads to 256 cells, the small ones to 8 (a last chunk
    # of 32 cells that is ragged)
    p6p, wgt_p = rf.precompute_pallas_system(
        rf.precompute_factored_blocks(mesh, ba), sw,
        tile=256 if n_cells > 1000 else 8, dtype=dtype)
    y0 = basis.T @ torch.ones(grid.state_dim, dtype=dtype, device=device)
    slbc = torch.stack([rf.traj_source(grid, mesh, DT, *mu, p6p.shape[1],
                                       dtype) for mu in SWEEP_MUS[:b]])
    hd = (0.5 * DT / grid.dx, 0.5 * DT / grid.dy)
    return p6p, y0.expand(b, -1).contiguous(), slbc, wgt_p, k, *hd


def traj_bound(p6p, wgt_p, k, steps, b, its, evals, iters=rf.CG_ITERS):
    """B6's bound for one launch, from the systems it built and the
    updates it made, over the live lanes of the cells of nonzero
    weight."""
    n_p = int(torch.count_nonzero(wgt_p))
    e = p6p.element_size()
    nbytes = (6 * n_p * k + n_p + b * n_p + b * k + b * steps * k) * e
    scalars = 12 * n_p * k
    per_eval = scalars + 18 * n_p * k + gram_ops(2 * n_p, k)
    cg_ops = iters * (2 * k * k + 10 * k)
    ops = evals * per_eval + its * cg_ops + b * steps * scalars
    return bound(nbytes, ops, p6p.dtype)


def phase_traj_kernel(card, ctx):
    """B6 against its plain version on the bench mesh layout, 50 steps,
    1 and 9 trajectories, f32 and f64; returns {(b, dtype): numbers}."""
    grid, mesh = ctx["grid"], ctx["mesh"]
    hd = (0.5 * DT / grid.dx, 0.5 * DT / grid.dy)
    blocks = rf.precompute_factored_blocks(mesh, ctx["ba"])
    out = {}
    for dtype in (F32, F64):
        p6p, wgt_p = rf.precompute_pallas_system(blocks, ctx["sw32"],
                                                 dtype=dtype)
        n_p, k = p6p.shape[1], ctx["y0"].shape[0]
        single = None
        for b in (1, 9):
            y0 = ctx["y0"].to(dtype).expand(b, -1).contiguous()
            slbc = torch.stack([rf.traj_source(grid, mesh, DT, *mu, n_p,
                                               dtype)
                                for mu in SWEEP_MUS[:b]])
            args = (p6p, y0, slbc, wgt_p, k, *hd, TRAJ_STEPS)
            ys, its, evals = cg.gn_traj_cuda(*args)
            again = cg.gn_traj_cuda(*args)
            plain_ms, want = cuda_ms_once(
                lambda: gn.trajectory_hprom_ref(*args))
            check(bool(torch.isfinite(ys).all()), "traj kernel not finite")
            check(all(torch.equal(a, x) for a, x in zip((ys, its, evals),
                                                        again)),
                  f"traj kernel b={b} {dtype}: two runs differ")
            if b == 1:
                single = ys
            else:
                check(torch.equal(single[0], ys[0]),
                      f"traj kernel {dtype}: the b = 1 run differs from "
                      f"its row of the b = 9 launch")
            rel = rel_err(ys, want.ys)
            abs_err = float((ys - want.ys).abs().max())
            tol = 1e-10 if dtype == F64 else 1e-4
            check(rel <= tol, f"traj kernel vs plain b={b} {dtype}: rel "
                  f"{rel}")
            if dtype == F64:
                check(torch.equal(its, want.its),
                      f"traj kernel its {its.tolist()} vs plain "
                      f"{want.its.tolist()}")
            ms = cuda_ms(lambda: cg.gn_traj_cuda(*args), calls=1)
            bound_ms, bound_by = traj_bound(p6p, wgt_p, k, TRAJ_STEPS, b,
                                            int(its.sum()),
                                            int(evals.sum()))
            print(f"[traj-kernel] {ROM_N}x{ROM_N} mesh layout "
                  f"{tuple(p6p.shape)} {str(dtype)[6:]} {b} trajectories x "
                  f"{TRAJ_STEPS} steps: rel {rel:.3e} max_abs "
                  f"{abs_err:.3e} (tol {tol:g}), GN its {int(its.sum())} "
                  f"(plain {int(want.its.sum())}), systems built "
                  f"{int(evals.sum())}; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.1f} ms (one run), bound {bound_ms:.4f} ms "
                  f"({bound_by}) ({card})")
            out[(b, dtype)] = dict(max_abs_err=abs_err, rel_err=rel, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
    print(f"[traj-kernel] two runs bit-equal, and each b = 1 run bit-equal "
          f"to its row of the b = 9 launch ({card})")
    traj_kernel_ragged(card)
    return out


def traj_kernel_ragged(card):
    """B6 where its geometry is uneven: k = 150 (kp 256, 160 live lanes)
    in f32 on a 24^2 grid whose 220 sampled cells pad to 224, 7 chunks
    of 32 for the cluster's 8 CTAs; 9 points against plain, two runs,
    b = 1 against its row."""
    args = traj_inputs(24, 150, 220, F32, 9)
    p6p, k = args[0], args[4]
    geo = cg.traj_geometry(p6p.shape[1], k, p6p.element_size())
    check(geo.n_chunks % geo.cluster != 0 and p6p.shape[2] == 256,
          f"traj ragged layout is even: {geo}")
    got = cg.gn_traj_cuda(*args, TRAJ_STEPS)
    again = cg.gn_traj_cuda(*args, TRAJ_STEPS)
    one = cg.gn_traj_cuda(args[0], args[1][:1].contiguous(),
                          args[2][:1].contiguous(), *args[3:], TRAJ_STEPS)
    want = gn.trajectory_hprom_ref(*args, TRAJ_STEPS)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got[0]).all()), "traj ragged: not finite")
    rel = rel_err(got[0], want.ys)
    check(rel <= 1e-4, f"traj ragged k 150 f32: rel {rel}")
    check(all(torch.equal(a, x) for a, x in zip(got, again)),
          "traj ragged: two runs differ")
    check(torch.equal(one[0][0], got[0][0]),
          "traj ragged: the b = 1 run differs from its row of b = 9")
    print(f"[traj-kernel] 24x24 k 150 layout {tuple(p6p.shape)} f32 9 "
          f"trajectories x {TRAJ_STEPS} steps, {geo.n_chunks} chunks over "
          f"{geo.cluster} CTAs, {geo.lanes} live lanes: rel {rel:.3e} (tol "
          f"1e-4), GN its {int(got[1].sum())} (plain {int(want.its.sum())}),"
          f" two runs and b = 1 bit-equal ({card})")


def phase_rom_traj(card, ctx, launches):
    """pallas_traj_hprom (one launch a run) and tensor_hprom on the bench
    mesh, against ecsw_hprom and the FOM."""
    grid, mesh, y0 = ctx["grid"], ctx["mesh"], ctx["y0"]
    steps = ROM_STEPS

    def engine(label, fn, kernel=None):
        return run_engine(f"{ROM_N}x{ROM_N} {label} f32", fn, kernel, steps,
                          launches, ctx["hprom"], ctx["basis"], ctx["hdm"])

    res = engine("pallas_traj_hprom unroll3", lambda: rf.pallas_traj_hprom(
        grid, mesh, ctx["p6p"], ctx["wgt_p"], y0, DT, steps, *MU),
        "gn_traj")
    check(res.gn_evals == 1, "pallas_traj_hprom: not one launch per run")
    t0 = time.perf_counter()
    tens = rt.precompute_hprom_tensors(grid, mesh, ctx["sw32"], ctx["ba"], DT)
    torch.cuda.synchronize()
    print(f"[rom] {ROM_N}x{ROM_N} tensor_hprom operators: H "
          f"{tuple(tens.h.shape)} in {time.perf_counter() - t0:.2f} s")
    t32 = engine("tensor_hprom normal", lambda: rt.tensor_hprom(
        grid, mesh, ctx["sw32"], y0, tens, DT, steps, *MU,
        ls_method="normal"))
    # the same pair in float64: is the f32 difference rounding of the
    # precomputed operators, or a fault?
    sw64, ba64, y64 = ctx["sw32"].to(F64), ctx["ba"].to(F64), y0.to(F64)
    ref64 = ecsw_hprom(grid, mesh, sw64, y64, ba64, DT, steps, *MU,
                       ls_method="normal")
    tens64 = rt.precompute_hprom_tensors(grid, mesh, sw64, ba64, DT)
    t64 = rt.tensor_hprom(grid, mesh, sw64, y64, tens64, DT, steps, *MU,
                          ls_method="normal")
    diff32 = rel_err(t32.red_coords, ctx["hprom"].red_coords)
    diff64 = rel_err(t64.red_coords, ref64.red_coords)
    check(diff64 < ENGINE_TOL, f"tensor_hprom f64 vs ecsw_hprom f64: rel "
          f"{diff64}")
    print(f"[rom] {ROM_N}x{ROM_N} tensor_hprom vs ecsw_hprom: rel "
          f"{diff32:.3e} in f32, {diff64:.3e} in f64 ({t64.total_gn_its} "
          f"and {ref64.total_gn_its} GN its in f64); f32 ecsw_hprom vs f64 "
          f"ecsw_hprom rel "
          f"{rel_err(ctx['hprom'].red_coords, ref64.red_coords):.3e} "
          f"({card})")


def phase_sweep(card, ctx, gn_launches):
    """The 9-point μ grid at 250^2: the HPROM sweeps (pallas_traj for 500
    steps, generic and factored for CUT_STEPS) and the seg FOM sweep for
    100 steps; returns the B7 launches and R1's [update, step constant]
    launches."""
    grid, mesh, y0 = ctx["grid"], ctx["mesh"], ctx["y0"]
    sw32, ba = ctx["sw32"], ctx["ba"]
    n = len(SWEEP_MUS)

    def timed(fn):
        reset_gn_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        check(bool(torch.isfinite(out).all()), "sweep not finite")
        return out, time.perf_counter() - t0, gn_counts()

    blocks = rf.precompute_factored_blocks(mesh, ba)

    def single(engine, mu, steps):
        """The point's own run of the engine the sweep runs."""
        if engine == "pallas_traj":
            res = rf.pallas_traj_hprom(grid, mesh, ctx["p6p"], ctx["wgt_p"],
                                       y0, DT, steps, *mu)
        elif engine == "factored":
            res = rf.factored_hprom(grid, mesh, sw32, y0, blocks, DT, steps,
                                    *mu, ls_method="normal")
        else:
            res = ecsw_hprom(grid, mesh, sw32, y0, ba, DT, steps, *mu,
                             ls_method="normal")
        return res.red_coords

    for engine, kw, reps, steps in (
            ("generic", dict(ls_method="normal"), 1, CUT_STEPS),
            ("factored", dict(ls_method="normal"), 1, CUT_STEPS),
            ("pallas_traj", dict(unroll_its=3), REPS, ROM_STEPS)):
        runs = [timed(lambda kw=kw, steps=steps: sweep_hprom(
            grid, mesh, sw32, y0, ba, DT, steps, SWEEP_MUS, engine=engine,
            **kw)) for _ in range(reps)]
        red, _, counts = runs[-1]
        check(tuple(red.shape) == (n, y0.shape[0], steps + 1),
              f"sweep {engine}: shape {tuple(red.shape)}")
        rate = statistics.median(n * steps / t for _, t, _ in runs)
        line = (f"[sweep] {ROM_N}x{ROM_N} {n}-point sweep_hprom {engine} "
                f"f32 x {steps} steps: {rate:.2f} aggregate steps/s "
                f"(median of {reps}; runs "
                f"{', '.join(f'{n * steps / t:.2f}' for _, t, _ in runs)})")
        if engine == "pallas_traj":
            check(counts == {**{k: 0 for k in GN_KERNELS}, "gn_traj": 1},
                  f"pallas_traj sweep: launches {counts}, expected one B6")
            gn_launches["gn_traj"] += counts["gn_traj"]
            line += ", one B6 launch for all 9 points"
        worst = max(rel_err(red[i], single(engine, mu, steps))
                    for i, mu in enumerate(SWEEP_MUS))
        check(worst <= 1e-6, f"sweep {engine} vs single points: rel {worst}")
        print(line + f", worst rel {worst:.1e} against the {n} single-point "
              f"runs ({card})")

    w0 = torch.ones(grid.state_dim, dtype=F64, device=DEVICE)
    kw = dict(engine="skewed", solve_dtype=F32, snaps_dtype=F32, seg=SEG,
              seg_overlap=SEG_OVERLAP)
    sweep_fom(grid, w0, DT, WARM_STEPS, SWEEP_MUS[:1], **kw)
    cw.LAUNCHES = 0
    cw.SEG_LAUNCHES = 0
    reset_residual_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = sweep_fom(grid, w0, DT, SWEEP_FOM_STEPS, SWEEP_MUS, **kw)
    check(bool(torch.isfinite(snaps).all()), "seg FOM sweep not finite")
    elapsed = time.perf_counter() - t0
    launches = cw.SEG_LAUNCHES
    check(launches > 0 and cw.LAUNCHES == 0,
          f"seg FOM sweep: {launches} seg and {cw.LAUNCHES} exact launches")
    r1 = residual_counts("seg FOM sweep", launches, n * SWEEP_FOM_STEPS)
    check(tuple(snaps.shape) == (n, grid.state_dim, SWEEP_FOM_STEPS + 1),
          f"seg FOM sweep: shape {tuple(snaps.shape)}")
    print(f"[sweep] {ROM_N}x{ROM_N} {n}-point sweep_fom skewed seg={SEG} x "
          f"{SWEEP_FOM_STEPS} steps (f32 solves, f64 Newton): "
          f"{n * SWEEP_FOM_STEPS / elapsed:.2f} aggregate steps/s, "
          f"{launches} B7 launches ({launches / (n * SWEEP_FOM_STEPS):.2f} "
          f"per step), R1 {r1[0]} + {r1[1]} ({card})")
    return launches, list(r1)


# ----------------------------------------------------------------------
# [spatial]: the multi-rank paths over torch.distributed
# ----------------------------------------------------------------------

def _spatial_ranks(bench):
    """One of the SPATIAL_GLOO_RANKS gloo ranks (rank r on card r % the
    cards; on one card they share it): the
    sharded skewed trajectory at 750^2 (float64, SPATIAL_STEPS steps; its
    seconds and halo exchanges), then over a dp mesh the skewed FOM sweep
    of SPATIAL_SWEEP_MUS at 250^2 and the 9-point whole-trajectory sweep
    on the [rom] bench mesh, each with this rank's B1 and B6 launch counts
    set to 0 just before and read just after; every rank's counts are
    gathered."""
    from finitedifference_tpu_torch.ops.sampled import SampledMesh
    from finitedifference_tpu_torch.parallel import mesh as pm
    from finitedifference_tpu_torch.parallel.spatial import (
        sharded_skewed_fom,
    )
    from finitedifference_tpu_torch.parallel.sweep import (
        make_sweep_mesh,
        pad_to_multiple,
    )

    dev = pm.rank_device()
    sp = pm.make_mesh((SPATIAL_GLOO_RANKS,), ("sp",))
    dp = make_sweep_mesh()
    grid = Grid2D(nx=SPATIAL_N, ny=SPATIAL_N)
    w0 = torch.ones(grid.state_dim, dtype=F64, device=dev)
    torch.cuda.synchronize()
    exchanges, t0 = pm.EXCHANGES, time.perf_counter()
    snaps, its = sharded_skewed_fom(sp, grid, w0, DT, SPATIAL_STEPS, *MU)
    torch.cuda.synchronize()
    skewed = (snaps, its, time.perf_counter() - t0,
              pm.EXCHANGES - exchanges)

    g = Grid2D(nx=ROM_N, ny=ROM_N)
    cw.LAUNCHES = 0
    fom = sweep_fom(g, torch.ones(g.state_dim, dtype=F64, device=dev), DT,
                    SPATIAL_SWEEP_STEPS, SPATIAL_SWEEP_MUS, mesh=dp,
                    engine="skewed")
    b1 = cw.LAUNCHES
    mesh = SampledMesh(*(t.to(dev) for t in bench["mesh"]))
    mus, _ = pad_to_multiple(np.asarray(SWEEP_MUS), SPATIAL_GLOO_RANKS)
    cg.TRAJ_LAUNCHES = 0
    traj = sweep_hprom(g, mesh, bench["sw32"].to(dev), bench["y0"].to(dev),
                       bench["ba"].to(dev), DT, ROM_STEPS, mus, mesh=dp,
                       engine="pallas_traj", unroll_its=3)
    b6 = cg.TRAJ_LAUNCHES
    counts = pm.all_gather(torch.tensor([[b1, b6]], device=dev), dp, "dp")
    return dict(skewed=skewed, fom=fom, traj=traj, counts=counts)


def spatial_cards(card, n_cards):
    """[spatial] on more than one card, over NCCL, one rank a card:
    run_sweep's card mesh (its 3x3 FOM sweep at 250^2, f32 snapshots,
    padded to a multiple of the cards) against the same sweep on card 0,
    bit for bit, then entry.dryrun_multichip(n_cards)."""
    from finitedifference_tpu_torch.entry import dryrun_multichip
    from finitedifference_tpu_torch.parallel.sweep import pad_to_multiple
    from finitedifference_tpu_torch.runners import run_sweep
    from finitedifference_tpu_torch.runners.common import (
        default_config,
        make_problem,
    )

    cfg = default_config(ROM_N, SPATIAL_SWEEP_STEPS)
    mus = np.array([[m1, m2] for m1 in np.linspace(*cfg.mu1_range, 3)
                    for m2 in np.linspace(*cfg.mu2_range, 3)])
    padded, n_real = pad_to_multiple(mus, n_cards)
    t0 = time.perf_counter()
    el, got = run_sweep._run_sharded(n_cards, padded, n_real, "fom", MODES,
                                     cfg, True, "skewed",
                                     timeout=SPATIAL_TIMEOUT)
    wall = time.perf_counter() - t0
    grid, w0 = make_problem(cfg)
    one = sweep_fom(grid, torch.as_tensor(w0, dtype=F32, device=DEVICE),
                    cfg.dt, SPATIAL_SWEEP_STEPS, padded, engine="skewed",
                    snaps_dtype=F32)
    check(torch.equal(got.to(DEVICE), one),
          f"run_sweep over {n_cards} cards differs from one card")
    print(f"[spatial] {ROM_N}x{ROM_N} run_sweep --model fom over {n_cards} "
          f"NCCL ranks, one a card: {n_real} points padded to "
          f"{len(padded)} x {SPATIAL_SWEEP_STEPS} steps in {el:.2f} s "
          f"({wall:.1f} s with the ranks' start), bit-equal to the sweep "
          f"on card 0 ({card})")
    t0 = time.perf_counter()
    dry = dryrun_multichip(n_cards, device=DEVICE, timeout=SPATIAL_TIMEOUT)
    print(f"[spatial] dryrun_multichip({n_cards}) over NCCL, one rank a "
          f"card, dp {dry['dp']} x sp {dry['sp']}: (dp, sp) FOM step max "
          f"abs diff {dry['step_err']:.1e} against a 1x1 mesh, dp training "
          f"loss {dry['train_loss']:.4e}, sharded skewed 64x64 "
          f"{dry['skewed_its']} Newton its (max abs diff "
          f"{dry['skewed_err']:.1e}), sharded HPROM {dry['hprom_gn_its']} GN "
          f"its (max abs diff {dry['hprom_err']:.1e}); passed in "
          f"{time.perf_counter() - t0:.1f} s ({card})")


def phase_spatial(card, ctx):
    """[spatial] The multi-rank paths (parallel/mesh, parallel/spatial,
    the sweeps' mesh=) on the cards: run_fom --spatial-shard over one NCCL
    rank a card at 750^2 (with more than one card, spatial_cards too);
    two gloo ranks (_spatial_ranks), sharing the card on one card, each
    held against the unsharded port in this process; then
    entry.dryrun_multichip over four gloo ranks. Returns the ranks' (B1,
    B6) launches."""
    from finitedifference_tpu_torch.entry import dryrun_multichip
    from finitedifference_tpu_torch.parallel.mesh import spawn
    from finitedifference_tpu_torch.runners import run_fom
    from finitedifference_tpu_torch.snapshots import param_to_snap_fn

    t_phase = time.perf_counter()
    tag = f"[spatial] {SPATIAL_N}x{SPATIAL_N}"
    grid = Grid2D(nx=SPATIAL_N, ny=SPATIAL_N)
    w0 = torch.ones(grid.state_dim, dtype=F64, device=DEVICE)
    ref = inviscid_burgers_implicit2d_skewed(grid, w0, DT, SPATIAL_STEPS,
                                             *MU)
    n_cards = torch.cuda.device_count()

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            elapsed, _ = run_fom.main(*MU, num_cells=SPATIAL_N,
                                      num_steps=SPATIAL_NCCL_STEPS,
                                      device=DEVICE, spatial_shard=n_cards)
            cfg = BurgersConfig().with_cells(SPATIAL_N)
            saved = torch.as_tensor(np.load(param_to_snap_fn(
                list(MU), snap_folder=cfg.snap_folder)), device=DEVICE)
        finally:
            os.chdir(here)
    err = rel_err(saved, ref.snaps[:, :SPATIAL_NCCL_STEPS + 1])
    check(err <= SPATIAL_TOL, f"run_fom --spatial-shard {n_cards}: rel {err}")
    print(f"{tag} run_fom --spatial-shard {n_cards}: {n_cards} NCCL rank(s), "
          f"one a card, f64 x {SPATIAL_NCCL_STEPS} steps: "
          f"{1e3 * elapsed / SPATIAL_NCCL_STEPS:.1f} ms a step (rank 0's "
          f"wall clock), rel {err:.3e} against the unsharded engine (B1) "
          f"({card})")
    if n_cards > 1:
        spatial_cards(card, n_cards)

    def placed(n_ranks):
        return ("sharing card 0" if n_cards == 1 else
                f"on {min(n_ranks, n_cards)} cards (rank r on card r % "
                f"{n_cards})")

    bench = {"mesh": type(ctx["mesh"])(*(t.cpu() for t in ctx["mesh"])),
             "sw32": ctx["sw32"].cpu(), "y0": ctx["y0"].cpu(),
             "ba": ctx["ba"].cpu()}
    t0 = time.perf_counter()
    out = spawn(_spatial_ranks, SPATIAL_GLOO_RANKS, bench, device=DEVICE,
                backend="gloo", timeout=SPATIAL_TIMEOUT)
    wall = time.perf_counter() - t0
    snaps, its, sec, exchanges = out["skewed"]
    err = rel_err(snaps.to(DEVICE), ref.snaps)
    check(err <= SPATIAL_TOL and its == ref.total_newton_its,
          f"sharded skewed FOM: rel {err}, {its} Newton its against "
          f"{ref.total_newton_its}")
    print(f"{tag} sharded_skewed_fom over {SPATIAL_GLOO_RANKS} gloo ranks "
          f"{placed(SPATIAL_GLOO_RANKS)}, f64 x {SPATIAL_STEPS} steps: {its} Newton its "
          f"(unsharded {ref.total_newton_its}), rel {err:.3e} against B1's "
          f"unsharded engine; {1e3 * sec / SPATIAL_STEPS:.1f} ms a step, "
          f"{exchanges} halo exchanges through the host, "
          f"{1e3 * sec / exchanges:.3f} ms an exchange with its diagonal "
          f"({card})")

    g = Grid2D(nx=ROM_N, ny=ROM_N)
    fom = sweep_fom(g, torch.ones(g.state_dim, dtype=F64, device=DEVICE), DT,
                    SPATIAL_SWEEP_STEPS, SPATIAL_SWEEP_MUS, engine="skewed")
    err = rel_err(out["fom"].to(DEVICE), fom)
    check(err <= SPATIAL_TOL, f"sweep_fom over dp: rel {err}")
    traj = sweep_hprom(g, ctx["mesh"], ctx["sw32"], ctx["y0"], ctx["ba"], DT,
                       ROM_STEPS, SWEEP_MUS, engine="pallas_traj",
                       unroll_its=3)
    n = len(SWEEP_MUS)
    check(torch.equal(out["traj"][:n].to(DEVICE), traj),
          "pallas_traj sweep over dp: rows differ from the unsharded launch")
    counts = out["counts"].tolist()
    check(all(b1 > 0 and b6 > 0 for b1, b6 in counts),
          f"[spatial] ranks' (B1, B6) launches {counts}")
    print(f"[spatial] {ROM_N}x{ROM_N} over dp = {SPATIAL_GLOO_RANKS} gloo "
          f"ranks: sweep_fom skewed {len(SPATIAL_SWEEP_MUS)} points x "
          f"{SPATIAL_SWEEP_STEPS} steps rel {err:.3e} against the unsharded "
          f"sweep; the {n}-point sweep_hprom pallas_traj x {ROM_STEPS} "
          f"steps (padded to {out['traj'].shape[0]}) bit-equal row by row to "
          f"the unsharded launch; ranks' (B1, B6) launches {counts}; "
          f"{wall:.1f} s with the ranks' start ({card})")

    t0 = time.perf_counter()
    dry = dryrun_multichip(SPATIAL_DRYRUN_RANKS, device=DEVICE,
                           backend="gloo", timeout=SPATIAL_TIMEOUT)
    print(f"[spatial] dryrun_multichip({SPATIAL_DRYRUN_RANKS}) over gloo "
          f"ranks {placed(SPATIAL_DRYRUN_RANKS)}, dp {dry['dp']} x sp {dry['sp']}: (dp, sp) "
          f"FOM step max abs diff {dry['step_err']:.1e} against a 1x1 mesh, "
          f"dp training loss {dry['train_loss']:.4e}, sharded skewed 64x64 "
          f"{dry['skewed_its']} Newton its (max abs diff "
          f"{dry['skewed_err']:.1e}), sharded HPROM {dry['hprom_gn_its']} GN "
          f"its (max abs diff {dry['hprom_err']:.1e}); passed in "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    print(f"[spatial] phase {time.perf_counter() - t_phase:.1f} s")
    return [sum(c[0] for c in counts), sum(c[1] for c in counts)]


# ----------------------------------------------------------------------
# the users' workflow: the runner CLIs, and the other weight methods
# ----------------------------------------------------------------------

class _Tee(io.TextIOBase):
    """stdout that is also kept: the runners' protocol lines are read back
    (Newton / GN iterations, N_e, the weight solve time)."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def _found(pattern, text, what):
    hits = re.findall(pattern, text)
    check(bool(hits), f"{what}: no line matching {pattern!r}")
    return hits


def run_runner(label, main, **kw):
    """main(**kw) of a port runner with every kernel count set to 0 just
    before and read just after: (return value, wall s, counts, stdout)."""
    cw.LAUNCHES = 0
    cw.SEG_LAUNCHES = 0
    reset_gn_counts()
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        ret = main(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"wavefront_solve": cw.LAUNCHES, **gn_counts()}
    check(cw.SEG_LAUNCHES == 0, f"{label}: segmented solves launched")
    return ret, wall, counts, tee.buf.getvalue()


def phase_runners(card, b1_launches, gn_launches):
    """The users' offline-to-online workflow through the port's runner
    main()s at 250^2 in a fresh working directory: run_fom, run_prom
    (generic, building the 9-trajectory basis, then pallas), run_hprom
    --compute-ecsw nnls (generic, then pallas on the saved weights) and
    the 3x3 run_sweep --model hprom. Adds each run's kernel launches to
    b1_launches (returned) and gn_launches."""
    from finitedifference_tpu_torch.runners import (
        run_fom,
        run_hprom,
        run_prom,
        run_sweep,
    )

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="fd_runners_")
    home = os.getcwd()
    os.chdir(workdir)
    steps, mu = RUNNER_STEPS, RUNNER_MU
    common = dict(num_cells=RUNNER_N, num_steps=steps)
    base = f"[runners] {RUNNER_N}x{RUNNER_N} {steps} steps"
    tag = f"{base} at {mu}"
    try:
        (el, _), wall, counts, out = run_runner(
            "run_fom", run_fom.main, mu1=mu[0], mu2=mu[1], **common)
        its = int(_found(r"(\d+) Newton its\)", out, "run_fom")[-1])
        check(counts["wavefront_solve"] == its > 0,
              f"run_fom: {counts} launches for {its} Newton iterations")
        b1_launches += counts["wavefront_solve"]
        print(f"{tag} run_fom (skewed, f64): wall {wall:.2f} s, "
              f"{steps / el:.2f} steps/s, {its} Newton its "
              f"({its / steps:.2f}/step), {counts['wavefront_solve']} B1 "
              f"launches ({card})")

        proms = {}
        for engine, kernel in (("generic", None), ("pallas", "gn_full")):
            (el, err), wall, counts, out = run_runner(
                f"run_prom {engine}", run_prom.main, mu1=mu[0], mu2=mu[1],
                engine=engine, **common)
            gn = int(_found(r"Total GN iterations: (\d+)", out,
                            "run_prom")[-1])
            proms[engine] = np.load(RUNNER_ROM_FILE)
            line = (f"{tag} run_prom --engine {engine}: wall {wall:.2f} s, "
                    f"{steps / el:.2f} steps/s, {gn} GN its "
                    f"({gn / steps:.3f}/step), error vs FOM {err:.4f}% "
                    f"(JAX on a TPU: {JAX_RECORD['prom']:.2f}%)")
            if kernel is None:
                foms = [float(t) for t in re.findall(
                    r"Computed FOM snaps for .* in ([\d.e+-]+) s", out)]
                pod_s = float(_found(r"POD \(rsvd, \d+ modes\): "
                                     r"([\d.e+-]+) s", out, "basis")[-1])
                check(len(foms) == 9 and counts["wavefront_solve"] > 0,
                      f"basis build: {len(foms)} FOMs, "
                      f"{counts['wavefront_solve']} B1 launches")
                b1_launches += counts["wavefront_solve"]
                line += (f"; the basis: 9 FOMs through B1 in "
                         f"{sum(foms):.2f} s "
                         f"({counts['wavefront_solve']} launches), "
                         f"rSVD {pod_s:.2f} s")
                check(counts["gn_full"] == 0, f"{engine}: {counts}")
            else:
                check(counts[kernel] > 0 and counts["wavefront_solve"] == 0,
                      f"run_prom pallas: launches {counts}")
                gn_launches[kernel] += counts[kernel]
                diff = rel_err(torch.as_tensor(proms["pallas"]),
                               torch.as_tensor(proms["generic"]))
                check(diff < ENGINE_TOL, f"run_prom pallas vs generic: "
                      f"rel {diff}")
                line += (f", {counts[kernel]} B3 launches, rel vs generic "
                         f"{diff:.3e}")
            check(err < PROM_LIMIT, f"run_prom {engine}: error {err}% >= "
                  f"{PROM_LIMIT}%")
            print(line + f" ({card})")

        hproms = {}
        for engine, kernel in (("generic", None),
                               ("pallas", "gn_sampled_system")):
            (el, err), wall, counts, out = run_runner(
                f"run_hprom {engine}", run_hprom.main, mu1=mu[0],
                mu2=mu[1], compute_ecsw=engine == "generic",
                weights_method="nnls", engine=engine, **common)
            gn = int(_found(r"Total GN iterations: (\d+)", out,
                            "run_hprom")[-1])
            n_e = int(_found(r"N_e = (\d+)", out, "run_hprom")[-1])
            hproms[engine] = np.load(RUNNER_HPROM_FILE)
            line = (f"{tag} run_hprom --engine {engine}: wall {wall:.2f} s, "
                    f"{steps / el:.2f} steps/s, {gn} GN its "
                    f"({gn / steps:.3f}/step), N_e {n_e} (JAX: "
                    f"{JAX_RECORD['n_e']}), error vs FOM {err:.4f}% (JAX "
                    f"on a TPU: {JAX_RECORD['hprom']:.2f}%)")
            if kernel is None:
                solve_s = float(_found(r"weight solve time: ([\d.]+)s",
                                       out, "run_hprom")[-1])
                line += f", --compute-ecsw nnls weight solve {solve_s:.2f} s"
                check(sum(counts.values()) == 0, f"{engine}: {counts}")
            else:
                check(counts[kernel] > 0 and sum(counts.values())
                      == counts[kernel], f"run_hprom pallas: {counts}")
                gn_launches[kernel] += counts[kernel]
                diff = rel_err(torch.as_tensor(hproms["pallas"]),
                               torch.as_tensor(hproms["generic"]))
                check(diff < ENGINE_TOL, f"run_hprom pallas vs generic: "
                      f"rel {diff}")
                line += (f" (the weights saved by the generic run), "
                         f"{counts[kernel]} B4 launches, rel vs generic "
                         f"{diff:.3e}")
            check(err < HPROM_LIMIT, f"run_hprom {engine}: error {err}% >= "
                  f"{HPROM_LIMIT}%")
            print(line + f" ({card})")

        el, wall, counts, out = run_runner(
            "run_sweep", run_sweep.main, model="hprom",
            **dict(common, num_steps=CUT_STEPS))
        errs = [float(e) for e in _found(
            r"error vs the cached FOM ([\d.e+-]+)%", out, "run_sweep")]
        check(len(errs) == 9 and max(errs) < HPROM_LIMIT,
              f"run_sweep hprom: errors {errs}")
        check(sum(counts.values()) == 0, f"run_sweep hprom: {counts}")
        print(f"{base} run_sweep --model hprom 3x3 --num-steps {CUT_STEPS} "
              f"(the training points, generic engine, f32): wall "
              f"{wall:.2f} s, {9 * CUT_STEPS / el:.2f} aggregate steps/s, "
              f"error vs the cached FOM {min(errs):.4f}-{max(errs):.4f}% "
              f"({card})")
    finally:
        os.chdir(home)
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[runners] phase {time.perf_counter() - t_phase:.1f} s")
    return b1_launches


def phase_closures(card, b1_launches):
    """The POD-RBF closure ROMs through the port's runner main()s at 250^2
    in a fresh working directory: run_pod_rbf_global (basis, grid-search
    fit, online), run_pod_rbf_hprom --compute-ecsw (global) on the model
    it saved, run_pod_rbf (kNN, the reference's eps 0.01, k 100), with
    the float64 state and then with --f32, and run_pod_rbf_hprom --variant
    knn --compute-ecsw, then with --f32; then [gp] in the same directory.
    Returns b1_launches plus the two phases' B1 launches."""
    from finitedifference_tpu_torch.runners import (
        run_pod_rbf,
        run_pod_rbf_global,
        run_pod_rbf_hprom,
    )

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="fd_closures_")
    home = os.getcwd()
    os.chdir(workdir)
    steps, mu = RUNNER_STEPS, RUNNER_MU
    tag = f"[closures] {RUNNER_N}x{RUNNER_N} {steps} steps at {mu}"
    runs = (
        ("global", "run_pod_rbf_global", run_pod_rbf_global.main, {}),
        ("hprom", "run_pod_rbf_hprom --compute-ecsw (global, nnls, bc_w "
         "10)", run_pod_rbf_hprom.main,
         dict(variant="global", weights_method="nnls", compute_ecsw=True,
              bc_w=10.0)),
        ("knn", "run_pod_rbf (kNN, eps 0.01, k 100)", run_pod_rbf.main,
         dict(epsilon=0.01, neighbors=100)),
        ("knn_f32", "run_pod_rbf --f32 (kNN, eps 0.01, k 100, float32 "
         "state)", run_pod_rbf.main,
         dict(epsilon=0.01, neighbors=100, f32=True)),
        ("hprom_knn", "run_pod_rbf_hprom --variant knn --compute-ecsw "
         "(eps 0.01, k 100, nnls, bc_w 10)", run_pod_rbf_hprom.main,
         dict(variant="knn", weights_method="nnls", compute_ecsw=True,
              bc_w=10.0)),
        ("hprom_knn_f32", "run_pod_rbf_hprom --variant knn --f32 (the "
         "weights above, float32 state)", run_pod_rbf_hprom.main,
         dict(variant="knn", weights_method="nnls", bc_w=10.0, f32=True)),
    )
    phase_b1 = 0
    try:
        for key, label, main, kw in runs:
            (el, err), wall, counts, out = run_runner(
                label, main, mu1=mu[0], mu2=mu[1], num_cells=RUNNER_N,
                num_steps=steps, num_primary=10, num_secondary=140, **kw)
            # the global PROM re-seeds step 0 with the training
            # trajectory's first step (warm_q1) and runs the other 499
            online = steps - 1 if key == "global" else steps
            gn = int(_found(r"Total GN iterations: (\d+)", out, label)[-1])
            b1 = counts["wavefront_solve"]
            check(sum(counts.values()) == b1,
                  f"{label}: Gauss-Newton kernels launched: {counts}")
            check(bool(np.isfinite(err))
                  and err < CLOSURE_LIMIT.get(key, np.inf),
                  f"{label}: error {err}% (limit {CLOSURE_LIMIT.get(key)}%)")
            phase_b1 += b1
            bound = (f"limit {CLOSURE_LIMIT[key]:.2f}%" if key in
                     CLOSURE_LIMIT else "a witness, no limit")
            line = (f"{tag} {label}: wall {wall:.2f} s, {online / el:.2f} "
                    f"online steps/s ({el:.3f} s), {gn} GN its "
                    f"({gn / online:.3f}/step), error vs FOM {err:.4f}% "
                    f"(JAX record {CLOSURE_RECORD[key]:.3f}%, {bound})")
            if key == "global":
                foms = re.findall(r"Computed FOM snaps for .* in "
                                  r"([\d.e+-]+) s", out)
                check(len(foms) == 10 and b1 > 0,
                      f"{label}: {len(foms)} FOMs, {b1} B1 launches")
                fit_s, pairs = _found(r"grid-search fit time: ([\d.]+)s "
                                      r"\((\d+) pairs\)", out, label)[-1]
                eps, kern = _found(r"grid-search best: \{'epsilon': "
                                   r"([\d.e+-]+), 'kernel': '(\w+)'", out,
                                   label)[-1]
                line += (f"; the basis and the test point: 10 FOMs through "
                         f"B1 in {sum(map(float, foms)):.2f} s; grid-search "
                         f"fit on the card {float(fit_s):.2f} s over "
                         f"{pairs} pairs, chose {kern}, eps "
                         f"{float(eps):.4g}")
            elif key in ("hprom", "hprom_knn"):
                line += _offline(out, label)
            print(line + f"; {b1} B1 launches ({card})")
        phase_b1 += phase_gp(card, tag)
        phase_b1 += phase_rnm(card, tag)
    finally:
        os.chdir(home)
        shutil.rmtree(workdir, ignore_errors=True)
    check(phase_b1 > 0, "[closures] launched no wavefront kernel")
    print(f"[closures] phase {time.perf_counter() - t_phase:.1f} s, "
          f"{phase_b1} B1 launches")
    return b1_launches + phase_b1


def _offline(out, label):
    """The HPROM runners' offline numbers: N_e, the closure training
    matrix's and the NNLS's seconds."""
    n_e = int(_found(r"N_e = (\d+)", out, label)[-1])
    build_s = float(_found(r"closure training matrix .*: ([\d.]+)s", out,
                           label)[-1])
    solve_s = float(_found(r"weight solve time: ([\d.]+)s", out,
                           label)[-1])
    return (f"; N_e {n_e}, closure training matrix {build_s:.2f} s, NNLS "
            f"{solve_s:.2f} s")


def _spread(a):
    a = np.asarray(a).ravel()
    return (f"{a.min():.4g} / {np.median(a):.4g} / {a.max():.4g} "
            f"(min / median / max of {a.size})")


def phase_gp(card, tag):
    """[gp], in [closures]' working directory (its basis, snapshot cache
    and FOMs reused): run_pod_gp_hprom --compute-ecsw (the shared-kernel
    ARD GP, noise 1e-6), then --retrain --per-mode full --compute-ecsw
    (one ARD GP per secondary mode, 140 x 300 Adam steps over batched
    1,128^2 Cholesky factorizations), each under twice the JAX record;
    then run_pod_rbf_global --search cv|bayesian|aniso|svr, each error
    finite. Returns the phase's B1 launches (0 when the cache serves)."""
    from finitedifference_tpu_torch.runners import (
        run_pod_gp_hprom,
        run_pod_rbf_global,
    )

    t_phase = time.perf_counter()
    steps, mu = RUNNER_STEPS, RUNNER_MU
    tag = tag.replace("[closures]", "[gp]")
    phase_b1 = 0
    for key, label, kw in (
            ("none", "run_pod_gp_hprom --compute-ecsw (shared-kernel ARD, "
             "noise 1e-6, nnls, bc_w 10)", dict(compute_ecsw=True)),
            ("full", "run_pod_gp_hprom --retrain --per-mode full "
             "--compute-ecsw", dict(retrain=True, per_mode="full",
                                    compute_ecsw=True))):
        (el, err), wall, counts, out = run_runner(
            label, run_pod_gp_hprom.main, mu1=mu[0], mu2=mu[1],
            num_cells=RUNNER_N, num_steps=steps, num_primary=10,
            num_secondary=140, **kw)
        gn = int(_found(r"Total GN iterations: (\d+)", out, label)[-1])
        fit_s, pairs = _found(r"gp fit time: ([\d.]+)s \((\d+) pairs",
                              out, label)[-1]
        b1 = counts["wavefront_solve"]
        check(sum(counts.values()) == b1,
              f"{label}: Gauss-Newton kernels launched: {counts}")
        check(bool(np.isfinite(err)) and err < GP_LIMIT[key],
              f"{label}: error {err}% (limit {GP_LIMIT[key]}%)")
        model = np.load(run_pod_gp_hprom.MODEL_PATH)
        check(bool(model["per_mode"]) == (key == "full"),
              f"{label}: the model file's per_mode")
        phase_b1 += b1
        print(f"{tag} {label}: wall {wall:.2f} s, GP fit {float(fit_s):.2f} "
              f"s over {pairs} pairs, amplitude {_spread(model['amplitude'])}"
              f", length scales {_spread(model['length_scale'])}"
              + _offline(out, label)
              + f"; {steps / el:.2f} online steps/s ({el:.3f} s), {gn} GN "
              f"its ({gn / steps:.3f}/step), error vs FOM {err:.4f}% (JAX "
              f"record {GP_RECORD[key]:.2f}%, limit {GP_LIMIT[key]:.2f}%); "
              f"{b1} B1 launches ({card})")
    for search in GP_SEARCHES:
        label = f"run_pod_rbf_global --search {search}"
        (el, err), wall, counts, out = run_runner(
            label, run_pod_rbf_global.main, mu1=mu[0], mu2=mu[1],
            num_cells=RUNNER_N, num_steps=steps, num_primary=10,
            num_secondary=140, search=search)
        gn = int(_found(r"Total GN iterations: (\d+)", out, label)[-1])
        fit_s = float(_found(rf"{search}-search fit time: ([\d.]+)s", out,
                             label)[-1])
        best = _found(rf"{search}(?:-search)? best: (.*)", out, label)[-1]
        b1 = counts["wavefront_solve"]
        check(sum(counts.values()) == b1,
              f"{label}: Gauss-Newton kernels launched: {counts}")
        check(bool(np.isfinite(err)), f"{label}: error {err}%")
        phase_b1 += b1
        online = steps - 1                    # after the warm_q1 re-seed
        print(f"{tag} {label}: wall {wall:.2f} s, fit {fit_s:.2f} s, chose "
              f"{best}; {online / el:.2f} online steps/s ({el:.3f} s), {gn} "
              f"GN its ({gn / online:.3f}/step), error vs FOM {err:.4f}% "
              f"(no JAX record at 250^2); {b1} B1 launches ({card})")
    print(f"[gp] phase {time.perf_counter() - t_phase:.1f} s, {phase_b1} B1 "
          f"launches")
    return phase_b1

def phase_rnm(card, tag):
    """[rnm], in [closures]' working directory (its basis, snapshot cache
    and FOMs reused): run_rnm --retrain for RNM_EPOCHS epochs at RNM_MU,
    run_hrnm --compute-ecsw at RUNNER_MU on the checkpoint it saved, then
    sweep_manifold of that closure over RNM_SWEEP_MUS against lone
    manifold_rom runs. Returns the phase's B1 launches (the FOM at RNM_MU,
    unless the cache holds it)."""
    from finitedifference_tpu_torch.closures.ann import init_rnm, rnm_closure
    from finitedifference_tpu_torch.closures.common import (
        manifold_decoder,
        manifold_decoder_fused,
    )
    from finitedifference_tpu_torch.parallel.sweep import sweep_manifold
    from finitedifference_tpu_torch.pod import split_basis
    from finitedifference_tpu_torch.rom import manifold_rom
    from finitedifference_tpu_torch.runners import common as rc
    from finitedifference_tpu_torch.runners import run_hrnm, run_rnm
    from finitedifference_tpu_torch.training.monitor import load_checkpoint

    t_phase = time.perf_counter()
    steps = RUNNER_STEPS
    tag = tag.replace("[closures]", "[rnm]").split(" at ")[0]
    cfg = rc.default_config(RUNNER_N, steps)
    model_path = rc.res_path(cfg, run_rnm.MODEL_PATH)
    phase_b1 = 0
    label = (f"run_rnm --retrain --epochs {RNM_EPOCHS} at {RNM_MU} (the "
             f"recipe's 5000 cut to {RNM_EPOCHS})")
    (el, err), wall, counts, out = run_runner(
        label, run_rnm.main, mu1=RNM_MU[0], mu2=RNM_MU[1],
        num_cells=RUNNER_N, num_steps=steps, num_primary=10,
        num_secondary=140, epochs=RNM_EPOCHS, retrain=True)
    gn = int(_found(r"Total GN iterations: (\d+)", out, label)[-1])
    ran, train_s, per_epoch = _found(
        r"trained (\d+) epochs in ([\d.]+) s \(([\d.]+) s/epoch\)", out,
        label)[-1]
    fit_s, pairs = _found(r"rnm fit time: ([\d.]+)s \((\d+) pairs\)", out,
                          label)[-1]
    vals = [float(v) for v in _found(r"  epoch \d+: train \S+ val (\S+)",
                                     out, label)]
    with open(model_path + ".json") as f:
        side = json.load(f)
    b1 = counts["wavefront_solve"]
    check(sum(counts.values()) == b1,
          f"{label}: Gauss-Newton kernels launched: {counts}")
    check(bool(np.isfinite(err)), f"{label}: error {err}%")
    check(len(vals) >= 2 and vals[-1] < vals[0],
          f"{label}: the validation loss did not fall: {vals}")
    check(os.path.exists(model_path)
          and 1 <= side["epoch"] <= RNM_EPOCHS
          and side["best_crit"] == min(side["test_crits"]),
          f"{label}: the checkpoint and its sidecar ({side['epoch']})")
    phase_b1 += b1
    print(f"{tag} at {RNM_MU} {label}: wall {wall:.2f} s; fit {float(fit_s):.2f}"
          f" s over {pairs} pairs, {ran} epochs in {float(train_s):.2f} s "
          f"({float(per_epoch):.4f} s/epoch), validation loss {vals[0]:.3e} "
          f"(epoch 0) -> {vals[-1]:.3e} (the last printed), best "
          f"{side['best_crit']:.3e} at epoch {side['epoch']}; "
          f"{steps / el:.2f} online steps/s ({el:.3f} s), {gn} GN its "
          f"({gn / steps:.3f}/step), error vs FOM {err:.4f}% (JAX record "
          f"{RNM_RECORD['rnm']:.2f}% after 3932 epochs; 1.98% at (5.19, "
          f"0.026)); {b1} B1 launches ({card})")

    label = "run_hrnm --compute-ecsw (nnls, bc_w 10) on that checkpoint"
    (el, err), wall, counts, out = run_runner(
        label, run_hrnm.main, mu1=RUNNER_MU[0], mu2=RUNNER_MU[1],
        num_cells=RUNNER_N, num_steps=steps, num_primary=10,
        num_secondary=140, compute_ecsw=True)
    gn = int(_found(r"Total GN iterations: (\d+)", out, label)[-1])
    n_e = int(_found(r"N_e = (\d+)", out, label)[-1])
    b1 = counts["wavefront_solve"]
    check(sum(counts.values()) == b1,
          f"{label}: Gauss-Newton kernels launched: {counts}")
    check(bool(np.isfinite(err)) and n_e > 0,
          f"{label}: error {err}%, N_e {n_e}")
    check("rnm fit time" not in out, f"{label}: retrained the network")
    phase_b1 += b1
    print(f"{tag} at {RUNNER_MU} {label}: wall {wall:.2f} s"
          + _offline(out, label)
          + f"; {steps / el:.2f} online steps/s ({el:.3f} s), {gn} GN its "
          f"({gn / steps:.3f}/step), error vs FOM {err:.4f}% (JAX record "
          f"{RNM_RECORD['hrnm']:.2f}% after 3932 epochs); {b1} B1 launches "
          f"({card})")

    # the sweep of the trained closure, full mesh, float64 state
    grid, w0 = rc.make_problem(cfg)
    basis = rc.get_or_build_basis(cfg, grid, w0, 150, device=DEVICE)
    u_p, u_s = (torch.as_tensor(b, device=DEVICE)
                for b in split_basis(basis, 10, 140))
    closure = rnm_closure(load_checkpoint(
        model_path, init_rnm(10, 140, device=DEVICE)))
    decode, dec_jac = manifold_decoder(u_p, u_s, closure)
    kw = dict(decode_and_jac=manifold_decoder_fused(u_p, u_s, closure),
              **rc.default_ls(DEVICE))
    y0 = u_p.T @ torch.as_tensor(w0, device=DEVICE)
    label = (f"sweep_manifold over {len(RNM_SWEEP_MUS)} points, "
             f"{CUT_STEPS} steps")
    red, wall, counts, _ = run_runner(
        label, lambda: sweep_manifold(grid, y0, decode, dec_jac, cfg.dt,
                                      CUT_STEPS, RNM_SWEEP_MUS, **kw))
    check(sum(counts.values()) == 0, f"{label}: kernels launched: {counts}")
    check(red.shape == (len(RNM_SWEEP_MUS), 10, CUT_STEPS + 1)
          and bool(torch.isfinite(red).all()), f"{label}: {red.shape}")
    diffs = []
    for i, (m1, m2) in enumerate(RNM_SWEEP_MUS):
        lone = manifold_rom(grid, y0, decode, dec_jac, cfg.dt, CUT_STEPS,
                            m1, m2, **kw).red_coords
        diffs.append(rel_err(red[i], lone))
        check(diffs[-1] <= RNM_SWEEP_TOL,
              f"{label}: row {i} against the lone run: rel {diffs[-1]}")
    print(f"{tag} {label} {RNM_SWEEP_MUS}: "
          f"{len(RNM_SWEEP_MUS) * CUT_STEPS / wall:.2f}"
          f" aggregate steps/s ({wall:.2f} s), rows against lone runs rel "
          f"{max(diffs):.1e} (limit {RNM_SWEEP_TOL:g}) ({card})")
    print(f"[rnm] phase {time.perf_counter() - t_phase:.1f} s, {phase_b1} B1 "
          f"launches")
    return phase_b1


def phase_ae(card):
    """[ae], in a fresh working directory: run_ae_prom at AE_MUS in
    scripts/record_ae_rows.py's order, the first training the autoencoder
    (the 9 training FOMs through B1), the other two loading its
    checkpoint; then [drivers] in the same directory, on its 50^2 FOM
    cache. Returns the phase's B1 launches (its 12 FOMs)."""
    from finitedifference_tpu_torch.runners import common as rc
    from finitedifference_tpu_torch.runners import run_ae_prom

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="fd_ae_")
    home = os.getcwd()
    os.chdir(workdir)
    cfg = rc.default_config(AE_N)
    steps = cfg.num_steps
    model_path = rc.res_path(cfg, run_ae_prom.MODEL_PATH)
    tag = f"[ae] {AE_N}x{AE_N} {steps} steps latent {AE_LATENT}"
    phase_b1 = 0
    try:
        for i, mu in enumerate(AE_MUS):
            label = (f"run_ae_prom at {mu} (" + (
                f"trains: {AE_EPOCHS} epochs, patience 50" if i == 0
                else "loads the checkpoint") + ")")
            (el, err), wall, counts, out = run_runner(
                label, run_ae_prom.main, mu1=mu[0], mu2=mu[1],
                latent_dim=AE_LATENT, epochs=AE_EPOCHS, num_cells=AE_N)
            gn = int(_found(r"Total GN iterations: (\d+)", out, label)[-1])
            state = _found(r"online state: torch\.(\w+)", out, label)[-1]
            foms = re.findall(r"Computed FOM snaps for .* in ([\d.e+-]+) s",
                              out)
            b1 = counts["wavefront_solve"]
            check(sum(counts.values()) == b1,
                  f"{label}: Gauss-Newton kernels launched: {counts}")
            check(len(foms) == (10 if i == 0 else 1) and b1 > 0,
                  f"{label}: {len(foms)} FOMs, {b1} B1 launches")
            check(bool(np.isfinite(err)) and err < AE_LIMIT[mu],
                  f"{label}: error {err}% (limit {AE_LIMIT[mu]:.4f}%)")
            phase_b1 += b1
            line = f"{tag} {label}: wall {wall:.2f} s"
            if i == 0:
                check(state == "float32", f"{label}: a {state} state")
                ran, train_s, per_epoch = _found(
                    r"trained (\d+) epochs in ([\d.]+) s \(([\d.]+) "
                    r"s/epoch\)", out, label)[-1]
                vals = [float(v) for v in _found(
                    r"  epoch \d+: train \S+ val (\S+)", out, label)]
                with open(model_path + ".json") as f:
                    side = json.load(f)
                check(len(vals) >= 2 and min(vals[1:]) < vals[0],
                      f"{label}: the validation loss did not fall: {vals}")
                check(side["best_crit"] == min(side["test_crits"])
                      < side["test_crits"][0],
                      f"{label}: the sidecar's best {side['best_crit']}")
                line += (f"; {len(foms)} FOMs through B1 in "
                         f"{sum(map(float, foms)):.2f} s; {ran} epochs in "
                         f"{float(train_s):.2f} s ({float(per_epoch):.4f} "
                         f"s/epoch), validation loss {vals[0]:.3e} (epoch "
                         f"0) -> {vals[-1]:.3e} (the last printed), best "
                         f"{side['best_crit']:.3e} at epoch {side['epoch']} "
                         f"(JAX sidecar {AE_JAX_BEST[0]:.3e} at epoch "
                         f"{AE_JAX_BEST[1]})")
            else:
                check(state == "float64" and "ae fit time" not in out,
                      f"{label}: a {state} state, or it trained")
            print(line + f"; {state} state, {steps / el:.2f} online steps/s "
                  f"({el:.3f} s), {gn} GN its ({gn / steps:.3f}/step), "
                  f"error vs FOM {err:.4f}% (JAX record {AE_RECORD[mu]:.2f}"
                  f"%, limit {AE_LIMIT[mu]:.4f}%); {b1} B1 launches ({card})")
        check(phase_b1 > 0, "[ae] launched no wavefront kernel")
        print(f"[ae] phase {time.perf_counter() - t_phase:.1f} s, "
              f"{phase_b1} B1 launches in its 12 FOMs")
        phase_drivers(card)
    finally:
        os.chdir(home)
        shutil.rmtree(workdir, ignore_errors=True)
    return phase_b1


@contextlib.contextmanager
def driver_points(*modules):
    """The drivers of `modules` loop over DRIVER_POINTS in place of the
    three test points (the depth cut of [drivers])."""
    saved = [m.TEST_POINTS for m in modules]
    for m in modules:
        m.TEST_POINTS = DRIVER_POINTS
    try:
        yield
    finally:
        for m, points in zip(modules, saved):
            m.TEST_POINTS = points


def phase_drivers(card):
    """[drivers], in [ae]'s directory (its 50^2 FOM cache), at
    DRIVER_POINTS: run_tests --models prom and a second call that must
    skip every key, run_tests_hprom --models hprom, every point a runner
    process on the card with no retry (a failed point fails the phase),
    then check_derivatives on the card, every verdict OK."""
    from finitedifference_tpu_torch.runners import (
        check_derivatives,
        run_tests,
        run_tests_hprom,
    )

    t_phase = time.perf_counter()
    tag = f"[drivers] {AE_N}x{AE_N} at {DRIVER_POINTS}"
    n = len(DRIVER_POINTS)
    for label, main, model, out, n_keys in (
            ("run_tests --models prom", run_tests.main, "prom",
             "rom_results.npz", 2 * n),
            ("run_tests_hprom --models hprom", run_tests_hprom.main, "hprom",
             "rom_results_hprom.npz", n)):
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee), \
                driver_points(run_tests, run_tests_hprom):
            results = main(models=(model,), out=out, num_cells=AE_N,
                           retries=0)
        wall = time.perf_counter() - t0
        log = tee.buf.getvalue()
        check("FAILED" not in log and len(results) == n_keys
              and all(bool(np.isfinite(v).all()) for v in results.values()),
              f"{label}: {sorted(results)}")
        rows = ", ".join(f"{k} {v[0]:.3f} s / {v[1]:.2f}%"
                         for k, v in sorted(results.items()))
        print(f"{tag} {label}: {len(results)} points, each a runner process "
              f"on the card, in {wall:.1f} s: {rows} ({card})")
        if model == "prom":
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as buf, \
                    driver_points(run_tests):
                again = main(models=(model,), out=out, num_cells=AE_N,
                             retries=0)
            skipped = [line for line in buf.getvalue().splitlines()
                       if line.startswith("skipping")]
            check(len(skipped) == n and "===" not in buf.getvalue()
                  and all(np.array_equal(again[k], v)
                          for k, v in results.items()),
                  f"{label} again: {skipped}")
            print(f"{tag} {label} again: skipped all {len(skipped)} model "
                  f"keys and the {n} FOMs in "
                  f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        verdicts = check_derivatives.main(device=DEVICE)
    check(all(ok for _, _, ok in verdicts.values()),
          f"check_derivatives: {verdicts}")
    print(f"{tag} check_derivatives on the card in "
          f"{time.perf_counter() - t0:.2f} s: " + ", ".join(
              f"{name} slope {slope:.2f} min err {err:.1e} OK"
              for name, (slope, err, _) in verdicts.items()) + f" ({card})")
    print(f"[drivers] phase {time.perf_counter() - t_phase:.1f} s")


def phase_weight_methods(card, grid, basis, pairs, c):
    """The other weight methods at 64^2 on the recipe's training matrix
    (on the card): ECM (rank-800 sketch on the card, cubature on the
    host), multilevel (FISTA screening on the card), sequential (host)
    and the device-scored Lawson-Hanson on a float32 training matrix
    built on the card. Each must reach its stopping target, the 1e-4
    training residual over its candidate cells."""
    t_phase = time.perf_counter()

    def residual(cmat, weights, ring):
        flat = torch.as_tensor(interior_mask(grid, ring).ravel(),
                               device=cmat.device)
        ci = cmat[:, flat].double()
        w = torch.as_tensor(weights, device=cmat.device)[flat]
        d = ci.sum(dim=1)
        return float(torch.linalg.vector_norm(ci @ w - d)
                     / torch.linalg.vector_norm(d))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c32 = ecsw_training_matrix_device(grid, *pairs, basis, *MU_TRAIN, DT,
                                      chunk=2)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    diff = rel_err(c32, c)
    check(diff < 1e-6, f"float32 device training matrix: rel {diff}")
    methods = (
        ("ecm (rank-800 sketch, tol 1e-4)", c, "full", lambda: (
            compute_ecsw_weights(c, grid, bc_w=RING_WEIGHT, method="ecm",
                                 rel_err_thresh=1e-4, ecm_rank=800,
                                 ecm_tolerance=1e-4))),
        ("multilevel (12 blocks, FISTA on the card)", c, "full", lambda: (
            multilevel_nnls_weights(c, grid, num_subdomains=12,
                                    bc_w=RING_WEIGHT, level1="fista",
                                    rel_err_thresh=1e-4))),
        ("sequential (host)", c, "full", lambda: (
            sequential_nnls_weights(c, grid, bc_w=RING_WEIGHT,
                                    rel_err_thresh=1e-4))),
        ("lawson_hanson_weights_device (float32 C, inflow ring)", c32,
         "inflow", lambda: lawson_hanson_weights_device(
             c32, grid, bc_w=RING_WEIGHT, rel_err_thresh=1e-4)),
    )
    for label, cmat, ring, solve in methods:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        weights = solve()
        elapsed = time.perf_counter() - t0
        n_e = int((weights > 0).sum())
        res = residual(cmat, weights, ring)
        check(bool(np.all(weights >= 0)) and 0 < n_e < grid.n_cells,
              f"{label}: N_e {n_e}")
        check(res < WEIGHT_TARGET, f"{label}: training residual {res} >= "
              f"{WEIGHT_TARGET}")
        print(f"[weights] {grid.nx}x{grid.ny} {label}: N_e {n_e}, training "
              f"residual {res:.3e} (target {WEIGHT_TARGET:g}), "
              f"{elapsed:.2f} s ({card})")
    print(f"[weights] float32 training matrix {tuple(c32.shape)} built in "
          f"{build_s:.3f} s on the card (rel vs float64 {diff:.1e}); phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def spatial_alone(card):
    """`python3 chip_smoke.py spatial`: [spatial] alone, on every visible
    card, with [rom]'s basis and bench mesh built first."""
    grid = Grid2D(nx=ROM_N, ny=ROM_N)
    basis, _ = rom_basis(grid, card)
    mesh, sw32, ba = bench_mesh(grid, basis)
    y0 = basis.T @ torch.ones(grid.state_dim, dtype=F32, device=DEVICE)
    phase_spatial(card, dict(mesh=mesh, sw32=sw32, y0=y0, ba=ba))


def main():
    phases = sys.argv[1:]
    check(phases in ([], ["spatial"]),
          f"usage: python3 chip_smoke.py [spatial]; got {phases}")
    card = phase_environment()
    phase_build()
    if phases:
        spatial_alone(card)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    kern = phase_kernel_vs_plain(card)
    seg_kern = phase_seg_kernel(card)
    r1_kern = phase_residual_kernel(card)
    entry_launches, b2_kern, standard_launches = phase_entry_step(card)
    launches, r1_launches, exact_final = phase_main_path(card)
    check(launches > 0, "the main path launched no wavefront kernel")
    seg_launches, r1_seg = phase_main_seg(card, exact_final)
    r1_slice = phase_gpu_vs_cpu()
    gn_kern = phase_gn_kernels(card)
    b2_device_kernels(card)
    gn_launches = {k: 0 for k in GN_KERNELS}
    ctx = phase_rom_250(card, gn_launches)
    traj_kern = phase_traj_kernel(card, ctx)
    phase_rom_traj(card, ctx, gn_launches)
    sweep_launches, r1_sweep = phase_sweep(card, ctx, gn_launches)
    seg_launches += sweep_launches
    r1_launches = [sum(n) for n in zip(r1_launches, r1_seg, r1_slice,
                                       r1_sweep)]
    spatial_b1, spatial_b6 = phase_spatial(card, ctx)
    gn_launches["gn_traj"] += spatial_b6
    del ctx
    phase_fine_prom(card, gn_launches)
    phase_weight_methods(card, *phase_ecsw_recipe(card, gn_launches))
    launches = phase_runners(card, launches, gn_launches)
    launches = phase_closures(card, launches)
    launches += phase_ae(card)
    launches += spatial_b1
    check(seg_launches > 0, "the seg paths launched no segmented kernel")
    for k, v in gn_launches.items():
        check(v > 0, f"the ROM path launched no {k} kernel")

    def entry(name, source, replaces, n_launches, main, extra):
        """A kernel's line: the main-path numbers in f32, the others
        under suffixed keys (B4 and B5 add ms_device, a call's time in a
        CUDA graph). None of the nine is one PyTorch call, so
        library_ms is null (PERF.md)."""
        e = {"name": name, "route": "cuda",
             "source": f"finitedifference_tpu_torch/csrc/{source}",
             "replaces": f"finitedifference_tpu/ops/{replaces}",
             "launches": n_launches, "library_ms": None}
        e.update({key: main[key] for key in ("max_abs_err", "ms",
                                             "plain_ms", "bound_ms",
                                             "bound_by", "ms_device",
                                             "composition_ms",
                                             "norm_rel_err")
                  if key in main})
        for suffix, numbers in extra.items():
            e.update({f"{key}_{suffix}": v for key, v in numbers.items()})
        return e

    entries = [
        entry("wavefront_solve", "wavefront.cu", "pallas_wavefront.py:128",
              launches, kern[F32], {"f64": kern[F64]}),
        entry("wavefront_solve_unskewed", "wavefront.cu",
              "pallas_wavefront.py:36", entry_launches, b2_kern[F32],
              {"f64": b2_kern[F64]}),
        entry("wavefront_seg", "wavefront.cu", "pallas_wavefront.py:238",
              seg_launches, seg_kern[F32], {"f64": seg_kern[F64]}),
    ]
    entries[1]["layout"] = f"{ROM_N}x{ROM_N}"
    entries[1]["launches_standard_engine"] = standard_launches
    sources = {
        "gn_full": ("gn_full.cu", "pallas_gn_full.py:108", FINE_N),
        "gn_sampled_system": ("gn_sampled.cu", "pallas_gn.py:56", ROM_N),
        "gn_sampled_step": ("gn_sampled.cu", "pallas_gn.py:128", ROM_N),
    }
    for name, (source, replaces, n) in sources.items():
        extra = {"f64": gn_kern[name][(n, F64)]}
        if name == "gn_full":
            extra.update({f"{ROM_N}": gn_kern[name][(ROM_N, F32)],
                          f"f64_{ROM_N}": gn_kern[name][(ROM_N, F64)]})
        entries.append(entry(name, source, replaces, gn_launches[name],
                             gn_kern[name][(n, F32)], extra))
        entries[-1]["layout"] = f"{n}x{n}"
    entries.append(entry("gn_traj", "gn_traj.cu", "pallas_gn.py:232",
                         gn_launches["gn_traj"], traj_kern[(9, F32)],
                         {"b1": traj_kern[(1, F32)],
                          "f64": traj_kern[(9, F64)],
                          "f64_b1": traj_kern[(1, F64)]}))
    # R1 replaces no Pallas kernel: XLA fused these JAX functions, their
    # norms and the stop test under jit
    for i, (name, replaces, key) in enumerate((
            ("skewed_update_residual", "skewed.py:173", "update"),
            ("skewed_step_constant", "skewed.py:151", "step_constant"))):
        entries.append(entry(name, "skewed_residual.cu", replaces,
                             r1_launches[i], r1_kern[F32][key],
                             {"f64": r1_kern[F64][key]}))
        entries[-1].update(layout=f"{MAIN_N}x{MAIN_N}", fused_by_xla=True)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
