#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (finitedifference_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

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
   events, median of 3);
4. the entry step: newton_step at 250^2 with a float32 state, on the card
   against the same call on the CPU;
5. the main path: inviscid_burgers_implicit2d_skewed at 750^2 with a
   float64 state and float32 snapshots, (a) with float32 solves and
   (b) with float64 solves; 5 warm-up steps, then 3 runs of 100 steps:
   steps/s, Newton iterations per step, one kernel launch per iteration;
6. a 64^2 float64 trajectory on the card against the CPU;
7. the Gauss-Newton system kernels against their plain PyTorch versions
   on the card, in float32 and float64: B3 (gn_full) at the 250^2 and
   750^2 95-mode layouts (two runs bit-equal) and at a 150 x 149, 40-mode
   layout whose chunks do not divide among the CTAs and whose k + 1 is
   no multiple of the lane granularity, B4 (gn_sampled_system) and B5
   (gn_sampled_step) at the 250^2 synthetic-mesh layout (1508 sampled
   cells, 95 modes): error and both times (CUDA events, median of 3);
8. the 250^2 ROM path: FOM snapshots at (4.25, 0.0225), a 95-mode rSVD
   POD basis, then 500 steps at (4.75, 0.02) of lspg_prom and
   pallas_prom, and on the bench.py mesh (512 interior cells and the
   boundary ring) ecsw_hprom, factored_hprom and pallas_hprom (normal,
   unroll 3 + cg, unroll 3 + fused): steps/s (median of 3), GN its/step,
   kernel launches (equal to the kernel calls), the difference against
   the generic engine of the family and the error against the FOM;
9. the 750^2 streaming PROM: a 95-mode basis from a 500-step 750^2 FOM
   trajectory, pallas_prom for 500 steps and lspg_prom for 100;
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
   launch per Newton iteration, final state against the exact chain;
13. [traj-kernel] the whole-trajectory kernel (B6) against its plain
   version on the 250^2 bench mesh layout (6, 1536, 128), 50 steps, 1
   and 9 trajectories, f32 and f64: error, two runs bit-equal, the b = 1
   run bit-equal to its row of the b = 9 launch, and both times (the plain
   version's, seconds long, from the one run compared); then k = 150 in
   f32 on a layout whose 7 chunks do not divide among the cluster's CTAs;
14. [rom] pallas_traj_hprom (one launch for 500 steps) and tensor_hprom on
   the bench mesh, against ecsw_hprom and the FOM, and tensor_hprom
   against ecsw_hprom once more in float64;
15. [sweep] the 9-point μ grid of bench.py at 250^2: sweep_hprom generic,
   factored and pallas_traj (one launch for all 9 points) for 500 steps,
   each point held against its own run, and sweep_fom(engine="skewed",
   seg=8) for 100 steps: aggregate steps/s.
Each main path runs with the kernels' counts set to 0 just before it and
read just after; it fails if a kernel of the path was not launched.

Then one JSON line on the kernels (with each kernel's bound: the larger
of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s in f32 or
34 TFLOP/s in f64, the H100 SXM data sheet's rates), the card line, and
last {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device the script fails at once and prints no
result.
"""

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from finitedifference_tpu_torch import rom_factored as rf
from finitedifference_tpu_torch import rom_tensor as rt
from finitedifference_tpu_torch.config import BurgersConfig
from finitedifference_tpu_torch.ecsw import (
    compute_ecsw_weights,
    ecsw_training_matrix,
)
from finitedifference_tpu_torch.fom import (
    inviscid_burgers_implicit2d_skewed,
    newton_step,
)
from finitedifference_tpu_torch.grid import Grid2D, grid_from_config
from finitedifference_tpu_torch.ops import _build, gn
from finitedifference_tpu_torch.ops import cuda_gn as cg
from finitedifference_tpu_torch.ops import cuda_gn_full as cgf
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
DEVICE = "cuda"

# the reduced models (bench.py rom_metrics / fine_rom_metrics)
ROM_N = 250
FINE_N = 750
RECIPE_N = 64
MODES = 95
ROM_STEPS = 500
FINE_LSPG_STEPS = 100
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
                bound_ms, bound_by = bound(
                    6 * lay.nd_pad * lay.ny_pad * args[0].element_size(),
                    WAVEFRONT_OPS * nx * ny, dtype)
                line += (f", plain {plain_ms:.2f} ms, bound {bound_ms:.4f} "
                         f"ms ({bound_by})")
                main[dtype] = dict(max_abs_err=abs_err, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
            print(f"{line} ({card})")
    return main


def phase_entry_step(card):
    """newton_step at 250^2, f32 state, as the JAX entry point runs it."""
    grid = grid_from_config(BurgersConfig())

    def step(device):
        w0 = grid.initial_state(dtype=F32, device=device)
        mu1 = torch.tensor(MU[0], dtype=F32, device=device)
        mu2 = torch.tensor(MU[1], dtype=F32, device=device)
        return newton_step(w0, mu1, mu2, BurgersConfig().dt, grid,
                           max_its=20)

    before = cw.LAUNCHES
    t0 = time.perf_counter()
    gpu = step("cuda")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = cw.LAUNCHES - before
    cpu = step("cpu")
    rel = rel_err(gpu.w.cpu(), cpu.w)
    check(bool(torch.isfinite(gpu.w).all()), "entry step not finite")
    check(rel <= 1e-5, f"entry step GPU vs CPU: rel {rel}")
    check(launches > 0, "entry step launched no kernel")
    print(f"[entry] newton_step 250x250 f32: {gpu.num_its} its "
          f"(CPU {cpu.num_its}), {launches} kernel launches, rel vs CPU "
          f"{rel:.3e}, {elapsed * 1e3:.1f} ms incl. first-call set-up "
          f"({card})")


def phase_main_path(card):
    """The 750^2 trajectory with f32 and with f64 solves; returns the
    kernel launches of all its runs and the final state of the last
    f32-solve run."""
    grid = Grid2D(nx=MAIN_N, ny=MAIN_N)
    w0 = torch.ones(grid.state_dim, dtype=F64, device="cuda")
    total_launches = 0
    finals = {}
    for label, solve_dtype in (("a: f32 solve", F32),
                               ("b: f64 solve", None)):
        def run(steps):
            nonlocal total_launches
            cw.LAUNCHES = 0
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
          f"difference {float((a - b).abs().max()):.3e}")
    return total_launches, a


def phase_gpu_vs_cpu():
    grid = Grid2D(nx=64, ny=64)
    w0 = torch.ones(grid.state_dim, dtype=F64)
    gpu = inviscid_burgers_implicit2d_skewed(grid, w0.cuda(), DT, 20, *MU)
    cpu = inviscid_burgers_implicit2d_skewed(grid, w0, DT, 20, *MU)
    rel = rel_err(gpu.snaps.cpu(), cpu.snaps)
    check(rel < 1e-12, f"64x64 GPU vs CPU: rel {rel}")
    check(gpu.total_newton_its == cpu.total_newton_its,
          f"64x64 Newton its GPU {gpu.total_newton_its} vs CPU "
          f"{cpu.total_newton_its}")
    print(f"[slice] 64x64 f64 20 steps GPU vs CPU: rel {rel:.3e}, "
          f"{gpu.total_newton_its} Newton its on both")


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
            n_pad, kp = vu.shape
            # the two basis halves, y, cp, the mask and the float64 Gram;
            # a GEMV per half, the rows pass, the symmetric Gram
            nbytes = (2 * n_pad * kp + k + 3 * n_pad) * vu.element_size() \
                + 8 * kp * kp
            ops = gram_ops(2 * n_pad, k) + 22 * n_pad * k
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
        # the blocks, y, cp, the weights; six GEMVs, the rows pass, the
        # symmetric Gram; the step adds the CG and writes (2, kp)
        inputs = (6 * n_p * kp + k + 3 * n_p) * e
        system_ops = gram_ops(2 * n_p, k) + 30 * n_p * k
        cg_ops = rf.CG_ITERS * (2 * k * k + 10 * k)
        got = gn.gn_system(*args)
        want = gn.gn_system_ref(*args)
        ms = cuda_ms(lambda: gn.gn_system(*args), calls=50)
        plain_ms = cuda_ms(lambda: gn.gn_system_ref(*args), calls=10)
        out["gn_sampled_system"][(ROM_N, dtype)] = compare(
            f"gn_sampled_system {ROM_N}x{ROM_N} mesh layout {layout} "
            f"{str(dtype)[6:]}", (got,), (want,), GN_TOL[dtype], card, ms,
            plain_ms, inputs + kp * kp * e, system_ops, dtype)
        dy, rn = gn.gn_step(*args)
        wdy, wrn = gn.gn_step_ref(*args)
        ms = cuda_ms(lambda: gn.gn_step(*args), calls=50)
        plain_ms = cuda_ms(lambda: gn.gn_step_ref(*args), calls=10)
        # the CG carries the Gram's rounding through 24 iterations
        out["gn_sampled_step"][(ROM_N, dtype)] = compare(
            f"gn_sampled_step {ROM_N}x{ROM_N} mesh layout {layout} "
            f"{str(dtype)[6:]} (dy, rn)", (dy, rn), (wdy, wrn),
            100 * GN_TOL[dtype], card, ms, plain_ms, inputs + 2 * kp * e,
            system_ops + cg_ops, dtype)
    return out


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
        cols = generic.red_coords.shape[1]
        diff = rel_err(res.red_coords[:, :cols], generic.red_coords)
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


def phase_rom_250(card, launches):
    """The 250^2 PROM and HPROM engines at the test point; returns what
    the later phases reuse: the grid, basis, FOM snapshots, bench mesh,
    its f32 weights and blocks, y0 and the ecsw_hprom result."""
    grid = Grid2D(nx=ROM_N, ny=ROM_N)
    basis, hdm = rom_basis(grid, card)
    w0 = torch.ones(grid.state_dim, dtype=F32, device=DEVICE)
    y0 = basis.T @ w0
    steps = ROM_STEPS

    def engine(label, fn, kernel=None, generic=None):
        return run_engine(f"{ROM_N}x{ROM_N} {label} f32", fn, kernel, steps,
                          launches, generic, basis, hdm)

    prom = engine("lspg_prom normal", lambda: lspg_prom(
        grid, w0, DT, steps, *MU, basis, ls_method="normal"))
    vu, vv, dmask, tr = rf.precompute_prom_pallas(grid, basis)
    engine("pallas_prom normal", lambda: rf.pallas_prom(
        grid, vu, vv, dmask, y0, DT, steps, *MU, tile_rows=tr),
        "gn_full", prom)
    del vu, vv

    rng = np.random.default_rng(0)
    weights = np.zeros(grid.n_cells)
    interior = np.zeros((ROM_N, ROM_N), dtype=bool)
    interior[1:-1, 1:-1] = True
    weights[rng.choice(np.flatnonzero(interior.ravel()), MESH_INTERIOR,
                       replace=False)] = 1.0
    weights[~interior.ravel()] = RING_WEIGHT
    mesh, sw, ba = prepare_hprom(grid, weights, basis)
    sw32 = sw.to(F32)
    print(f"[rom] {ROM_N}x{ROM_N} mesh: {mesh.n_sample} sampled cells "
          f"({MESH_INTERIOR} interior + ring at weight {RING_WEIGHT}), "
          f"{mesh.n_aug} augmented")
    hprom = engine("ecsw_hprom normal", lambda: ecsw_hprom(
        grid, mesh, sw32, y0, ba, DT, steps, *MU, ls_method="normal"))
    blocks = rf.precompute_factored_blocks(mesh, ba)
    engine("factored_hprom normal", lambda: rf.factored_hprom(
        grid, mesh, sw32, y0, blocks, DT, steps, *MU, ls_method="normal"),
        generic=hprom)
    p6p, wgt_p = rf.precompute_pallas_system(blocks, sw32)
    for label, kernel, kw in (
            ("normal", "gn_sampled_system", dict(ls_method="normal")),
            ("unroll3 cg", "gn_sampled_system",
             dict(ls_method="cg", unroll_its=3)),
            ("unroll3 fused", "gn_sampled_step",
             dict(ls_method="fused", unroll_its=3))):
        engine(f"pallas_hprom {label}", lambda kw=kw: rf.pallas_hprom(
            grid, mesh, p6p, wgt_p, y0, DT, steps, *MU, **kw), kernel,
            hprom)
    return dict(grid=grid, basis=basis, hdm=hdm, mesh=mesh, sw32=sw32,
                ba=ba, p6p=p6p, wgt_p=wgt_p, y0=y0, hprom=hprom)


def phase_fine_prom(card, launches):
    """The 750^2 streaming PROM (the case B3 was written for) against
    the generic LSPG PROM over its first 100 steps."""
    grid = Grid2D(nx=FINE_N, ny=FINE_N)
    basis, hdm = rom_basis(grid, card, solve_dtype=F32)
    w0 = torch.ones(grid.state_dim, dtype=F32, device=DEVICE)
    y0 = basis.T @ w0
    vu, vv, dmask, tr = rf.precompute_prom_pallas(grid, basis)
    prom = run_engine(
        f"{FINE_N}x{FINE_N} lspg_prom normal f32", lambda: lspg_prom(
            grid, w0, DT, FINE_LSPG_STEPS, *MU, basis, ls_method="normal"),
        None, FINE_LSPG_STEPS, launches, None, basis, hdm)
    run_engine(f"{FINE_N}x{FINE_N} pallas_prom normal f32",
               lambda: rf.pallas_prom(grid, vu, vv, dmask, y0, DT,
                                      ROM_STEPS, *MU, tile_rows=tr),
               "gn_full", ROM_STEPS, launches, prom, basis, hdm)


def phase_ecsw_recipe(card, launches):
    """The HPROM offline recipe end to end at 64^2 (f64): training
    matrix on the card, host NNLS, the HPROM on the card and on the
    CPU."""
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
        nbytes = 6 * lay.nd_pad * lay.ny_pad * args[0].element_size()
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
    returns its B7 launches."""
    grid = Grid2D(nx=MAIN_N, ny=MAIN_N)
    w0 = torch.ones(grid.state_dim, dtype=F64, device=DEVICE)
    total = 0

    def run(steps):
        nonlocal total
        cw.LAUNCHES = 0
        cw.SEG_LAUNCHES = 0
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
          f"{statistics.median(its):.2f} Newton its/step, one B7 launch per "
          f"iteration, final state rel {diff:.3e} vs the exact chain "
          f"({card})")
    return total


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


def traj_bound(p6p, k, steps, b, its, evals, iters=rf.CG_ITERS):
    """B6's bound for one launch, from the systems it built and the
    updates it made."""
    _, n_p, kp = p6p.shape
    e = p6p.element_size()
    nbytes = (p6p.numel() + n_p + b * n_p + b * k + b * steps * kp) * e
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
            bound_ms, bound_by = traj_bound(p6p, k, TRAJ_STEPS, b,
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
    """The 9-point μ grid at 250^2: the HPROM sweeps for 500 steps and
    the seg FOM sweep for 100 steps; returns the B7 launches."""
    grid, mesh, y0 = ctx["grid"], ctx["mesh"], ctx["y0"]
    sw32, ba = ctx["sw32"], ctx["ba"]
    steps, n = ROM_STEPS, len(SWEEP_MUS)

    def timed(fn):
        reset_gn_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        check(bool(torch.isfinite(out).all()), "sweep not finite")
        return out, time.perf_counter() - t0, gn_counts()

    blocks = rf.precompute_factored_blocks(mesh, ba)

    def single(engine, mu):
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

    for engine, kw, reps in (("generic", dict(ls_method="normal"), 1),
                             ("factored", dict(ls_method="normal"), 1),
                             ("pallas_traj", dict(unroll_its=3), REPS)):
        runs = [timed(lambda kw=kw: sweep_hprom(
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
        worst = max(rel_err(red[i], single(engine, mu))
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = sweep_fom(grid, w0, DT, SWEEP_FOM_STEPS, SWEEP_MUS, **kw)
    check(bool(torch.isfinite(snaps).all()), "seg FOM sweep not finite")
    elapsed = time.perf_counter() - t0
    launches = cw.SEG_LAUNCHES
    check(launches > 0 and cw.LAUNCHES == 0,
          f"seg FOM sweep: {launches} seg and {cw.LAUNCHES} exact launches")
    check(tuple(snaps.shape) == (n, grid.state_dim, SWEEP_FOM_STEPS + 1),
          f"seg FOM sweep: shape {tuple(snaps.shape)}")
    print(f"[sweep] {ROM_N}x{ROM_N} {n}-point sweep_fom skewed seg={SEG} x "
          f"{SWEEP_FOM_STEPS} steps (f32 solves, f64 Newton): "
          f"{n * SWEEP_FOM_STEPS / elapsed:.2f} aggregate steps/s, "
          f"{launches} B7 launches ({launches / (n * SWEEP_FOM_STEPS):.2f} "
          f"per step) ({card})")
    return launches


def main():
    card = phase_environment()
    phase_build()
    kern = phase_kernel_vs_plain(card)
    seg_kern = phase_seg_kernel(card)
    phase_entry_step(card)
    launches, exact_final = phase_main_path(card)
    check(launches > 0, "the main path launched no wavefront kernel")
    seg_launches = phase_main_seg(card, exact_final)
    phase_gpu_vs_cpu()
    gn_kern = phase_gn_kernels(card)
    gn_launches = {k: 0 for k in GN_KERNELS}
    ctx = phase_rom_250(card, gn_launches)
    traj_kern = phase_traj_kernel(card, ctx)
    phase_rom_traj(card, ctx, gn_launches)
    seg_launches += phase_sweep(card, ctx, gn_launches)
    del ctx
    phase_fine_prom(card, gn_launches)
    phase_ecsw_recipe(card, gn_launches)
    check(seg_launches > 0, "the seg paths launched no segmented kernel")
    for k, v in gn_launches.items():
        check(v > 0, f"the ROM path launched no {k} kernel")

    def entry(name, source, replaces, n_launches, main, extra):
        """A kernel's line: the main-path numbers in f32, the others
        under suffixed keys. None of the seven is one PyTorch call, so
        library_ms is null (PERF.md)."""
        e = {"name": name, "route": "cuda",
             "source": f"finitedifference_tpu_torch/csrc/{source}",
             "replaces": f"finitedifference_tpu/ops/{replaces}",
             "launches": n_launches, "library_ms": None}
        e.update({key: main[key] for key in ("max_abs_err", "ms",
                                             "plain_ms", "bound_ms",
                                             "bound_by")})
        for suffix, numbers in extra.items():
            e.update({f"{key}_{suffix}": v for key, v in numbers.items()})
        return e

    entries = [
        entry("wavefront_solve", "wavefront.cu", "pallas_wavefront.py:128",
              launches, kern[F32], {"f64": kern[F64]}),
        entry("wavefront_seg", "wavefront.cu", "pallas_wavefront.py:238",
              seg_launches, seg_kern[F32], {"f64": seg_kern[F64]}),
    ]
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
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
