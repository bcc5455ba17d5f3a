#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (finitedifference_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
1. environment: torch/CUDA versions, the card's name and power limit,
   TF32 off;
2. build the CUDA kernels from csrc/ (nvcc, at first use);
3. the wavefront kernel against its plain PyTorch version on the card,
   at the 750^2 main-path layout (1536, 768) and on a grid with
   ny > 1024, in float32 and float64: error, exact zeros off the band,
   and both times (CUDA events, median of 3);
4. the entry step: newton_step at 250^2 with a float32 state, on the card
   against the same call on the CPU;
5. the main path: inviscid_burgers_implicit2d_skewed at 750^2 with a
   float64 state and float32 snapshots, (a) with float32 solves and
   (b) with float64 solves; 5 warm-up steps, then 3 runs of 100 steps:
   steps/s, Newton iterations per step, one kernel launch per iteration;
6. a 64^2 float64 trajectory on the card against the CPU.

Then one JSON line on the kernels, the card line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without a CUDA device the script fails at once and prints no result.
"""

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from finitedifference_tpu_torch.config import BurgersConfig
from finitedifference_tpu_torch.fom import (
    inviscid_burgers_implicit2d_skewed,
    newton_step,
)
from finitedifference_tpu_torch.grid import Grid2D, grid_from_config
from finitedifference_tpu_torch.ops import _build
from finitedifference_tpu_torch.ops import cuda_wavefront as cw
from finitedifference_tpu_torch.ops import skewed as sk

DT = 0.05
MU = (4.75, 0.02)
MAIN_N = 750
WARM_STEPS = 5
MEAS_STEPS = 100
REPS = 3
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
F32, F64 = torch.float32, torch.float64


def check(ok, what):
    if not ok:
        raise AssertionError(what)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] allow_tf32: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}")
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


def phase_kernel_vs_plain(card):
    """Returns {dtype: (max_abs_err, ms, plain_ms)} at the main-path
    layout."""
    main = {}
    for nx, ny in ((MAIN_N, MAIN_N), (200, 1100)):
        grid = Grid2D(nx=nx, ny=ny)
        lay = sk.make_layout(grid)
        off_band = ~sk.valid_mask(lay, torch.bool, "cuda")
        for dtype in (F32, F64):
            args = skewed_inputs(lay, dtype, seed=nx + ny)
            got = cw.solve_skewed_cuda(*args, DT, grid, lay)
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
            ms = cuda_ms(lambda: cw.solve_skewed_cuda(*args, DT, grid, lay),
                         calls=20)
            plain_ms = cuda_ms(
                lambda: sk.solve_skewed_ref(*args, DT, grid, lay), calls=1)
            print(f"[kernel] {nx}x{ny} layout {lay.nd_pad}x{lay.ny_pad} "
                  f"{str(dtype)[6:]}: rel {rel:.3e} max_abs {abs_err:.3e}, "
                  f"zeros off band ok; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.2f} ms ({card})")
            if (nx, ny) == (MAIN_N, MAIN_N):
                main[dtype] = (abs_err, ms, plain_ms)
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
    kernel launches of all its runs."""
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
    return total_launches


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


def main():
    card = phase_environment()
    phase_build()
    kern = phase_kernel_vs_plain(card)
    phase_entry_step(card)
    launches = phase_main_path(card)
    check(launches > 0, "the main path launched no wavefront kernel")
    phase_gpu_vs_cpu()

    (err32, ms32, plain32), (err64, ms64, plain64) = kern[F32], kern[F64]
    print(json.dumps({"kernels": [{
        "name": "wavefront_solve",
        "route": "cuda",
        "source": "finitedifference_tpu_torch/csrc/wavefront.cu",
        "replaces": "finitedifference_tpu/ops/pallas_wavefront.py:128",
        "launches": launches,
        "max_abs_err": err32,
        "ms": ms32,
        "plain_ms": plain32,
        "max_abs_err_f64": err64,
        "ms_f64": ms64,
        "plain_ms_f64": plain64,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
