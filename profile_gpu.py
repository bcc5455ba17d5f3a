#!/usr/bin/env python3
"""Where the device time goes on the port's 750^2 paths, on one NVIDIA GPU.

    python3 profile_gpu.py

Runs, each after a warm-up and under torch.profiler (CPU and CUDA
activities): the 750^2 FOM with the exact wavefront solve and with the
segmented solve (seg=8, overlap 64; f32 solves, f64 Newton, f32 snapshots)
and the 750^2 streaming PROM (pallas_prom, 95 modes from a 120-step FOM
trajectory), STEPS steps each. For each it prints the wall time of the same
run without the profiler, the device's busy time (the sum of the kernels'
device times), the idle share 1 - busy / wall, the kernels launched per
step, and the kernels with the largest device time by name. Fails without a
CUDA device.
"""

import subprocess
import time

import torch

from finitedifference_tpu_torch import rom_factored as rf
from finitedifference_tpu_torch.fom import inviscid_burgers_implicit2d_skewed
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.pod import pod

N = 750
DT = 0.05
MU = (4.75, 0.02)
STEPS = 30
MODES = 95
BASIS_STEPS = 120
TOP = 6
F32, F64 = torch.float32, torch.float64


def profile(label, fn, card):
    fn()   # warm-up: builds, caches, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    # the device's own events only: an operator's entry repeats the time
    # of the kernels it launched
    rows = [(e.key, e.self_device_time_total * 1e-6, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in rows)
    if busy == 0:
        raise RuntimeError("the profiler recorded no device time")
    launches = sum(c for _, _, c in rows)
    print(f"[profile] {label}: {STEPS} steps, wall {wall * 1e3:.1f} ms "
          f"({STEPS / wall:.1f} steps/s unprofiled), device busy "
          f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.3f}, "
          f"{launches / STEPS:.0f} kernels a step ({card})")
    for name, t, c in sorted(rows, key=lambda r: -r[1])[:TOP]:
        print(f"[profile]   {100 * t / busy:5.1f}% of busy, {c:6d} "
              f"launches, {1e6 * t / c:9.1f} us each: {name[:90]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    grid = Grid2D(nx=N, ny=N)
    w0 = torch.ones(grid.state_dim, dtype=F64, device="cuda")

    def fom(steps, **kw):
        return inviscid_burgers_implicit2d_skewed(
            grid, w0, DT, steps, *MU, solve_dtype=F32, snaps_dtype=F32, **kw)

    profile(f"{N}x{N} FOM, exact solve", lambda: fom(STEPS), card)
    profile(f"{N}x{N} FOM, seg=8 overlap=64",
            lambda: fom(STEPS, seg=8, seg_overlap=64), card)
    basis, _ = pod(fom(BASIS_STEPS).snaps, num_modes=MODES, method="rsvd",
                   random_state=0)
    y0 = basis.T @ torch.ones(grid.state_dim, dtype=F32, device="cuda")
    vu, vv, dmask, tr = rf.precompute_prom_pallas(grid, basis)
    profile(f"{N}x{N} pallas_prom, {MODES} modes",
            lambda: rf.pallas_prom(grid, vu, vv, dmask, y0, DT, STEPS, *MU,
                                   tile_rows=tr), card)
    print(card)


if __name__ == "__main__":
    main()
