#!/usr/bin/env python3
"""Quick check and timing of the redesigned kernels B1 and B3 on one
NVIDIA GPU, for work on their sources (a minute, where chip_smoke.py takes
six).

    python3 kernel_check_gpu.py [b1|b3|all]

Builds the kernels and prints the compiler's register and spill report for
the two kernels. b1: the exact wavefront solve against its plain version
on a dozen layouts (one warp, two warps, uneven CTAs, the widest), f32 and
f64: error, exact zeros off the band, two runs bit-equal, equal to the
segment kernel with one segment, the time (CUDA events, median of 3 x 20
calls), and the segment kernel's time beside it. b3: the full-grid system
against its plain version on small and ragged layouts, then at 750^2 and
250^2 with 95 modes the time of each geometry in VARIANTS (threads of a
CTA, CTAs per SM, largest chunk), set through cuda_gn_full.TUNING. Fails
without a CUDA device or on any disagreement.
"""

import re
import subprocess
import sys

import torch

import chip_smoke as cs
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops import _build
from finitedifference_tpu_torch.ops import cuda_gn_full as cgf
from finitedifference_tpu_torch.ops import cuda_wavefront as cw
from finitedifference_tpu_torch.ops import gn_full as gf
from finitedifference_tpu_torch.ops import skewed as sk

F32, F64 = torch.float32, torch.float64
DT = 0.05
B1_LAYOUTS = [(8, 6, 8), (13, 5, 128), (1000, 20, 128), (5, 300, 128),
              (750, 750, 128), (40, 1100, 128), (20, 2100, 128),
              (1000, 40, 128), (30, 900, 128), (300, 4000, 128),
              (250, 250, 128)]
B3_SMALL = [(12, 10, 6), (40, 33, 30), (64, 64, 150), (37, 29, 40)]
VARIANTS = {F32: [(384, 1, 32), (384, 1, 16), (192, 2, 16), (192, 2, 8),
                  (288, 1, 32), (96, 4, 8), (96, 3, 16)],
            F64: [(320, 1, 16), (288, 1, 16), (288, 1, 8), (192, 1, 16),
                  (96, 2, 16), (96, 3, 8), (96, 2, 8)]}


def report_build():
    path = _build.build()
    _build.load_library()
    text = path.with_suffix(".ptxas.txt").read_text()
    pattern = (r"Compiling entry function '(\S*(?:full_system|"
               r"wavefront_exact)\S*)'.*?\n.*?\n(.*?Used.*?)\n")
    for m in re.finditer(pattern, text, re.S):
        print(f"[build] ...{m.group(1)[-40:]}: {m.group(2).strip()[-120:]}")


def small_inputs(nx, ny, k, dtype):
    grid = Grid2D(nx=nx, ny=ny)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = grid.n_cells
    basis = torch.randn((2 * n, k), generator=gen, dtype=dtype,
                        device="cuda") / n ** 0.5
    vu, vv, tr = gf.pad_basis_full(basis, grid, 4, dtype=dtype)
    dmask = gf.row_mask(grid, tr, dtype, "cuda")
    nxp, _, tile = gf.full_layout(grid, tr)
    y = (1 + 0.1 * torch.randn(k, generator=gen, dtype=dtype,
                               device="cuda")) * (n / k) ** 0.5
    cp = 0.1 * torch.randn((vu.shape[0], 2), generator=gen, dtype=dtype,
                           device="cuda") * dmask
    slbc = 0.01 * torch.rand((vu.shape[0], 1), generator=gen, dtype=dtype,
                             device="cuda") * dmask
    hd = (0.5 * DT / grid.dx, 0.5 * DT / grid.dy)
    return vu, vv, y, cp, slbc, dmask, k, nxp, tile, hd


def check_b3():
    for shape in B3_SMALL:
        for dtype in (F32, F64):
            vu, vv, y, cp, slbc, dmask, k, nxp, tile, hd = small_inputs(
                *shape, dtype)
            g0, cp0 = gf.gn_full_first(vu, vv, y, slbc, dmask, k, nxp, tile,
                                       *hd)
            g1 = gf.gn_full_system(vu, vv, y, cp, dmask, k, nxp, tile, *hd)
            again = gf.gn_full_system(vu, vv, y, cp, dmask, k, nxp, tile, *hd)
            w0, wcp = gf.gn_full_ref(vu, vv, y, slbc, dmask, k, nxp, tile,
                                     *hd, True)
            w1, _ = gf.gn_full_ref(vu, vv, y, cp, dmask, k, nxp, tile, *hd,
                                   False)
            torch.cuda.synchronize()
            rel = max(cs.rel_err(g, w) for g, w in ((g0, w0), (g1, w1),
                                                    (cp0, wcp)))
            cs.check(rel <= cs.GN_TOL[dtype], f"B3 {shape} {dtype}: {rel}")
            cs.check(torch.equal(g1, again), f"B3 {shape}: two runs differ")
            cs.check(bool((g1[k + 1:] == 0).all()
                          and (g1[:, k + 1:] == 0).all()),
                     f"B3 {shape}: nonzero beyond lane k")
            print(f"[b3] {shape} {str(dtype)[6:]}: rel {rel:.3e}, two runs "
                  f"bit-equal, zeros beyond lane k")
    default = dict(cgf.TUNING)
    for n in (750, 250):
        for dtype in (F32, F64):
            args = cs.full_system_inputs(n, dtype, seed=n)
            want = gf.gn_full_ref(*args, False)[0]
            for variant in VARIANTS[dtype]:
                cgf.TUNING[args[0].element_size()] = variant
                got = gf.gn_full_system(*args)
                torch.cuda.synchronize()
                rel = cs.rel_err(got, want)
                cs.check(rel <= cs.GN_TOL[dtype], f"B3 {n} {variant}: {rel}")
                ms = cs.cuda_ms(lambda: gf.gn_full_system(*args), calls=20)
                mark = " (the default)" \
                    if variant == default[args[0].element_size()] else ""
                print(f"[b3] {n}x{n} {str(dtype)[6:]} threads, CTAs per SM, "
                      f"chunk {variant}{mark}: rel {rel:.3e}, {ms:.4f} ms",
                      flush=True)
            cgf.TUNING.update(default)
            del args


def check_b1():
    for nx, ny, block in B1_LAYOUTS:
        grid = Grid2D(nx=nx, ny=ny)
        lay = sk.make_layout(grid, block=block)
        off = ~sk.valid_mask(lay, torch.bool, "cuda")
        for dtype in (F32, F64):
            args = cs.skewed_inputs(lay, dtype, seed=nx + ny)
            got = cw.solve_skewed_cuda(*args, DT, grid, lay)
            again = cw.solve_skewed_cuda(*args, DT, grid, lay)
            want = sk.solve_skewed_ref(*args, DT, grid, lay)
            fits_seg = 8 * lay.ny_pad * args[0].element_size() \
                <= cw.MAX_SHARED_BYTES
            seg1 = cw.solve_skewed_seg_cuda(*args, DT, grid, lay, n_seg=1,
                                            overlap=0) if fits_seg else got
            torch.cuda.synchronize()
            rel = max(cs.rel_err(g, w) for g, w in zip(got, want))
            cs.check(rel <= cs.KERNEL_TOL[dtype], f"B1 {nx}x{ny}: rel {rel}")
            cs.check(all(bool((g[off] == 0).all()) for g in got),
                     f"B1 {nx}x{ny}: nonzero off the band")
            cs.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                     f"B1 {nx}x{ny}: two runs differ")
            cs.check(all(torch.equal(a, b) for a, b in zip(got, seg1)),
                     f"B1 {nx}x{ny}: differs from the one-segment kernel")
            ms = cs.cuda_ms(lambda: cw.solve_skewed_cuda(*args, DT, grid,
                                                         lay), calls=20)
            print(f"[b1] {nx}x{ny} layout {lay.nd_pad}x{lay.ny_pad} "
                  f"{str(dtype)[6:]}: rel {rel:.3e}, zeros off band, two "
                  f"runs bit-equal, equal to one segment; {ms:.4f} ms",
                  flush=True)
    grid = Grid2D(nx=750, ny=750)
    lay = sk.make_layout(grid)
    for dtype in (F32, F64):
        args = cs.skewed_inputs(lay, dtype, seed=7)
        ms = cs.cuda_ms(lambda: cw.solve_skewed_seg_cuda(
            *args, DT, grid, lay, n_seg=8, overlap=64), calls=50)
        print(f"[b1] segment kernel, 750x750, 8 segments, overlap 64, "
              f"{str(dtype)[6:]}: {ms:.4f} ms")


def main():
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    cs.check(what in ("b1", "b3", "all"), "usage: kernel_check_gpu.py "
             "[b1|b3|all]")
    cs.check(torch.cuda.is_available(), "no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    report_build()
    if what in ("b3", "all"):
        check_b3()
    if what in ("b1", "all"):
        check_b1()
    print(card)


if __name__ == "__main__":
    main()
