#!/usr/bin/env python3
"""Quick check and timing of the redesigned kernels B1, B3, B4, B5, B6 and
B7 on one NVIDIA GPU, for work on their sources (a minute or two each, where
chip_smoke.py takes six).

    python3 kernel_check_gpu.py [b1|b3|b6|b7|b45|b6phases|b6variants|
                                 b7variants|b45variants|all]
    python3 kernel_check_gpu.py times OUT.pt
    python3 kernel_check_gpu.py diff A.pt B.pt
    python3 kernel_check_gpu.py rnm
    python3 kernel_check_gpu.py ae
    python3 kernel_check_gpu.py ae250

Builds the kernels and prints the compiler's register and spill report for
them. b1: the exact wavefront solve against its plain version on a dozen
layouts (one warp, two warps, uneven CTAs, the widest), f32 and f64:
error, exact zeros off the band, two runs bit-equal, bit-equal to the
segment kernel with one segment, the time (CUDA events, median of 3 x 20
calls),
and the segment kernel's time beside it. b3: the full-grid system against
its plain version on small and ragged layouts, then at 750^2 and 250^2
with 95 modes the time of each geometry in VARIANTS (threads of a CTA,
CTAs per SM, largest chunk), set through cuda_gn_full.TUNING. b6: the
whole-trajectory kernel against its plain version on the bench mesh
layout and on ragged ones (k = 150, k = 60, k = 127; chunks that do not
divide among the cluster's CTAs), f32 and f64: error, equal GN counts in
f64, two runs and b = 1 bit-equal to its row of b = 9; then its time for
1 and 9 points. b45: the sampled system (B4) and step (B5) against their
plain versions on SAMPLED_CASES, f32 and f64, two runs bit-equal; then
at the bench mesh layout their eager and device (CUDA graph) times and
device kernels a call. b7: the segment solve against its plain version on
chip_smoke.SEG_LAYOUTS, then its time at 750^2 beside B1's. b6phases,
b6variants and b7variants time throw-away builds of the two kernels, each
with one phase left out or one constant changed (B6_PHASES at clusters of
8 and 16, B6_VARIANTS, B7_VARIANTS), for PERF.md's breakdowns; their
results are never used. times: B1, B7 and B6 on COMPARE_CASES, their
times and their outputs saved to OUT.pt; run from another checkout with
this script and chip_smoke.py copied in, it times that checkout's
kernels on the same inputs, and diff says which outputs of two such files
are bit-equal. rnm, no kernel of the port's own: the RNM trainer's epoch
at the 250^2 recipe's shape (4,058 training pairs, 10 -> 140, batch 16,
float32), eager (rnm_train._train_epoch) against the CUDA-graph replay
train_rnm runs on the card (minibatch.EpochGraph) from the same start
and permutations, each epoch's time and their parameters' difference,
then the closure's predict and jacfwd Jacobian times. ae, no kernel of
the port's own either: the autoencoder trainer's minibatch step at the
50^2 and 250^2 input widths (5,000 and 125,000; batch 16, float32,
4,058 training rows of random data), eager (ae_train._train_epoch) and
replayed from the CUDA graph train_autoencoder runs on the card
(minibatch.EpochGraph), from the same start and permutation: ms a step,
s an epoch, the parameters' difference, the peak device memory; then the
decoder's and its jacfwd Jacobian's times. ae250: run_ae_prom --retrain
at 250^2 and (4.75, 0.02) in a temporary directory (the runner's own
lines: epochs, losses, GN iterations, the error), with each checkpoint's
seconds and the peak device memory, then run_ae_prom on that checkpoint
(the load path, a float64 state), the first Gauss-Newton iteration on
that checkpoint taken apart (first_gn_step), then the training set's
constant and nearly constant float32 columns and its mean column
variance. Fails without a CUDA device or on any
disagreement.
"""

import re
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops import _build, gn
from finitedifference_tpu_torch.ops import cuda_gn as cg
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
BASE_CSRC = _build.CSRC_DIR


def report_build():
    path = _build.build()
    _build.load_library()
    text = path.with_suffix(".ptxas.txt").read_text()
    pattern = (r"Compiling entry function '(\S*(?:full_system|traj_kernel|"
               r"sampled_kernel|wavefront_exact|wavefront_seg)\S*)'.*?\n.*?"
               r"\n(.*?Used.*?)\n")
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
            seg1 = cw.solve_skewed_seg_cuda(*args, DT, grid, lay, n_seg=1,
                                            overlap=0)
            torch.cuda.synchronize()
            rel = max(cs.rel_err(g, w) for g, w in zip(got, want))
            cs.check(rel <= cs.KERNEL_TOL[dtype], f"B1 {nx}x{ny}: rel {rel}")
            cs.check(all(bool((g[off] == 0).all()) for g in got),
                     f"B1 {nx}x{ny}: nonzero off the band")
            cs.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                     f"B1 {nx}x{ny}: two runs differ")
            cs.check(all(torch.equal(a, b) for a, b in zip(seg1, got)),
                     f"B1 {nx}x{ny}: the one-segment kernel differs")
            ms = cs.cuda_ms(lambda: cw.solve_skewed_cuda(*args, DT, grid,
                                                         lay), calls=20)
            print(f"[b1] {nx}x{ny} layout {lay.nd_pad}x{lay.ny_pad} "
                  f"{str(dtype)[6:]}: rel {rel:.3e}, zeros off band, two "
                  f"runs and the one-segment kernel bit-equal; "
                  f"{ms:.4f} ms",
                  flush=True)
    grid = Grid2D(nx=750, ny=750)
    lay = sk.make_layout(grid)
    for dtype in (F32, F64):
        args = cs.skewed_inputs(lay, dtype, seed=7)
        ms = cs.cuda_ms(lambda: cw.solve_skewed_seg_cuda(
            *args, DT, grid, lay, n_seg=8, overlap=64), calls=50)
        print(f"[b1] segment kernel, 750x750, 8 segments, overlap 64, "
              f"{str(dtype)[6:]}: {ms:.4f} ms")


def check_b6():
    """B6 against its plain version: error, equal GN counts in f64, two
    runs bit-equal, the b = 1 run bit-equal to the same point's row of the
    b = 9 launch; then its time at the bench mesh layout for each cluster
    size in TRAJ_CLUSTERS."""
    steps = cs.TRAJ_STEPS
    # (n, k, sampled cells, dtype): the bench layout; k = 150 (kp 256) in
    # f32; an n_p the cluster's CTAs do not split evenly (7 chunks, the
    # last one ragged); a k + 1 on no 16-lane boundary
    cases = [(250, 95, 1508, F32), (250, 95, 1508, F64),
             (24, 150, 220, F32), (40, 60, 205, F64), (40, 60, 205, F32),
             (24, 127, 300, F64)]
    for n, k, n_cells, dtype in cases:
        args = cs.traj_inputs(n, k, n_cells, dtype, 9)
        p6p = args[0]
        geo = cg.traj_geometry(p6p.shape[1], k, p6p.element_size())
        tol = 1e-10 if dtype == F64 else 1e-4
        got = gn.trajectory_hprom(*args, steps)
        again = gn.trajectory_hprom(*args, steps)
        one = gn.trajectory_hprom(args[0], args[1][4:5].contiguous(),
                                  args[2][4:5].contiguous(), *args[3:],
                                  steps)
        want = gn.trajectory_hprom_ref(*args, steps)
        torch.cuda.synchronize()
        rel = cs.rel_err(got.ys, want.ys)
        cs.check(bool(torch.isfinite(got.ys).all()), f"B6 {n, k}: not finite")
        cs.check(rel <= tol, f"B6 {n, k, dtype}: rel {rel}")
        if dtype == F64:
            cs.check(torch.equal(got.its, want.its)
                     and torch.equal(got.evals, want.evals),
                     f"B6 {n, k}: counts {got.its.tolist()} vs "
                     f"{want.its.tolist()}")
        cs.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                 f"B6 {n, k, dtype}: two runs differ")
        cs.check(torch.equal(one.ys, got.ys[4:5]),
                 f"B6 {n, k, dtype}: b = 1 differs from its row of b = 9")
        print(f"[b6] {n}x{n} k {k} layout {tuple(p6p.shape)} "
              f"{str(dtype)[6:]} 9 points: {geo.lanes} lanes, "
              f"{geo.n_chunks} chunks over {geo.cluster} CTAs: rel "
              f"{rel:.3e}, GN its {got.its.tolist()} (plain "
              f"{want.its.tolist()}), two runs and b = 1 bit-equal",
              flush=True)
    time_b6("b6", F32, F64)


def time_b6(tag, *dtypes, **kw):
    """B6's time at the bench mesh layout, 1 and 9 points x 50 steps."""
    for dtype in dtypes:
        full = cs.traj_inputs(250, 95, 1508, dtype, 9)
        for b in (1, 9):
            args = (full[0], full[1][:b].contiguous(),
                    full[2][:b].contiguous(), *full[3:], cs.TRAJ_STEPS)
            ms = cs.cuda_ms(lambda: gn.trajectory_hprom(*args, **kw),
                            calls=1)
            print(f"[{tag}] 250x250 bench layout {str(dtype)[6:]} {b} "
                  f"point(s) x {cs.TRAJ_STEPS} steps: {ms:.3f} ms",
                  flush=True)


# B6 variants, each a throw-away build: (what changes, [(old, new)] in
# csrc/gn_traj.cu). A cluster above 8 CTAs is not portable: the kernel
# must allow it before the launch.
CLUSTER_16 = [
    ("constexpr int kCluster = 8;", "constexpr int kCluster = 16;"),
    ("  if (err != cudaSuccess) return err;\n  cudaLaunchConfig_t cfg",
     "  if (err != cudaSuccess) return err;\n  err = cudaFuncSetAttribute("
     "kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
     "  if (err != cudaSuccess) return err;\n  cudaLaunchConfig_t cfg")]
B6_VARIANTS = [
    ("nothing", []),
    ("a cluster of 16 CTAs", CLUSTER_16),
    ("at most 288 threads (f32), 320 (f64)", [
        ("Threads<float> { static constexpr int value = 384; }",
         "Threads<float> { static constexpr int value = 288; }"),
        ("Threads<double> { static constexpr int value = 192; }",
         "Threads<double> { static constexpr int value = 320; }")]),
]


def edited(text, edits, what):
    """`text` with each (old, new) of `edits` made; fails if an old piece
    is missing."""
    for old, new in edits:
        old = old.replace("\\n", "\n")
        new = new.replace("\\n", "\n")
        cs.check(old in text, f"{what}: {old!r} not found")
        text = text.replace(old, new)
    return text


def check_b6_variants():
    """B6's time at the bench mesh layout in each of B6_VARIANTS."""
    text = (BASE_CSRC / "gn_traj.cu").read_text()
    for i, (what, edits) in enumerate(B6_VARIANTS):
        build_variant(f"b6v_{i}", "gn_traj.cu",
                      edited(text, edits, f"B6 variant {what}"))
        time_b6(f"b6-variants] [{what}", F32, F64)
    _build.CSRC_DIR = BASE_CSRC


# B6's phases, each left out in a throw-away build (FD_SKIP bit: the code
# that bit guards); what is left is timed with the stopping rules off, so
# every variant builds 3 systems and runs 3 CGs a step
B6_PHASES = {
    1: ("products", ["        for (int r = group; r < 2 * cells; "
                     "r += n_groups) {"]),
    2: ("CG", ["        cluster_cg(gram, lanes, k, solve_iters, pv, qpart, "
               "y);"]),
    4: ("reduce-scatter and all-gather", [
        "      for (int e = tid; e < own_tiles * kTile * kTile; "
        "e += nthreads) {",
        "      for (int e0 = tid; e0 < n_tiles * kTile * kTile;"]),
    8: ("scalars and rows", [
        "        for (int c = tid / kTeam; c < cells; c += nthreads / kTeam) {",
        "        for (int e = tid; e < cells * pieces; e += nthreads) {"]),
    16: ("chunk sums into the partial", [
        "        if (j % spc == spc - 1 || !more) {"]),
    32: ("bulk copies", ["    for (int e = tid; e < 6 * valid; "
                         "e += nthreads) {"]),
    64: ("cluster barriers of a system", [
        "      cluster.sync();\n      const int own_tiles",
        "      cluster.sync();\n      // all-gather"]),
}


def variant_source(text, skip):
    """gn_traj.cu with the fragments of the FD_SKIP bits in `skip` behind
    an `if`: a throw-away build for timing, never a result."""
    text = "#define FD_SKIP " + str(skip) + "\n" + text
    text = text.replace("barrier_expect(bar, 6 * valid * row_bytes)",
                        "barrier_expect(bar, (FD_SKIP & 32) ? 0 : "
                        "6 * valid * row_bytes)")
    for bit, (_, fragments) in B6_PHASES.items():
        for frag in fragments:
            frag = frag.replace("\\n", "\n")
            cs.check(frag in text, f"B6 phase {bit}: fragment not found")
            if frag.lstrip().startswith("if ("):
                text = text.replace(frag, frag.replace(
                    "if (", f"if (!(FD_SKIP & {bit}) && (", 1).replace(
                    ") {", ")) {", 1))
            else:
                indent = frag[:len(frag) - len(frag.lstrip())]
                text = text.replace(frag, f"{indent}if (!(FD_SKIP & {bit}))"
                                    f"\n{frag}")
    return text


def build_variant(name, source, text):
    """Build the package's sources with csrc/`source` replaced by `text`
    into a throw-away library, and load it in place of the real one."""
    import shutil
    csrc = _build.PKG_DIR / "_build" / "variants" / name
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(BASE_CSRC, csrc)
    (csrc / source).write_text(text)
    _build.CSRC_DIR = csrc
    _build.load_library.cache_clear()
    cg._traj_kernel.cache_clear()
    cg._kernel.cache_clear()
    cw._kernel.cache_clear()
    _build.build()


# B7 variants, each a throw-away build: (what changes, [(old, new)] in
# csrc/wavefront.cu)
B7_VARIANTS = [
    ("nothing", []),
    ("no input loads", [("    load_block(d0 + K, nxt);\n", "")]),
    ("no stores", [("        if (own_d && r < ny_pad) {",
                    "        if (false) {")]),
    ("no hand-off waits", [
        ("      barrier_wait(my_full + 8 * slot, (m / kSegRing) & 1);\n", ""),
        ("      if (m >= kSegRing)\n        barrier_wait(", "      if (false)\n"
         "        barrier_wait(")]),
    ("no reciprocal pass", [("  seg_inverse_kernel<T><<<", "  if (false) "
                             "seg_inverse_kernel<T><<<")]),
    ("3 rows a lane in 8 warps", [
        ("ny_pad <= 32 * 2 * 12", "ny_pad <= 32 * 3 * 8"),
        ("launch_rows<T, 2, kMainK, 12>", "launch_rows<T, 3, kMainK, 8>")]),
    ("1 row a lane in 24 warps", [
        ("ny_pad <= 32 * 2 * 12", "ny_pad <= 32 * 1 * 24"),
        ("launch_rows<T, 2, kMainK, 12>", "launch_rows<T, 1, kMainK, 24>")]),
    ("hand-off every 8 diagonals (f32), 4 (f64)", [
        ("constexpr int kMainK = sizeof(T) == sizeof(float) ? 4 : 2;",
         "constexpr int kMainK = sizeof(T) == sizeof(float) ? 8 : 4;")]),
    ("hand-off every 2 diagonals (f32), 1 (f64)", [
        ("constexpr int kMainK = sizeof(T) == sizeof(float) ? 4 : 2;",
         "constexpr int kMainK = sizeof(T) == sizeof(float) ? 2 : 1;")]),
]


def check_b7_variants():
    """B7's time at 750^2 (n_seg 8, overlap 64) in each of B7_VARIANTS."""
    text = (BASE_CSRC / "wavefront.cu").read_text()
    grid = Grid2D(nx=750, ny=750)
    lay = sk.make_layout(grid)
    args = {dtype: cs.skewed_inputs(lay, dtype, seed=7)
            for dtype in (F32, F64)}
    for i, (what, edits) in enumerate(B7_VARIANTS):
        build_variant(f"b7_{i}", "wavefront.cu",
                      edited(text, edits, f"B7 variant {what}"))
        for dtype in (F32, F64):
            ms = cs.cuda_ms(lambda: cw.solve_skewed_seg_cuda(
                *args[dtype], DT, grid, lay, n_seg=cs.SEG,
                overlap=cs.SEG_OVERLAP), calls=50)
            print(f"[b7-variants] 750x750 n_seg {cs.SEG} overlap "
                  f"{cs.SEG_OVERLAP} {str(dtype)[6:]}, {what}: {ms:.4f} ms",
                  flush=True)
    _build.CSRC_DIR = BASE_CSRC


def check_b6_phases():
    """B6's time at the bench mesh layout (f32, 50 steps) with each phase
    in B6_PHASES left out in turn, stopping rules off, at a cluster of 8
    CTAs and of 16."""
    text = (BASE_CSRC / "gn_traj.cu").read_text()
    kw = dict(relnorm_cutoff=0.0, min_delta=-1.0)
    for skip in [0, *B6_PHASES]:
        what = B6_PHASES[skip][0] if skip else "nothing"
        for cluster, edits in ((8, []), (16, CLUSTER_16)):
            build_variant(f"b6_{skip}_{cluster}", "gn_traj.cu",
                          edited(variant_source(text, skip), edits,
                                 f"B6 cluster {cluster}"))
            time_b6(f"b6-phases] [3 systems and 3 CGs a step, cluster "
                    f"{cluster}, without {what}", F32, **kw)
    _build.CSRC_DIR = BASE_CSRC


def check_b7():
    """B7 against its plain version on chip_smoke's SEG_LAYOUTS, f32 and
    f64 (chip_smoke.seg_layout_check); then its time at 750^2 beside
    B1's."""
    for layout in cs.SEG_LAYOUTS:
        for dtype in (F32, F64):
            rel = cs.seg_layout_check(*layout, dtype)
            print(f"[b7] {layout} {str(dtype)[6:]}: rel {rel:.3e}, zeros "
                  f"off band, two runs bit-equal", flush=True)
    grid = Grid2D(nx=750, ny=750)
    lay = sk.make_layout(grid)
    for dtype in (F32, F64):
        args = cs.skewed_inputs(lay, dtype, seed=7)
        ms = cs.cuda_ms(lambda: cw.solve_skewed_seg_cuda(
            *args, DT, grid, lay, n_seg=cs.SEG, overlap=cs.SEG_OVERLAP),
            calls=50)
        b1 = cs.cuda_ms(lambda: cw.solve_skewed_cuda(*args, DT, grid, lay),
                        calls=50)
        print(f"[b7] 750x750 n_seg {cs.SEG} overlap {cs.SEG_OVERLAP} "
              f"{str(dtype)[6:]}: {ms:.4f} ms (B1 {b1:.4f} ms)", flush=True)


# B4/B5 layouts (n_s, k, tile): tiny, the bench mesh, 150 modes, a short
# last chunk over uneven CTAs, CTAs with several chunks, the tiles in two
# and three parts (the step's CG Gram spread over the cluster)
SAMPLED_CASES = [(40, 6, 8), (1508, 95, 256), (700, 150, 256),
                 (1000, 150, 8), (2600, 40, 8), (600, 200, 8),
                 (400, 255, 8)]


def sampled_args(n_s, k, tile, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p6 = torch.randn((6, n_s, k), generator=gen, dtype=dtype,
                     device="cuda") / k ** 0.5
    wgt = 1 + torch.rand(n_s, generator=gen, dtype=dtype, device="cuda")
    p6p, wgt_p = gn.pad_factored_inputs(p6, wgt, tile=tile, dtype=dtype)
    y = torch.randn(k, generator=gen, dtype=dtype, device="cuda")
    cp = 0.1 * torch.randn((p6p.shape[1], 2), generator=gen, dtype=dtype,
                           device="cuda")
    return p6p, y, cp, wgt_p, k, 0.5 * DT, 0.25 * DT


def sampled_fns(args):
    """B4 and B5 on args, with one workspace for all calls where the
    checkout has one (an older checkout's wrappers make their scratch)."""
    kw = {"workspace": gn.sampled_workspace(args[0], args[4])} \
        if hasattr(gn, "sampled_workspace") else {}
    return {"B4": lambda: (gn.gn_system(*args, **kw),),
            "B5": lambda: gn.gn_step(*args, **kw)}


def time_b45(tag, count=True):
    """B4 and B5 at the bench mesh layout, f32 and f64: eager and device
    ms a call, and (with `count`) the device kernels a call."""
    for dtype in (F32, F64):
        args = cs.sampled_system_inputs(dtype, seed=1)
        fns = sampled_fns(args)
        per_call = cs.device_kernels_per_call(fns) if count else {}
        for name, fn in fns.items():
            eager = cs.cuda_ms(fn, calls=50)
            device = cs.graph_ms(fn, calls=50)
            kernels = per_call[name] if count else "not counted"
            print(f"[{tag}] {name} 250x250 bench layout "
                  f"{tuple(args[0].shape)} {str(dtype)[6:]}: eager "
                  f"{eager:.4f} ms, device {device:.4f} ms, device kernels "
                  f"a call: {kernels}", flush=True)


def check_b45():
    for n_s, k, tile in SAMPLED_CASES:
        for dtype in (F32, F64):
            args = sampled_args(n_s, k, tile, dtype)
            fns = sampled_fns(args)
            got = [fns["B4"](), fns["B5"]()]
            again = [fns["B4"](), fns["B5"]()]
            want = [(gn.gn_system_ref(*args, tile),),
                    gn.gn_step_ref(*args, tile)]
            torch.cuda.synchronize()
            rel4 = cs.rel_err(got[0][0], want[0][0])
            rel5 = max(cs.rel_err(g, w) for g, w in zip(got[1], want[1]))
            same = all(torch.equal(a, b) for x, y in zip(got, again)
                       for a, b in zip(x, y))
            print(f"[b45] ({n_s}, {k}, {tile}) {str(dtype)[6:]}: B4 rel "
                  f"{rel4:.3e}, B5 rel {rel5:.3e}, two runs "
                  f"{'bit-equal' if same else 'DIFFER'}", flush=True)
            cs.check(rel4 <= cs.GN_TOL[dtype] and rel5 <= 100 *
                     cs.GN_TOL[dtype] and same, f"B4/B5 ({n_s}, {k}, "
                     f"{tile}) {dtype}")
    time_b45("b45")


# B4/B5 variants, each a throw-away build: (what changes, [(old, new)] in
# csrc/gn_sampled.cu)
B45_VARIANTS = [
    ("nothing", []),
    ("CG in 2 warps", [("constexpr int kCgWarps = 4;",
                        "constexpr int kCgWarps = 2;")]),
    ("no CG iterations", [("for (int it = 0; it < iters; ++it) {",
                           "for (int it = 0; it < 0; ++it) {")]),
    ("CG without the product", [
        ("for (int j = j0; j < j1; ++j) {",
         "for (int j = j0; j < j0; ++j) {")]),
    ("CG without warp sums", [
        ("dw = warp_sum(dw);", ""),
        ("const T rs_new = warp_sum(rr);", "const T rs_new = rr;")]),
    ("CG without divisions", [
        ("const T alpha = live ? rs / denom : T(0);",
         "const T alpha = live ? rs * denom : T(0);"),
        ("const T beta = live ? rs_new / rs : T(0);",
         "const T beta = live ? rs_new * rs : T(0);")]),
    ("no bulk copies", [
        ("barrier_expect(bar_addr, 6 * valid * row_bytes)",
         "barrier_expect(bar_addr, 0)"),
        ("for (int e = tid; e < 6 * valid; e += nthreads) {",
         "for (int e = tid; e < 0; e += nthreads) {")]),
    ("no scalars and rows", [
        ("for (int cc = tid / kTeam; cc < cells;",
         "for (int cc = tid / kTeam; cc < 0;"),
        ("for (int e = tid; e < cells * pieces; e += nthreads) {",
         "for (int e = tid; e < 0; e += nthreads) {")]),
    ("no products", [("for (int r = group; r < 2 * cells; r += n_groups)",
                      "for (int r = group; r < 0; r += n_groups)")]),
    ("no tiles into the partial", [
        ("  if (has) {\n    double* o = part + my_t;",
         "  if (false) {\n    double* o = part + my_t;")]),
    ("no reduce-scatter", [
        ("for (int e = 2 * tid; e < slice; e += 2 * nthreads) {\n"
         "    double2 v[kCluster];",
         "for (int e = 2 * tid; e < 0; e += 2 * nthreads) {\n"
         "    double2 v[kCluster];")]),
    ("no sum over the clusters", [
        ("        if (c < n_clusters) {\n          v[c] = __ldcg(",
         "        if (false) {\n          v[c] = __ldcg(")]),
]


def check_b45_variants(only=()):
    """B4's and B5's times in each of B45_VARIANTS (those whose name holds
    one of `only`, if given)."""
    text = (BASE_CSRC / "gn_sampled.cu").read_text()
    for i, (what, edits) in enumerate(B45_VARIANTS):
        if only and not any(o in what for o in only):
            continue
        build_variant(f"b45_{i}", "gn_sampled.cu",
                      edited(text, edits, f"B4/B5 variant {what}"))
        time_b45(f"b45-variants] [{what}", count=False)
    _build.CSRC_DIR = BASE_CSRC


# the cases `times` saves: (kernel, nx, ny, n_seg, overlap) for B1 and
# B7, the main path's layouts, one segment (B1's solve) and four above
# 768 rows (ny_pad 1024, 1152, 2048, 2176); (kernel, points) for B6 at
# the bench mesh layout
COMPARE_CASES = [("B3", 750), ("B3", 250), ("B4", 1508, 95, 256),
                 ("B5", 1508, 95, 256), ("B4", 1000, 150, 8),
                 ("B5", 1000, 150, 8),
                 ("B1", 750, 750, 1, 0), ("B7", 750, 750, 1, 0),
                 ("B7", 750, 750, 8, 64),
                 ("B7", 40, 1000, 4, 32), ("B7", 40, 1100, 4, 32),
                 ("B7", 20, 2000, 16, 8), ("B7", 20, 2100, 16, 8),
                 ("B6", 1), ("B6", 9)]


def times(out):
    """The time (CUDA events, median of 3) and the outputs of each of
    COMPARE_CASES in f32 and f64, the outputs saved to `out`."""
    saved = {}
    for case in COMPARE_CASES:
        for dtype in (F32, F64):
            device = None
            if case[0] == "B3":
                args = cs.full_system_inputs(case[1], dtype, seed=case[1])

                def fn(args=args):
                    return (gf.gn_full_system(*args),)
                calls = 20
                key = f"B3 {case[1]}x{case[1]} 95 modes"
            elif case[0] in ("B4", "B5"):
                args = sampled_args(*case[1:], dtype, seed=1)
                fn = sampled_fns(args)[case[0]]
                calls = 50
                device = cs.graph_ms(fn, calls=50)
                key = f"{case[0]} ({', '.join(map(str, case[1:]))})"
            elif case[0] == "B6":
                full = cs.traj_inputs(250, 95, 1508, dtype, 9)
                args = (full[0], full[1][:case[1]].contiguous(),
                        full[2][:case[1]].contiguous(), *full[3:],
                        cs.TRAJ_STEPS)

                def fn(args=args):
                    return gn.trajectory_hprom(*args)
                calls = 1
                key = (f"B6 250x250 bench layout {case[1]} point(s) x "
                       f"{cs.TRAJ_STEPS} steps")
            else:
                kernel, nx, ny, n_seg, overlap = case
                grid = Grid2D(nx=nx, ny=ny)
                lay = sk.make_layout(grid)
                args = cs.skewed_inputs(lay, dtype, seed=7)
                if kernel == "B1":
                    def fn(args=args, grid=grid, lay=lay):
                        return cw.solve_skewed_cuda(*args, DT, grid, lay)
                else:
                    def fn(args=args, grid=grid, lay=lay, n_seg=n_seg,
                           overlap=overlap):
                        return cw.solve_skewed_seg_cuda(
                            *args, DT, grid, lay, n_seg=n_seg,
                            overlap=overlap)
                calls = 50
                key = (f"{kernel} {nx}x{ny} layout {lay.nd_pad}x"
                       f"{lay.ny_pad} n_seg {n_seg} overlap {overlap}")
            key += f" {str(dtype)[6:]}"
            got = fn()
            ms = cs.cuda_ms(fn, calls=calls)
            saved[key] = [g.cpu() for g in got]
            extra = "" if device is None else f", device {device:.4f} ms"
            print(f"[times] {key}: {ms:.4f} ms{extra}", flush=True)
    for dtype in ("float32", "float64"):
        b1, b7 = (saved[f"{kernel} 750x750 layout 1536x768 n_seg 1 overlap "
                        f"0 {dtype}"] for kernel in ("B1", "B7"))
        same = all(torch.equal(x, y) for x, y in zip(b1, b7))
        word = "bit-equal to" if same else "differs from"
        print(f"[times] B7 with one segment {word} B1 at 750x750 {dtype}",
              flush=True)
    torch.save(saved, out)


def diff(a, b):
    """Which outputs of two `times` files are bit-equal, and how far apart
    the others are."""
    first, second = torch.load(a), torch.load(b)
    for key, xs in first.items():
        ys = second[key]
        if all(torch.equal(x, y) for x, y in zip(xs, ys)):
            print(f"[diff] {key}: bit-equal")
        else:
            gap = max(float((x - y).abs().max()) for x, y in zip(xs, ys))
            rel = max(cs.rel_err(x, y) for x, y in zip(xs, ys)
                      if x.is_floating_point())
            print(f"[diff] {key}: max abs difference {gap:.3e}, rel "
                  f"{rel:.3e}")


def time_rnm(epochs=6, n=4058, n_p=10, n_s=140, batch=16):
    """The RNM trainer's eager and graphed epochs side by side, then the
    closure's predict and Jacobian (module docstring)."""
    import time

    from finitedifference_tpu_torch.closures import ann
    from finitedifference_tpu_torch.training import minibatch as mb
    from finitedifference_tpu_torch.training import rnm_train as rt

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    q_p = 30 * torch.randn(n, n_p, generator=gen).to(dev)
    q_s = torch.randn(n, n_s, generator=gen).to(dev)
    eager = ann.init_rnm(n_p, n_s, device=dev)
    graphed = ann.init_rnm(n_p, n_s, device=dev)
    state = mb.adam_init_flat(eager)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = mb.EpochGraph(rt._rnm_loss, graphed, mb.adam_init_flat(graphed),
                          (q_p, q_s), batch)
    torch.cuda.synchronize()
    print(f"[rnm] graph capture {time.perf_counter() - t0:.3f} s")
    steps = n // batch
    for e in range(epochs):
        perm = torch.randperm(n, generator=gen).to(dev)
        t0 = time.perf_counter()
        state, loss_e = rt._train_epoch(eager, state, q_p, q_s, perm, batch,
                                        1e-3)
        loss_e = float(loss_e)
        t1 = time.perf_counter()
        _, loss_g = graph.run(graphed, (q_p, q_s), perm, 1e-3)
        loss_g = float(loss_g)
        t2 = time.perf_counter()
        diff = cs.rel_err(mb.flat_params(graphed)[0], mb.flat_params(eager)[0])
        cs.check(diff < 1e-4 and abs(loss_g / loss_e - 1) < 1e-4,
                 f"[rnm] epoch {e}: graphed against eager rel {diff}")
        t_e, t_g = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        print(f"[rnm] epoch {e} ({steps} steps of {batch}): eager "
              f"{t_e:.1f} ms ({t_e / steps:.3f} ms a step), graphed "
              f"{t_g:.1f} ms ({t_g / steps:.3f} ms a step); loss "
              f"{loss_e:.6e} / {loss_g:.6e}, parameters rel {diff:.1e}")
    closure = ann.rnm_closure(graphed)
    y = torch.randn(n_p, generator=gen, dtype=F64).to(dev)
    for name, fn in (("predict", closure.predict),
                     ("jacobian", closure.jacobian)):
        for _ in range(3):
            fn(y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn(y)
        torch.cuda.synchronize()
        print(f"[rnm] closure {name} (float64 state, float32 network): "
              f"{(time.perf_counter() - t0) * 10:.3f} ms a call")


def time_ae(n=4058, batch=16, latent=10, eager_steps=24):
    """The autoencoder trainer's eager and graphed steps side by side at the
    50^2 and 250^2 input widths, then the decoder and its Jacobian
    (module docstring)."""
    import time

    from finitedifference_tpu_torch.closures import autoencoder as tae
    from finitedifference_tpu_torch.training import ae_train
    from finitedifference_tpu_torch.training import minibatch as mb

    dev = torch.device("cuda")
    for dim in (5000, 125000):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator().manual_seed(0)
        x = (1 + 0.1 * torch.randn(n, dim, generator=gen)).to(dev)
        mu, sig = x.mean(0), x.std(0) + 1e-10
        loss = ae_train._loss(mu, sig)
        eager = tae.init_autoencoder(dim, latent, device=dev)
        graphed = tae.init_autoencoder(dim, latent, device=dev)
        n_params = sum(p.numel() for p in eager.parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = mb.EpochGraph(loss, graphed, mb.adam_init_flat(graphed),
                              (x,), batch)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        perm = torch.randperm(n, generator=gen).to(dev)
        # eager epochs of eager_steps steps, on the rows the graph's first
        # steps take
        xs = x[perm[: eager_steps * batch]]
        order = torch.arange(len(xs), device=dev)
        state = mb.adam_init_flat(eager)
        ae_train._train_epoch(eager, state, xs, mu, sig, order, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = ae_train._train_epoch(eager, state, xs, mu, sig, order,
                                         batch)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / eager_steps
        steps = n // batch
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, loss_g = graph.run(graphed, (x,), perm, 1e-3)
            float(loss_g)
            times.append(time.perf_counter() - t0)
        epoch_s = sorted(times)[1]
        cs.check(bool(torch.isfinite(loss_g)), f"[ae] {dim}: loss {loss_g}")
        print(f"[ae] width {dim}, {n_params / 1e6:.2f} M parameters, "
              f"{n} rows, batch {batch}: eager {eager_ms:.3f} ms a step "
              f"({eager_steps} steps); graphed {epoch_s:.4f} s an epoch of "
              f"{steps} steps ({epoch_s * 1e3 / steps:.3f} ms a step, median "
              f"of 3 epochs: {', '.join(f'{t:.4f}' for t in times)}); "
              f"capture {capture_s:.3f} s; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        # the graph's first eager_steps steps against the eager ones
        check = tae.init_autoencoder(dim, latent, device=dev)
        g2 = mb.EpochGraph(loss, check, mb.adam_init_flat(check), (xs,),
                           batch)
        g2.run(check, (xs,), order, 1e-3)
        ref = tae.init_autoencoder(dim, latent, device=dev)
        ae_train._train_epoch(ref, mb.adam_init_flat(ref), xs, mu, sig,
                              order, batch)
        diff = cs.rel_err(mb.flat_params(check)[0], mb.flat_params(ref)[0])
        cs.check(diff < 1e-4, f"[ae] {dim}: graphed against eager {diff}")
        print(f"[ae] width {dim}: {eager_steps} graphed steps against eager "
              f"from one start, parameters rel {diff:.1e}")
        scaled = tae.ScaledAE(graphed, mu, sig)
        decode, dec_jac, _ = tae.ae_decoder_fns(scaled)
        z = torch.randn(latent, generator=gen, dtype=torch.float64).to(dev)
        for name, fn in (("decode", decode), ("jacfwd Jacobian", dec_jac)):
            for _ in range(3):
                fn(z)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn(z)
            torch.cuda.synchronize()
            print(f"[ae] width {dim} {name} (float64 state, float32 "
                  f"network): {(time.perf_counter() - t0) * 20:.3f} ms a "
                  f"call")
        del x, xs, graph, g2, eager, graphed, check, ref, scaled


def first_gn_step(num_cells=250, mu=(4.75, 0.02), device="cuda"):
    """The AE ROM's first Gauss-Newton iteration at `mu` on the load path
    (the checkpoint in the working directory, the float64 state), taken
    apart: the residual norm along the truncated-SVD step dy for step
    lengths 2^-k, the best of the line search's four (1 to 1/8) against
    the start, the linear model's prediction beside each, and the decoder
    Jacobian against central differences along dy."""
    from finitedifference_tpu_torch.closures import autoencoder as tae
    from finitedifference_tpu_torch.ops.stencil import (
        burgers_residual_flat,
        inflow_bc_term,
        jacobian_times_basis,
        source_term,
    )
    from finitedifference_tpu_torch.runners import run_ae_prom
    from finitedifference_tpu_torch.runners.common import (
        default_config,
        make_problem,
        res_path,
    )
    from finitedifference_tpu_torch.snapshots import collect_snapshots
    from finitedifference_tpu_torch.solvers import lstsq_svd
    from finitedifference_tpu_torch.training.monitor import load_checkpoint

    dev = torch.device(device)
    cfg = default_config(num_cells)
    grid, w0 = make_problem(cfg)
    w0 = torch.as_tensor(w0, device=dev)
    snaps = collect_snapshots(cfg.mu_samples(), grid, w0, cfg.dt,
                              cfg.num_steps, snap_folder=cfg.snap_folder)
    mu_in = torch.as_tensor(snaps.T.mean(axis=0), device=dev)
    sig_in = torch.as_tensor(snaps.T.std(axis=0) + 1e-10, device=dev)
    del snaps
    module = load_checkpoint(res_path(cfg, run_ae_prom.MODEL_PATH),
                             tae.init_autoencoder(grid.state_dim, 10,
                                                  device=dev))
    decode, dec_jac, encode = tae.ae_decoder_fns(
        tae.ScaledAE(module=module, mu_in=mu_in, sig_in=sig_in))
    dt = torch.float64
    w0 = w0.to(dt)
    m1 = torch.tensor(mu[0], dtype=dt, device=dev)
    m2 = torch.tensor(mu[1], dtype=dt, device=dev)
    src = source_term(grid, m2, cfg.dt, dtype=dt, device=dev)
    lbc = inflow_bc_term(grid, m1, cfg.dt, dtype=dt, device=dev)
    z0 = encode(w0)
    wp = decode(z0)

    def res(w):
        return burgers_residual_flat(w, wp, m1, m2, cfg.dt, grid, src, lbc)

    f = res(wp)
    v = dec_jac(z0)
    jv = jacobian_times_basis(wp, v, cfg.dt, grid)
    dy = lstsq_svd(jv, -f)
    sv = torch.linalg.svdvals(jv)
    rn0 = float(torch.linalg.vector_norm(f))
    rows = []
    for k in range(0, 25, 2):
        a = 2.0 ** -k
        rows.append((k, float(torch.linalg.vector_norm(res(decode(
            z0 + a * dy)))) / rn0, float(torch.linalg.vector_norm(
                f + a * (jv @ dy))) / rn0))
    d = dy / torch.linalg.vector_norm(dy)
    vd = v @ d
    fd = {}
    for eps in (1e-2, 1e-3, 1e-4):
        cd = (decode(z0 + eps * d) - decode(z0 - eps * d)) / (2 * eps)
        fd[eps] = float(torch.linalg.vector_norm(cd - vd)
                        / torch.linalg.vector_norm(vd))
    best = min(r[1] for r in rows if r[0] <= 3)
    first = next((r[0] for r in rows if r[1] < 1.0), None)
    print(f"[ae250] the first GN iteration at {mu} (load path, float64 "
          f"state): |r| {rn0:.6e}, |z0| {float(torch.linalg.vector_norm(z0)):.4e}, "
          f"|dy| {float(torch.linalg.vector_norm(dy)):.4e}; J V singular "
          f"values {sv[0].item():.3e} .. {sv[-1].item():.3e}; the line "
          f"search's best ratio (steps 1 to 1/8) {best:.6f}; the first "
          f"2^-k below 1: k = {first}")
    print("[ae250] |r(z0 + 2^-k dy)| / |r(z0)| (the linear model's "
          "prediction): " + ", ".join(f"k={k} {a:.6f} ({b:.6f})"
                                       for k, a, b in rows))
    print("[ae250] decoder Jacobian along dy against central differences, "
          "relative: " + ", ".join(f"eps {e:g}: {r:.2e}"
                                   for e, r in fd.items()))


def run_ae250():
    """run_ae_prom --retrain at 250^2 in a temporary directory, each
    checkpoint timed, the peak device memory (module docstring)."""
    import os
    import shutil
    import tempfile
    import time

    from finitedifference_tpu_torch.runners import run_ae_prom
    from finitedifference_tpu_torch.training.monitor import TrainingMonitor

    saves = []
    save = TrainingMonitor.save_checkpoint

    def timed_save(self, module):
        t0 = time.perf_counter()
        save(self, module)
        saves.append(time.perf_counter() - t0)

    TrainingMonitor.save_checkpoint = timed_save
    home, work = os.getcwd(), tempfile.mkdtemp(prefix="fd_ae250_")
    os.chdir(work)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.perf_counter()
        elapsed, err = run_ae_prom.main(4.75, 0.02, retrain=True,
                                        num_cells=250)
        wall = time.perf_counter() - t0
        size = os.path.getsize(run_ae_prom.MODEL_PATH)
        peak = torch.cuda.max_memory_allocated(dev)
        # the load path on the checkpoint just saved: a float64 state
        t0 = time.perf_counter()
        elapsed64, err64 = run_ae_prom.main(4.75, 0.02, num_cells=250)
        wall64 = time.perf_counter() - t0
        first_gn_step()
        # the training set's float32 columns that the standardisation
        # blows up: nearly constant, with a nonzero standard deviation
        snaps = np.hstack([np.load(os.path.join("param_snaps", f))
                           for f in sorted(os.listdir("param_snaps"))
                           if f.startswith("mu1_4.25") or
                           f.startswith("mu1_4.875") or
                           f.startswith("mu1_5.5")]).T.astype(np.float32)
        std = snaps.std(axis=0)
        tiny = (std > 0) & (std < 1e-6)
        scaled = np.abs(snaps[:, tiny] - snaps[:, tiny].mean(axis=0)) / (
            std[tiny] + 1e-10)
        reach = (f"reach {scaled.max():.1f}" if tiny.any()
                 else "are none")
    finally:
        TrainingMonitor.save_checkpoint = save
        os.chdir(home)
        shutil.rmtree(work, ignore_errors=True)
    cs.check(bool(np.isfinite(err)) and bool(np.isfinite(err64)),
             f"[ae250] {err}, {err64}")
    print(f"[ae250] run_ae_prom --retrain --num-cells 250 at (4.75, 0.02): "
          f"wall {wall:.1f} s, online {elapsed:.3f} s ({500 / elapsed:.2f} "
          f"steps/s), error {err:.4f}%; {len(saves)} checkpoints of "
          f"{size / 2**20:.1f} MiB, {sum(saves) / len(saves):.3f} s each "
          f"(max {max(saves):.3f}, {sum(saves):.2f} s in all); peak device "
          f"memory {peak / 2**30:.2f} GiB")
    print(f"[ae250] run_ae_prom --num-cells 250 at (4.75, 0.02) on that "
          f"checkpoint (float64 state): wall {wall64:.1f} s, online "
          f"{elapsed64:.3f} s ({500 / elapsed64:.2f} steps/s), error "
          f"{err64:.4f}%")
    print(f"[ae250] training set {snaps.shape}: {int((std == 0).sum())} "
          f"constant float32 columns, {int(tiny.sum())} with 0 < std < 1e-6, "
          f"whose standardised values {reach}; the mean column variance "
          f"(the loss of reconstructing every row as the mean) "
          f"{float(np.mean(std.astype(np.float64) ** 2)):.6e}")


def main():
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    modes = ("b1", "b3", "b45", "b6", "b6phases", "b6variants", "b7",
             "b7variants", "b45variants", "rnm", "ae", "ae250", "all")
    if what == "diff":
        diff(sys.argv[2], sys.argv[3])
        return
    cs.check(what in (*modes, "times"), "usage: kernel_check_gpu.py "
             "[b1|b3|b45|b6|b6phases|b6variants|b7|b7variants|b45variants|"
             "rnm|ae|ae250|all] | times OUT.pt | diff A.pt B.pt")
    cs.check(torch.cuda.is_available(), "no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    if what == "times":
        times(sys.argv[2])
        print(card)
        return
    if what in ("rnm", "ae", "ae250"):
        {"rnm": time_rnm, "ae": time_ae, "ae250": run_ae250}[what]()
        print(card)
        return
    report_build()
    if what in ("b3", "all"):
        check_b3()
    if what in ("b1", "all"):
        check_b1()
    if what in ("b45", "all"):
        check_b45()
    if what == "b45variants":
        check_b45_variants(sys.argv[2:])
    if what in ("b6", "all"):
        check_b6()
    if what == "b6phases":
        check_b6_phases()
    if what == "b6variants":
        check_b6_variants()
    if what == "b7variants":
        check_b7_variants()
    if what in ("b7", "all"):
        check_b7()
    print(card)


if __name__ == "__main__":
    main()
