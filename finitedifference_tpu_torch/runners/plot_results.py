"""Render result plots from saved artifacts (role of the reference's
plot_snapshots_with_speedup_and_errors.py, plot_2d_burgers.py and the
midline-slice plots): FOM-vs-ROM midline slices for saved snapshot files
and speedup/error bars from rom_results*.npz, the sampled meshes of the
ecsw_weights_*.npy files, and optionally fields and animations. It reads
the files the port's runners write (the JAX runners' names), in the
working directory, on the CPU.

    python -m finitedifference_tpu_torch.runners.plot_results [--fields]
        [--animate] [--no-slices]

Matplotlib is imported inside the functions (the card's machine has
none); the figures are drawn with the Agg backend.
"""

import argparse
import glob
import os

import numpy as np

from finitedifference_tpu_torch.runners.common import (
    default_config,
    make_problem,
)


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_speedups(results_file: str, out: str,
                  fom_file: str = "rom_results.npz"):
    plt = _pyplot()
    data = dict(np.load(results_file))
    # keys: "<model>_<mu1>_<mu2>" -> [elapsed, rel_err_pct]
    foms = {k.split("_", 1)[1]: v[0] for k, v in data.items()
            if k.startswith("fom_")}
    # the hprom results file has no FOM baselines of its own — pull them
    # from the main results file
    if os.path.exists(fom_file) and fom_file != results_file:
        for k, v in dict(np.load(fom_file)).items():
            if k.startswith("fom_"):
                foms.setdefault(k.split("_", 1)[1], v[0])
    # keys are "<model>_<mu1>_<mu2>" with multi-underscore model names
    # (pod_rbf_hprom_knn, hrnm_ecm, ...): split from the right
    models = sorted({k.rsplit("_", 2)[0] for k in data} - {"fom"})
    mus = sorted({"_".join(k.rsplit("_", 2)[1:]) for k in data
                  if not k.startswith("fom_")})
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    width = 0.8 / max(len(models), 1)
    for i, m in enumerate(models):
        xs, speedups, errs = [], [], []
        for j, mu in enumerate(mus):
            key = f"{m}_{mu}"
            if key in data and mu in foms and data[key][0] > 0:
                xs.append(j + i * width)
                speedups.append(foms[mu] / data[key][0])
                errs.append(data[key][1])
        ax1.bar(xs, speedups, width=width, label=m)
        ax2.bar(xs, errs, width=width, label=m)
    ax1.set_ylabel("speedup vs FOM")
    ax1.set_xticks(range(len(mus)), mus, rotation=20)
    ax1.axhline(1.0, color="gray", lw=0.8, ls="--")
    ax2.set_ylabel("relative error (%)")
    ax2.set_xticks(range(len(mus)), mus, rotation=20)
    ax1.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=200)
    print(f"saved {out}")


def plot_slices(num_cells, num_steps, out_prefix: str):
    from finitedifference_tpu_torch.utils.plotting import plot_snaps

    plt = _pyplot()
    cfg = default_config(num_cells, num_steps)
    grid, w0 = make_problem(cfg)
    for rom_file in sorted(glob.glob("*_snaps_mu1_*.npy")):
        # parse mu from "<prefix>_snaps_mu1_X.XX_mu2_Y.YYY.npy"
        stem = os.path.splitext(rom_file)[0]
        parts = stem.split("_")
        mu1 = float(parts[parts.index("mu1") + 1])
        mu2 = float(parts[parts.index("mu2") + 1])
        # find the matching cached FOM (exact float formatting may differ)
        cands = glob.glob(os.path.join(cfg.snap_folder, "*.npy"))
        hdm_file = None
        for c in cands:
            name = os.path.basename(c)
            try:
                m1 = float(name.split("+")[0].split("_")[1])
                m2 = float(name.split("+")[1].split("_")[1].replace(
                    ".npy", ""))
            except (IndexError, ValueError):
                continue
            if abs(m1 - mu1) < 5e-3 and abs(m2 - mu2) < 5e-4:
                hdm_file = c
                break
        if hdm_file is None:
            continue
        hdm = np.load(hdm_file)
        rom = np.load(rom_file)
        if rom.shape[0] != grid.state_dim:
            # artifact from another resolution (e.g. the 50^2 AE rows
            # next to 250^2 files) — it gets plotted when plot_results
            # runs at ITS --num-cells, not this one
            continue
        steps_to_plot = range(0, rom.shape[1], max(rom.shape[1] // 5, 1))
        fig, ax1, ax2 = plot_snaps(grid, hdm, steps_to_plot, label="HDM")
        plot_snaps(grid, rom, steps_to_plot, label=stem.split("_snaps")[0],
                   color="blue", linewidth=1, fig_ax=(fig, ax1, ax2))
        ax1.legend(fontsize=8)
        fig.tight_layout()
        out = f"{out_prefix}{stem}.png"
        fig.savefig(out, dpi=200)
        plt.close(fig)
        print(f"saved {out}")


def plot_model_comparison(results_files, out="rom_comparison.png"):
    """One figure comparing every validated model family across the
    canonical test points (role of the reference's
    Paper_Results/compare_and_plot_proms.py:69-91, which plots HPROM vs
    HPROM-ANN vs HPROM-GPR vs HPROM-RBF): grouped error bars per model,
    merged from all rom_results*.npz archives."""
    plt = _pyplot()
    data = {}
    for rf in results_files:
        # the fine archive reuses the coarse key names (prom_4.75_0.02,
        # ...) at a different resolution — merging it here would silently
        # overwrite the coarse rows; it gets its own speedup figure
        if os.path.exists(rf) and "fine" not in rf:
            data.update(dict(np.load(rf)))
    models = sorted({k.rsplit("_", 2)[0] for k in data} - {"fom"})
    mus = sorted({"_".join(k.rsplit("_", 2)[1:]) for k in data
                  if not k.startswith("fom_")})
    fig, ax = plt.subplots(figsize=(11, 4.5))
    width = 0.9 / max(len(models), 1)
    for i, m in enumerate(models):
        xs, errs = [], []
        for j, mu in enumerate(mus):
            key = f"{m}_{mu}"
            if key in data and np.isfinite(data[key][1]):
                xs.append(j + i * width)
                errs.append(data[key][1])
        ax.bar(xs, errs, width=width, label=m)
    ax.set_ylabel("relative error (%)")
    ax.set_xticks([j + 0.45 for j in range(len(mus))],
                  [f"({mu.replace('_', ', ')})" for mu in mus])
    ax.set_xlabel("(mu1, mu2)")
    ax.legend(fontsize=8, ncols=3)
    ax.grid(True, axis="y", alpha=0.4)
    fig.tight_layout()
    fig.savefig(out, dpi=200)
    print(f"saved {out}")


def _find_hdm(cfg, mu1, mu2):
    """Cached FOM snapshot file matching (mu1, mu2), tolerant of float
    formatting differences between savers."""
    for c in glob.glob(os.path.join(cfg.snap_folder, "*.npy")):
        name = os.path.basename(c)
        try:
            m1 = float(name.split("+")[0].split("_")[1])
            m2 = float(name.split("+")[1].split("_")[1].replace(".npy", ""))
        except (IndexError, ValueError):
            continue
        if abs(m1 - mu1) < 5e-3 and abs(m2 - mu2) < 5e-4:
            return c
    return None


def _rom_files_by_mu():
    """Group saved ROM snapshot files: {(mu1, mu2): {label: path}}."""
    by_mu = {}
    for rom_file in sorted(glob.glob("*_snaps_mu1_*.npy")):
        stem = os.path.splitext(rom_file)[0]
        parts = stem.split("_")
        mu1 = float(parts[parts.index("mu1") + 1])
        mu2 = float(parts[parts.index("mu2") + 1])
        by_mu.setdefault((mu1, mu2), {})[stem.split("_snaps")[0]] = rom_file
    return by_mu


def plot_fields(num_cells, num_steps, animate=False):
    """2D heatmap + 3D surface panels (and optional GIFs) for each saved
    ROM snapshot file and its cached FOM, plus HDM-vs-ROMs overlays
    (roles of the reference's plot_2d_burgers.py / plot_3d_burgers.py /
    animations/*)."""
    from finitedifference_tpu_torch.utils.plotting import (
        animate_field,
        animate_midline,
        overlay_midline,
        plot_field_2d,
        plot_field_3d,
    )

    cfg = default_config(num_cells, num_steps)
    grid, _ = make_problem(cfg)
    for (mu1, mu2), roms in _rom_files_by_mu().items():
        hdm_file = _find_hdm(cfg, mu1, mu2)
        if hdm_file is None:
            continue
        hdm = np.load(hdm_file)
        n_t = hdm.shape[1]
        panel = [0, n_t // 3, 2 * n_t // 3, n_t - 1]
        tag = f"mu1_{mu1:.2f}_mu2_{mu2:.3f}"
        plot_field_2d(grid, hdm, panel, cfg.dt, f"field2d_hdm_{tag}.png")
        plot_field_3d(grid, hdm, panel, cfg.dt, f"field3d_hdm_{tag}.png")
        print(f"saved field2d/3d_hdm_{tag}.png")
        rom_snaps = {lbl: np.load(f) for lbl, f in roms.items()
                     if np.load(f, mmap_mode="r").shape == hdm.shape}
        if rom_snaps:
            overlay_midline(grid, hdm, rom_snaps, n_t - 1, cfg.dt,
                            f"overlay_{tag}.png")
            print(f"saved overlay_{tag}.png")
        if animate:
            frames = range(0, n_t, max(n_t // 100, 1))
            animate_field(grid, hdm, frames, f"anim2d_hdm_{tag}.gif",
                          cfg.dt, label="HDM", mode="2d")
            animate_field(grid, hdm, frames, f"anim3d_hdm_{tag}.gif",
                          cfg.dt, label="HDM", mode="3d")
            if rom_snaps:
                animate_midline(grid, hdm, rom_snaps, list(frames),
                                f"anim_overlay_{tag}.gif", cfg.dt)
            print(f"saved anim*_{tag}.gif")


def plot_reduced_meshes(out_prefix="reduced_mesh_"):
    """One sampled-mesh scatter per shipped weight family (reference
    run_HPROM_ecsw_joshua.py:104-111 spy plot; VERDICT r3 #6). Weight
    files carry the grid size in their suffix (no suffix = 250^2)."""
    from finitedifference_tpu_torch.grid import Grid2D
    from finitedifference_tpu_torch.utils.plotting import plot_reduced_mesh

    plt = _pyplot()
    for wf in sorted(glob.glob("ecsw_weights_*.npy")):
        stem = os.path.splitext(os.path.basename(wf))[0]
        weights = np.load(wf)
        n = int(round(np.sqrt(weights.size)))
        if n * n != weights.size:
            print(f"skip {wf}: not a square grid field ({weights.size})")
            continue
        grid = Grid2D(nx=n, ny=n, x_up=100.0, y_up=100.0)
        tag = stem.replace("ecsw_weights_", "")
        wf2 = weights.reshape(n, n)
        n_int = int((wf2[1:-1, 1:-1] > 0).sum())
        n_e = int((weights > 0).sum())   # RESULTS.md convention: total
        fig = plot_reduced_mesh(
            grid, weights, out_path=f"{out_prefix}{tag}.png",
            title=f"{tag}: $N_e$={n_e} ({n_int} interior) on {n}x{n}")
        plt.close(fig)
        print(f"saved {out_prefix}{tag}.png (N_e={n_e})")


def main(results=("rom_results.npz", "rom_results_hprom.npz",
                  "rom_results_fine.npz", "rom_results_ae.npz"),
         num_cells=None, num_steps=None, slices=True, fields=False,
         animate=False, reduced_meshes=True):
    if reduced_meshes:
        plot_reduced_meshes()
    for rf in results:
        # the AE archive is at its 50^2 reference scale: a speedup bar
        # against the 250^2 FOM would be meaningless; it still joins
        # the error-comparison figure. The fine (750^2) archive carries
        # its own FOM baseline rows, so its bars stay apples-to-apples.
        if os.path.exists(rf) and "ae" not in rf:
            plot_speedups(rf, rf.replace(".npz", "_speedup.png"))
    plot_model_comparison(results)
    if slices:
        plot_slices(num_cells, num_steps, "slice_")
    if fields or animate:
        plot_fields(num_cells, num_steps, animate=animate)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num-cells", type=int, default=None)
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--no-slices", action="store_true")
    p.add_argument("--fields", action="store_true",
                   help="2D heatmap + 3D surface panels + overlays")
    p.add_argument("--animate", action="store_true",
                   help="also write GIF animations (implies --fields)")
    a = p.parse_args()
    main(num_cells=a.num_cells, num_steps=a.num_steps,
         slices=not a.no_slices, fields=a.fields, animate=a.animate)
