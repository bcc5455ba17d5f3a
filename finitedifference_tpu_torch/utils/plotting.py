"""Plotting: midline slices, fields, animations and speedup/error
summaries (PyTorch port's copy).

Counterpart of finitedifference_tpu/utils/plotting.py (the role of the
reference's plot_snaps, hypernet2D.py:3147-3180, and
plot_snapshots_with_speedup_and_errors.py). Every function takes tensors
(on any device) or arrays, and draws host arrays: snapshots and weights
through device.to_host, cell centres in float64 on the CPU. Matplotlib is
imported inside the functions (the card's machine has none), and all
functions take and return figures and axes, so they run headless.
"""

from __future__ import annotations

import numpy as np
import torch

from finitedifference_tpu_torch.device import to_host


def _centres(grid):
    """(x, y): the cell centres as float64 host arrays."""
    return (to_host(grid.xc(dtype=torch.float64, device="cpu")),
            to_host(grid.yc(dtype=torch.float64, device="cpu")))


def plot_snaps(grid, snaps, snaps_to_plot, linewidth=2, color="black",
               linestyle="solid", label=None, fig_ax=None):
    """Midline slice plots: u(x, y=mid) and u(x=mid, y) for selected
    snapshot columns."""
    import matplotlib.pyplot as plt

    if fig_ax is None:
        fig, (ax1, ax2) = plt.subplots(2, 1)
    else:
        fig, ax1, ax2 = fig_ax

    x, y = _centres(grid)
    mid_x, mid_y = x.size // 2, y.size // 2
    first = True
    snaps = to_host(snaps)
    for ind in snaps_to_plot:
        lbl = label if first else None
        first = False
        snap = snaps[: y.size * x.size, ind].reshape(y.size, x.size)
        ax1.plot(x, snap[mid_y, :], color=color, linestyle=linestyle,
                 linewidth=linewidth, label=lbl)
        ax2.plot(y, snap[:, mid_x], color=color, linestyle=linestyle,
                 linewidth=linewidth, label=lbl)
    ax1.set_xlabel("$x$")
    ax1.set_ylabel(f"$u(x, y={y[mid_y]:.1f})$")
    ax1.grid(True)
    ax2.set_xlabel("$y$")
    ax2.set_ylabel(f"$u(x={x[mid_x]:.1f}, y)$")
    ax2.grid(True)
    return fig, ax1, ax2


def plot_speedup_errors(results: dict, out_path: str | None = None):
    """Bar chart of speedup vs FOM and relative error per ROM variant.

    results: {name: {"elapsed": s, "rel_err_pct": e}} with a "FOM" entry.
    """
    import matplotlib.pyplot as plt

    fom_time = results["FOM"]["elapsed"]
    names = [k for k in results if k != "FOM"]
    speedups = [fom_time / results[k]["elapsed"] for k in names]
    errors = [results[k]["rel_err_pct"] for k in names]

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.bar(names, speedups)
    ax1.set_ylabel("speedup vs FOM")
    ax1.tick_params(axis="x", rotation=45)
    ax2.bar(names, errors)
    ax2.set_ylabel("relative error (%)")
    ax2.tick_params(axis="x", rotation=45)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=200)
    return fig


def plot_reduced_mesh(grid, weights, out_path=None, title="",
                      max_points: int = 20000):
    """Scatter of the ECSW/ECM sampled mesh with weight magnitude as
    color and size (role of the reference's post-NNLS spy plot,
    run_HPROM_ecsw_joshua.py:104-111).

    weights: (n_cells,) full-grid weight field (zeros = unsampled). The
    fixed-weight boundary ring plots as small grey squares so the
    NNLS/ECM-selected interior support stands out. `max_points` guards
    against accidentally passing a dense field (e.g. all-ones unit
    weights) — the largest-weight cells are kept.
    """
    import matplotlib.pyplot as plt

    weights = to_host(weights).ravel()
    ny, nx = grid.ny, grid.nx
    sel = np.flatnonzero(weights > 0)
    if sel.size > max_points:
        sel = sel[np.argsort(weights[sel])[::-1][:max_points]]
    ring = np.zeros((ny, nx), dtype=bool)
    ring[0, :] = ring[-1, :] = True
    ring[:, 0] = ring[:, -1] = True
    ring = ring.ravel()

    x, y = _centres(grid)
    xs = x[sel % nx]
    ys = y[sel // nx]
    on_ring = ring[sel]
    w_sel = weights[sel]

    fig, ax = plt.subplots(figsize=(6.5, 6))
    if on_ring.any():
        ax.scatter(xs[on_ring], ys[on_ring], s=2, marker="s",
                   color="0.7", label=f"boundary ring "
                   f"(w={w_sel[on_ring].max():g})")
    inter = ~on_ring
    if inter.any():
        sc = ax.scatter(
            xs[inter], ys[inter],
            s=4 + 36 * w_sel[inter] / max(w_sel[inter].max(), 1e-30),
            c=w_sel[inter], cmap="viridis", norm="log" if
            (w_sel[inter].min() > 0
             and w_sel[inter].max() / w_sel[inter].min() > 50) else None)
        fig.colorbar(sc, ax=ax, label="ECSW weight")
    n_e = int(inter.sum())
    ax.set_xlim(0, float(grid.x_up))
    ax.set_ylim(0, float(grid.y_up))
    ax.set_xlabel("$x$")
    ax.set_ylabel("$y$")
    ax.set_title(title or f"reduced mesh: $N_e$={n_e} of "
                 f"{nx * ny - int(ring.sum())} interior cells")
    if on_ring.any():
        ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
    return fig


def _u_field(grid, snaps, ind):
    """u-component of a snapshot column as an (ny, nx) array."""
    nx, ny = grid.nx, grid.ny
    return to_host(snaps)[: nx * ny, ind].reshape(ny, nx)


def plot_field_2d(grid, snaps, inds, dt, out_path=None, cmap="viridis"):
    """2x2 panel of u(x, y) heatmaps at selected times (role of the
    reference's plot_2d_burgers.py::plot_characteristic_snapshot)."""
    import matplotlib.pyplot as plt

    x, y = _centres(grid)
    extent = [x.min(), x.max(), y.min(), y.max()]
    snaps = to_host(snaps)
    vmin = snaps[: x.size * y.size].min()
    vmax = snaps[: x.size * y.size].max()
    fig, axs = plt.subplots(2, 2, figsize=(10, 8), constrained_layout=True)
    for ax, ind in zip(axs.ravel(), inds):
        im = ax.imshow(_u_field(grid, snaps, ind), extent=extent,
                       origin="lower", cmap=cmap, aspect="auto",
                       vmin=vmin, vmax=vmax)
        ax.set_title(f"t = {ind * dt:.2f}")
        ax.set_xlabel("$x$")
        ax.set_ylabel("$y$")
    fig.colorbar(im, ax=axs, label="$u$", shrink=0.8)
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig


def plot_field_3d(grid, snaps, inds, dt, out_path=None, cmap="viridis",
                  stride=None):
    """2x2 panel of u(x, y) surface plots (role of plot_3d_burgers.py::
    plot_characteristic_snapshot_3d_pyvista, in matplotlib — pyvista is
    not in this image)."""
    import matplotlib.pyplot as plt

    x, y = _centres(grid)
    if stride is None:
        stride = max(x.size // 125, 1)   # keep the mesh drawable
    xs, ys = np.meshgrid(x[::stride], y[::stride])
    snaps = to_host(snaps)
    zmax = float(snaps[: x.size * y.size].max())
    fig = plt.figure(figsize=(12, 9))
    for k, ind in enumerate(inds):
        ax = fig.add_subplot(2, 2, k + 1, projection="3d")
        z = _u_field(grid, snaps, ind)[::stride, ::stride]
        ax.plot_surface(xs, ys, z, cmap=cmap, vmin=0.0, vmax=zmax,
                        rstride=1, cstride=1, linewidth=0,
                        antialiased=False)
        ax.set_zlim(0.0, zmax)
        ax.set_title(f"t = {ind * dt:.2f}")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig


def animate_field(grid, snaps, inds, out_path, dt, label="", mode="2d",
                  fps=15, cmap="viridis", stride=None):
    """GIF animation of the u field over time, 2D heatmap or 3D surface
    (roles of plot_2d_burgers.py::create_animation and
    plot_3d_burgers.py::create_3d_animation_pyvista)."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    x, y = _centres(grid)
    snaps = to_host(snaps)
    vmin = float(snaps[: x.size * y.size].min())
    vmax = float(snaps[: x.size * y.size].max())
    inds = list(inds)

    if mode == "2d":
        fig, ax = plt.subplots(figsize=(8, 6))
        im = ax.imshow(_u_field(grid, snaps, inds[0]),
                       extent=[x.min(), x.max(), y.min(), y.max()],
                       origin="lower", cmap=cmap, aspect="auto",
                       vmin=vmin, vmax=vmax)
        fig.colorbar(im, ax=ax, label="$u$")

        def update(ind):
            im.set_data(_u_field(grid, snaps, ind))
            ax.set_title(f"{label} t = {ind * dt:.2f}")
            return [im]
    else:
        if stride is None:
            stride = max(x.size // 100, 1)
        xs, ys = np.meshgrid(x[::stride], y[::stride])
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(projection="3d")

        def update(ind):
            ax.clear()
            z = _u_field(grid, snaps, ind)[::stride, ::stride]
            ax.plot_surface(xs, ys, z, cmap=cmap, vmin=0.0, vmax=vmax,
                            rstride=1, cstride=1, linewidth=0,
                            antialiased=False)
            ax.set_zlim(0.0, vmax)
            ax.set_title(f"{label} t = {ind * dt:.2f}")
            return []

    ani = FuncAnimation(fig, update, frames=inds, blit=False)
    ani.save(out_path, writer=PillowWriter(fps=fps), dpi=100)
    plt.close(fig)
    return out_path


def overlay_midline(grid, hdm_snaps, rom_snaps_by_label, ind, dt,
                    out_path=None):
    """HDM-vs-ROMs midline overlay at one time (role of the reference's
    animations/create_overlay_image_hdm_vs_roms.py): u(x, y=mid) with the
    HDM in black and each ROM dashed on top."""
    import matplotlib.pyplot as plt

    x = _centres(grid)[0]
    mid = grid.ny // 2
    fig, ax = plt.subplots(figsize=(9, 5))
    ax.plot(x, _u_field(grid, hdm_snaps, ind)[mid], "k-", lw=2.5,
            label="HDM")
    for (label, snaps), color in zip(
            rom_snaps_by_label.items(),
            ("red", "blue", "green", "orange", "purple")):
        ax.plot(x, _u_field(grid, snaps, ind)[mid], color=color, ls="--",
                lw=1.5, label=label)
    ax.set_xlabel("$x$")
    ax.set_ylabel(f"$u(x, y_{{mid}})$ at t = {ind * dt:.2f}")
    ax.grid(True)
    ax.legend(fontsize=9)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig


def animate_midline(grid, hdm_snaps, rom_snaps_by_label, inds, out_path,
                    dt, fps=15):
    """GIF of the HDM-vs-ROMs midline overlay over time (role of
    animations/create_combined_gif_hdm_vs_roms.py)."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    x = _centres(grid)[0]
    mid = grid.ny // 2
    hdm = to_host(hdm_snaps)
    vmax = float(hdm[: grid.n_cells].max()) * 1.05
    fig, ax = plt.subplots(figsize=(9, 5))
    (hdm_line,) = ax.plot(x, _u_field(grid, hdm, inds[0])[mid], "k-",
                          lw=2.5, label="HDM")
    rom_lines = []
    for (label, snaps), color in zip(
            rom_snaps_by_label.items(),
            ("red", "blue", "green", "orange", "purple")):
        (ln,) = ax.plot(x, _u_field(grid, snaps, inds[0])[mid],
                        color=color, ls="--", lw=1.5, label=label)
        rom_lines.append((ln, to_host(snaps)))
    ax.set_ylim(0.0, vmax)
    ax.set_xlabel("$x$")
    ax.grid(True)
    ax.legend(fontsize=9)

    def update(ind):
        hdm_line.set_ydata(_u_field(grid, hdm, ind)[mid])
        for ln, snaps in rom_lines:
            ln.set_ydata(_u_field(grid, snaps, ind)[mid])
        ax.set_ylabel(f"$u(x, y_{{mid}})$ at t = {ind * dt:.2f}")
        return [hdm_line] + [ln for ln, _ in rom_lines]

    ani = FuncAnimation(fig, update, frames=list(inds), blit=False)
    ani.save(out_path, writer=PillowWriter(fps=fps), dpi=100)
    plt.close(fig)
    return out_path
