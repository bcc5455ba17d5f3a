"""The port's plotting layer (utils/plotting, runners/plot_results)
against the JAX package's, headless (Agg).

tests/test_plotting.py's inputs (a 12x12 grid, snapshots 1 + U[0, 1)
from seed 0) go through both packages' functions: the figure data (line
x- and y-data, image arrays, scatter offsets, bar heights) must be equal,
the cell centres within 1e-12 (torch's and JAX's linspace), and every file
must be written. The port's functions take tensors as well as arrays.
plot_results' functions run in two directories on the same artifacts and
must write the same files.
"""

import os
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from finitedifference_tpu.grid import Grid2D as JGrid2D  # noqa: E402
from finitedifference_tpu.utils import plotting as jplot  # noqa: E402
from finitedifference_tpu_torch.grid import Grid2D  # noqa: E402
from finitedifference_tpu_torch.runners import (  # noqa: E402
    plot_results as tresults,
)
from finitedifference_tpu_torch.utils import plotting as tplot  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "runners"))
import plot_results as jresults  # noqa: E402

DT = 0.05


@pytest.fixture(scope="module")
def problem():
    jg = JGrid2D(nx=12, ny=12, x_up=100.0, y_up=100.0)
    tg = Grid2D(nx=12, ny=12, x_up=100.0, y_up=100.0)
    rng = np.random.default_rng(0)
    snaps = 1.0 + rng.random((2 * jg.n_cells, 6))
    return jg, tg, snaps


def assert_lines_equal(got_ax, want_ax):
    assert len(got_ax.lines) == len(want_ax.lines) > 0
    for g, w in zip(got_ax.lines, want_ax.lines):
        np.testing.assert_array_equal(g.get_ydata(), w.get_ydata())
        np.testing.assert_allclose(g.get_xdata(), w.get_xdata(),
                                   rtol=1e-12)
        assert g.get_label() == w.get_label()
    assert got_ax.get_ylabel() == want_ax.get_ylabel()


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


def test_midline_slices(problem):
    jg, tg, snaps = problem
    _, j1, j2 = jplot.plot_snaps(jg, snaps, [0, 3, 5], label="HDM")
    _, t1, t2 = tplot.plot_snaps(tg, torch.as_tensor(snaps), [0, 3, 5],
                                 label="HDM")
    assert len(t1.lines) == 3
    assert_lines_equal(t1, j1)
    assert_lines_equal(t2, j2)


def test_field_2d_panel(problem, tmp_path):
    jg, tg, snaps = problem
    out = tmp_path / "f2d.png"
    jfig = jplot.plot_field_2d(jg, snaps, [0, 2, 4, 5], DT)
    tfig = tplot.plot_field_2d(tg, torch.as_tensor(snaps), [0, 2, 4, 5], DT,
                               str(out))
    assert out.exists() and out.stat().st_size > 0
    for ta, ja in zip(tfig.axes[:4], jfig.axes[:4]):
        np.testing.assert_array_equal(ta.images[0].get_array(),
                                      ja.images[0].get_array())
        assert ta.get_title() == ja.get_title()
        np.testing.assert_allclose(ta.images[0].get_extent(),
                                   ja.images[0].get_extent(), rtol=1e-12)


def test_field_3d_panel(problem, tmp_path):
    jg, tg, snaps = problem
    out = tmp_path / "f3d.png"
    jfig = jplot.plot_field_3d(jg, snaps, [0, 2, 4, 5], DT)
    tfig = tplot.plot_field_3d(tg, snaps, [0, 2, 4, 5], DT, str(out))
    assert out.exists() and out.stat().st_size > 0
    for ta, ja in zip(tfig.axes, jfig.axes):
        assert ta.get_zlim() == ja.get_zlim()
        assert ta.get_title() == ja.get_title()


def test_overlay(problem, tmp_path):
    jg, tg, snaps = problem
    roms = {"ROM-A": snaps * 1.01, "ROM-B": snaps * 0.99}
    out = tmp_path / "ov.png"
    jfig = jplot.overlay_midline(jg, snaps, roms, 5, DT)
    tfig = tplot.overlay_midline(
        tg, torch.as_tensor(snaps),
        {k: torch.as_tensor(v) for k, v in roms.items()}, 5, DT, str(out))
    assert out.exists() and out.stat().st_size > 0
    assert_lines_equal(tfig.axes[0], jfig.axes[0])


def test_reduced_mesh_and_speedup_bars(problem, tmp_path):
    jg, tg, _ = problem
    rng = np.random.default_rng(1)
    weights = np.zeros(jg.n_cells)
    weights[rng.choice(jg.n_cells, 30, replace=False)] = \
        rng.uniform(0.1, 9.0, 30)
    weights[:12] = 5.0                        # part of the boundary ring
    out = tmp_path / "mesh.png"
    jfig = jplot.plot_reduced_mesh(jg, weights)
    tfig = tplot.plot_reduced_mesh(tg, torch.as_tensor(weights),
                                   out_path=str(out))
    assert out.exists() and out.stat().st_size > 0
    for tc, jc in zip(tfig.axes[0].collections, jfig.axes[0].collections):
        np.testing.assert_allclose(tc.get_offsets(), jc.get_offsets(),
                                   rtol=1e-12)
        np.testing.assert_array_equal(tc.get_sizes(), jc.get_sizes())
    assert tfig.axes[0].get_title() == jfig.axes[0].get_title()

    results = {"FOM": {"elapsed": 10.0, "rel_err_pct": 0.0},
               "PROM": {"elapsed": 2.0, "rel_err_pct": 1.0},
               "HPROM": {"elapsed": 0.5, "rel_err_pct": 1.2}}
    out = tmp_path / "bars.png"
    jfig = jplot.plot_speedup_errors(results)
    tfig = tplot.plot_speedup_errors(results, str(out))
    assert out.exists() and out.stat().st_size > 0
    for ta, ja in zip(tfig.axes, jfig.axes):
        assert [p.get_height() for p in ta.patches] == \
            [p.get_height() for p in ja.patches]


@pytest.mark.parametrize("mode", ["2d", "3d"])
def test_animate_field(problem, tmp_path, mode):
    _, tg, snaps = problem
    out = tmp_path / f"a{mode}.gif"
    tplot.animate_field(tg, torch.as_tensor(snaps), range(0, 6, 2), str(out),
                        DT, mode=mode)
    assert out.exists() and out.stat().st_size > 0


def test_animate_midline(problem, tmp_path):
    _, tg, snaps = problem
    out = tmp_path / "am.gif"
    tplot.animate_midline(tg, snaps, {"ROM": torch.as_tensor(snaps * 1.01)},
                          [0, 2, 4], str(out), DT)
    assert out.exists() and out.stat().st_size > 0


def _artifacts(folder, grid, snaps):
    """A results archive, a weight field, a ROM snapshot file and its
    cached FOM, as the runners name them (12x12 files)."""
    os.makedirs(folder / "param_snaps_12x12")
    np.savez(folder / "rom_results.npz",
             **{"fom_4.75_0.02": [10.0, 0.0], "prom_4.75_0.02": [2.0, 1.1],
                "hprom_4.75_0.02": [0.5, 1.3], "fom_5.19_0.026": [11.0, 0.0],
                "prom_5.19_0.026": [2.5, 0.9]})
    weights = np.zeros(grid.n_cells)
    weights[[13, 40, 77, 100]] = [0.5, 2.0, 1.0, 3.0]
    np.save(folder / "ecsw_weights_lspg_12x12.npy", weights)
    np.save(folder / "param_snaps_12x12" / "mu1_4.75+mu2_0.02.npy", snaps)
    np.save(folder / "prom_snaps_mu1_4.75_mu2_0.02.npy", snaps * 1.01)


def test_plot_results_writes_the_jax_runners_files(problem, tmp_path,
                                                   monkeypatch):
    """plot_results' pieces (speedup bars, the model comparison, the
    reduced meshes, midline slices, fields and overlays) write the same
    files from the same artifacts in both packages."""
    jg, tg, snaps = problem
    written = {}
    for name, mod in (("jax", jresults), ("torch", tresults)):
        folder = tmp_path / name
        _artifacts(folder, tg, snaps)
        monkeypatch.chdir(folder)
        before = set(os.listdir(folder))
        mod.plot_reduced_meshes()
        mod.plot_speedups("rom_results.npz", "rom_results_speedup.png")
        mod.plot_model_comparison(["rom_results.npz"])
        mod.plot_slices(12, 5, "slice_")
        mod.plot_fields(12, 5)
        plt.close("all")
        written[name] = sorted(set(os.listdir(folder)) - before)
    assert written["torch"] == written["jax"]
    assert "slice_prom_snaps_mu1_4.75_mu2_0.02.png" in written["torch"]
    assert "overlay_mu1_4.75_mu2_0.020.png" in written["torch"]
    for f in written["torch"]:
        assert (tmp_path / "torch" / f).stat().st_size > 0
