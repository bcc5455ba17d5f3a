"""The full-grid PROM cell at CPU-test sizes: a tiny configuration and
traffic written by the test beside tiny.py's, run through the harness.

The sound program is correct; planted faults (a reduced trajectory left
unchanged, a Gauss-Newton update skipped, a step that takes its whole
budget, a bfloat16 basis) and the controls fail the check; the per-layer metrics that a CPU run can read
read; the roofline's count of a system is the hand-worked one.
"""

import json
import os

import pytest
import torch

from gpubench import roofline, roofline_gn_full, spans
from gpubench.controls import readings
from gpubench.harness import run_cell
from gpubench.tests import tiny

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# above the sound program's readings here (red_err 2.2e-7 - 4.1e-7, gaps
# 0) and below the controls' (bfloat16 basis: red_err 9.0e-4; one update
# a step: gn_gap 0.58 - 0.62)
LIMITS = {"red_err": 1e-5, "gn_gap": 0.05}


@pytest.fixture
def bench(tmp_path):
    """tiny.write's benchmark with the cell tiny_prom: the configuration
    of the real cell at 16^2, 20 steps and 8 modes."""
    root = str(tmp_path)
    spec, b = tiny.write(root)
    with open(os.path.join(HERE, "configs",
                           "burgers2d_fine_750_prom.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_prom", num_cells=16, num_steps=20)
    cfg["offline"]["num_modes"] = 8
    # a step of this coarse problem takes up to 3 updates, where 750^2
    # takes 2: the budget of masked systems stays one above that, so no
    # sound step takes its last update unchecked
    cfg["gauss_newton"]["unroll_its"] = 4
    with open(os.path.join(HERE, "workloads",
                           "prom_closed_unroll3.json")) as f:
        traffic = json.load(f)
    traffic["limits"] = dict(LIMITS)
    for kind, obj in (("configs", cfg), ("workloads", traffic)):
        with open(os.path.join(root, kind, "tiny_prom.json"), "w") as f:
            json.dump(obj, f)
    spec["workloads"].append({"name": "tiny_prom", "config": "tiny_prom",
                              "traffic": "tiny_prom", "chips": 1,
                              "why": "test"})
    return spec, b


def run(bench, patch=None, trace=False, seed=2 ** 33 + 7):
    spec, b = bench
    return run_cell(spec, "tiny_prom", seed, 0.05, trace, bench=b,
                    device="cpu", patch=patch)[0]


def wrap_setup(change):
    """A patch that lets `change(state, ctx)` alter the driver's state."""
    def patch(driver):
        setup = driver.setup

        def faulty_setup(ctx):
            state = setup(ctx)
            change(state, ctx)
            return state
        driver.setup = faulty_setup
    return patch


def test_the_sound_program_is_correct(bench):
    result = run(bench)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"rom_steps_per_s", "setup_s"}
    assert result["inputs_s"] > 0


def test_a_traced_run_reads_the_program_counters(bench):
    """On the CPU the device-trace metrics find nothing to read; the
    Gauss-Newton counts do."""
    result = run(bench, trace=True)
    assert result["correct"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert 2 <= m["rom.gn_its_per_step"] <= 3
    assert m["prom.systems_per_gn_update"] == pytest.approx(
        4 / m["rom.gn_its_per_step"])
    assert not {"gn_full_roofline", "prom.kernels_per_system",
                "device.idle_pct.rom"} & set(m)


def test_a_reduced_trajectory_left_unchanged_fails(bench):
    def frozen(state, ctx):
        entry = state["entry"]

        def still(*a, **kw):
            res = entry(*a, **kw)
            red = res.red_coords[:, :1].expand_as(res.red_coords)
            return res._replace(red_coords=red.contiguous())
        state["entry"] = still

    result = run(bench, wrap_setup(frozen))
    assert not result["correct"]
    assert result["checks"]["red_err"]["value"] > LIMITS["red_err"]


def test_a_skipped_gauss_newton_update_fails(bench, monkeypatch):
    """Two masked systems a step left out: the steps that need a third
    update do not get it."""
    from finitedifference_tpu_torch import rom_factored as rf

    gauss_newton = rf._gauss_newton

    def short(*a, n_iters, **kw):
        return gauss_newton(*a, n_iters=n_iters - 2, **kw)

    monkeypatch.setattr(rf, "_gauss_newton", short)
    result = run(bench)
    assert not result["correct"]
    assert result["checks"]["gn_gap"]["value"] > LIMITS["gn_gap"]


def test_a_step_that_takes_its_whole_budget_fails(bench):
    """With 2 masked systems a step, a step's second update goes
    unchecked: the request fails though its numbers match."""
    def two(state, ctx):
        state["kwargs"]["unroll_its"] = 2

    result = run(bench, wrap_setup(two))
    assert not result["correct"] and result["failed"] > 0
    assert result["checks"]["red_err"]["value"] <= LIMITS["red_err"]


def test_a_bfloat16_basis_fails(bench):
    def rounded(state, ctx):
        from gpubench.drivers import prom_trajectory as drv

        basis = ctx.basis.to(torch.bfloat16).to(torch.float64)
        state["model"] = drv._padded(state["grid"], ctx.cfg, basis,
                                     torch.float32)

    assert not run(bench, wrap_setup(rounded))["correct"]


@pytest.mark.parametrize("kind", ["program_bf16_basis",
                                  "program_one_update"])
def test_the_controls_fail_the_check(bench, kind):
    spec, b = bench
    got = list(readings(spec, "tiny_prom", [1, 2, 3], ["program", kind],
                        bench=b, device="cpu"))
    for r in got:
        over = [k for k, lim in LIMITS.items() if r[k] > lim]
        assert bool(over) == (r["kind"] == kind), r


def test_the_span_pass_counts_one_system_a_launch(bench):
    """spans.run: rom.gn_full_systems is the systems the records count."""
    spec, b = bench
    r, metrics, rep = spans.run(spec, "tiny_prom", 4, bench=b, device="cpu")
    assert r.counters == {"rom.gn_full_systems": r.total("gn_systems")}
    assert metrics["prom.systems_per_gn_update"] == \
        r.total("gn_systems") / r.total("gn_its")


def test_the_roofline_of_a_system():
    """4 cells, 2 modes in float32: the halves 2*4*2, y 2 and three fields
    of 4 in float32, the 3x3 float64 extension: 30*4 + 72 bytes; the
    scalars 4*4*2, the rows 18*4*2, the Gram 8 rows * 3 * 4: 272
    operations. At 750^2 and 95 modes in float32 the bound of PERF.md's
    kernel table, 0.1739 ms, bound by operations."""
    assert roofline_gn_full.system(4, 2, "float32") == (192, 272)
    work = roofline_gn_full.system(750 * 750, 95, "float32")
    t, kind = roofline.least_time(*work, "float32")
    assert (round(1e3 * t, 4), kind) == (0.1739, "operations")
    assert roofline_gn_full.least_seconds(750 * 750, 95, "float32", 3) \
        == pytest.approx(3 * t)
