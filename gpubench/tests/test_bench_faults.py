"""A run's check against planted faults and the controls, at CPU-test
sizes: the harness's look for a card is skipped, the rest of a run is
driven through `run_cell`, and `correct` has to come out false.

Faults planted underneath the timed path: a step that returns its state
unchanged, half of a batch left out (its other half's answers in its
place), an answer altered where it is produced. No cell spans chips, so
no exchange between chips can be left out.
"""

import pytest
import torch

from gpubench.controls import readings
from gpubench.harness import run_cell
from gpubench.tests import tiny

# limits of the tiny cells, set as the real cells' are: above the sound
# program's readings here (state_err 3.2e-16 - 4.0e-16, step_res 4.9e-15
# - 6.7e-15, red_err 0, gaps 0) and below the controls' (state_err 6.8e-8
# and up, step_res 1.5e-6 and up) and the faults'
FOM_LIMITS = {"state_err": 1e-12, "step_res": 1e-12, "newton_gap": 0.05}
HPROM_LIMITS = (1e-9,)


@pytest.fixture
def bench(tmp_path):
    return tiny.write(str(tmp_path), FOM_LIMITS, HPROM_LIMITS)


def run(bench, cell, patch=None, seed=5):
    spec, b = bench
    result, checks = run_cell(spec, cell, seed, 0.05, False, bench=b,
                              device="cpu", patch=patch)
    return result


def wrap_entry(transform):
    """A patch that passes the program's answers through `transform`."""
    def patch(driver):
        setup = driver.setup

        def faulty_setup(ctx):
            state = setup(ctx)
            entry = state["entry"]
            state["entry"] = lambda *a, **kw: transform(entry(*a, **kw), a)
            return state
        driver.setup = faulty_setup
    return patch


@pytest.mark.parametrize("cell", ["tiny_exact", "tiny_seg", "tiny_hprom"])
def test_the_sound_program_is_correct(bench, cell):
    assert run(bench, cell)["correct"]


@pytest.mark.parametrize("cell", ["tiny_exact", "tiny_seg"])
def test_a_solve_that_leaves_the_state_unchanged_fails(bench, cell,
                                                       monkeypatch):
    from finitedifference_tpu_torch.ops import skewed

    def nothing(su, sv, sfu, sfv, *a, **kw):
        return torch.zeros_like(sfu), torch.zeros_like(sfv)

    monkeypatch.setattr(skewed, "solve_skewed", nothing)
    monkeypatch.setattr(skewed, "solve_skewed_seg", nothing)
    result = run(bench, cell)
    assert not result["correct"]
    assert result["checks"]["state_err"]["value"] > FOM_LIMITS["state_err"]


@pytest.mark.parametrize("cell", ["tiny_exact", "tiny_seg"])
def test_an_altered_snapshot_fails(bench, cell):
    def alter(res, args):
        res.snaps[:, -1] *= 1 + 1e-6
        return res

    result = run(bench, cell, wrap_entry(alter))
    assert not result["correct"]


def test_a_reduced_trajectory_left_unchanged_fails(bench):
    def frozen(out, args):
        red, its = out
        return red[:, :, :1].expand_as(red).contiguous(), its

    assert not run(bench, "tiny_hprom", wrap_entry(frozen))["correct"]


def test_half_of_a_batch_left_out_fails(bench):
    def half(out, args):
        red, its = out
        keep = (len(red) + 1) // 2
        idx = torch.arange(len(red)) % keep
        return red[idx], its[idx]

    assert not run(bench, "tiny_hprom", wrap_entry(half))["correct"]


def test_an_altered_reduced_answer_fails(bench):
    def alter(out, args):
        red, its = out
        red = red.clone()
        red[0, :, -1] *= 1 + 1e-6
        return red, its

    assert not run(bench, "tiny_hprom", wrap_entry(alter))["correct"]


@pytest.mark.parametrize("cell,kind", [("tiny_exact", "program_f32"),
                                       ("tiny_exact", "reference_f32"),
                                       ("tiny_seg", "program_f32"),
                                       ("tiny_seg", "reference_f32"),
                                       ("tiny_hprom", "program_f32"),
                                       ("tiny_hprom", "reference_f32")])
def test_the_controls_fail_the_check(bench, cell, kind):
    """The float32 controls in the program's place, on three seeds: each
    reading fails one of the cell's limits."""
    spec, b = bench
    limits = dict(FOM_LIMITS, red_err=HPROM_LIMITS[0])
    for r in readings(spec, cell, [1, 2, 3], [kind], bench=b,
                      device="cpu"):
        assert any(r[k] > lim for k, lim in limits.items() if k in r), r
