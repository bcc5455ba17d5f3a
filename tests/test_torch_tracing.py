"""The port's program tracing (utils/profiling: spans and counters) on the
CPU: off it records nothing and changes no bit of a result; on, the skewed
FOM's, the whole-trajectory HPROM's and the full-grid PROM's spans nest
under their request's root, count what they should, share the clock of
torch.profiler's events and appear in `trace`'s Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch import fom
from finitedifference_tpu_torch import rom_factored as rf
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops import gn
from finitedifference_tpu_torch.rom import prepare_hprom
from finitedifference_tpu_torch.utils import profiling

F64 = torch.float64
DT = 0.05
MU = (4.75, 0.02)
FOM_STEPS = 4
FOM_SPANS = ("fom.trajectory", "fom.step_constant", "fom.solve",
             "fom.residual", "fom.sync")
# the skewed FOM's solver settings: exact, segmented, extrapolated guess
FOM_KW = {"exact": dict(block=4),
          "seg": dict(block=4, seg=3, seg_overlap=2),
          "extrapolate": dict(block=4, extrapolate_guess=True)}
HPROM_MUS = [(4.5, 0.018), (5.0, 0.025), (5.4, 0.016)]
PROM_STEPS = 6
PROM_SPANS = ("rom.prom_trajectory", "rom.prom_system", "rom.prom_solve",
              "rom.gn_update")


def run_fom(kind, mu=MU):
    grid = Grid2D(nx=16, ny=16, x_up=100.0, y_up=100.0)
    w0 = torch.ones(grid.state_dim, dtype=F64)
    return fom.inviscid_burgers_implicit2d_skewed(
        grid, w0, DT, FOM_STEPS, *mu, **FOM_KW[kind])


@pytest.fixture(scope="module")
def hprom():
    """A 12x12 HPROM of 6 POD modes of a 12x12 FOM trajectory, ECSW-like
    weights on 40 cells, padded blocks in float64."""
    grid = Grid2D(nx=12, ny=12, x_up=100.0, y_up=100.0)
    w0 = torch.ones(grid.state_dim, dtype=F64)
    snaps = fom.inviscid_burgers_implicit2d_skewed(
        grid, w0, DT, 10, *MU, block=4).snaps
    basis = torch.linalg.svd(snaps, full_matrices=False)[0][:, :6]
    rng = np.random.default_rng(5)
    weights = np.zeros(grid.n_cells)
    chosen = rng.choice(grid.n_cells, size=40, replace=False)
    weights[chosen] = 1.0 + rng.uniform(size=40)
    mesh, sw, ba = prepare_hprom(grid, weights, basis)
    blocks = rf.precompute_factored_blocks(mesh, ba)
    p6p, wgt_p = rf.precompute_pallas_system(blocks, sw, dtype=F64)
    return dict(grid=grid, mesh=mesh, p6p=p6p, wgt_p=wgt_p,
                y0=basis.T @ w0)


def run_hprom(p, mus=HPROM_MUS):
    return rf.traj_hprom_batch(p["grid"], p["mesh"], p["p6p"], p["wgt_p"],
                               p["y0"], DT, 8, mus, unroll_its=3)


@pytest.fixture(scope="module")
def prom(hprom):
    """The full-grid PROM's padded float32 basis halves of the HPROM
    fixture's 6 modes."""
    grid = hprom["grid"]
    w0 = torch.ones(grid.state_dim, dtype=F64)
    snaps = fom.inviscid_burgers_implicit2d_skewed(
        grid, w0, DT, 10, *MU, block=4).snaps
    basis = torch.linalg.svd(snaps, full_matrices=False)[0][:, :6]
    vu_p, vv_p, dmask, tr = rf.precompute_prom_pallas(grid, basis)
    return dict(grid=grid, padded=(vu_p, vv_p, dmask),
                y0=(basis.T @ w0).to(torch.float32), tile_rows=tr)


def run_prom(p, unroll_its, mu=MU):
    return rf.pallas_prom(p["grid"], *p["padded"], p["y0"], DT, PROM_STEPS,
                          *mu, unroll_its=unroll_its,
                          tile_rows=p["tile_rows"])


def test_spans_nest_and_share_their_request():
    with profiling.recording() as rec:
        for _ in range(2):
            with profiling.span("root"):
                with profiling.span("a"):
                    with profiling.span("b"):
                        pass
                with profiling.span("c"):
                    pass
    assert [s.name for s in rec.spans] == ["b", "a", "c", "root"] * 2
    by_id = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent == 0]
    assert [s.name for s in roots] == ["root", "root"]
    assert roots[0].request != roots[1].request
    for s in rec.spans:
        assert s.request == (s.id if s.parent == 0 else
                             by_id[s.parent].request)
        assert s.start_ns <= s.end_ns
        if s.parent:
            outer = by_id[s.parent]
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert by_id[by_id[rec.spans[0].id].parent].name == "a"


def test_counters_sum_ints_and_tensors_when_read():
    with profiling.recording() as rec:
        profiling.count("n")
        profiling.count("n", 4)
        t = torch.tensor([1, 2])
        profiling.count("m", t)
        t += 10                # held by reference: read when summed
    assert rec.counters == {"n": 5, "m": 23}


def test_off_by_default_and_after_a_recording():
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b")
    with profiling.recording() as rec:
        assert profiling.enabled()
        with pytest.raises(RuntimeError):
            with profiling.span("fails"):
                raise RuntimeError
        with profiling.span("after"):
            pass
    assert not profiling.enabled()
    with profiling.span("off"):
        profiling.count("off")
    assert [(s.name, s.parent) for s in rec.spans] == [("fails", 0),
                                                       ("after", 0)]
    assert rec.counters == {}


@pytest.mark.parametrize("kind", ["exact", "seg", "extrapolate", "hprom",
                                  "prom_exact", "prom_unroll3"])
def test_off_records_nothing_and_on_changes_no_bit(kind, hprom, prom,
                                                   monkeypatch):
    """Off: no span is made and no counter kept (either would raise here);
    the results with tracing on are bit-equal to those with it off."""
    def run():
        if kind == "hprom":
            red, its = run_hprom(hprom)
            return [red, its]
        if kind.startswith("prom"):
            res = run_prom(prom, 3 if kind == "prom_unroll3" else 0)
            return [res.red_coords, torch.tensor(res.total_gn_its),
                    torch.tensor(res.gn_evals)]
        res = run_fom(kind)
        return [res.snaps, torch.tensor(res.total_newton_its),
                res.max_final_relnorm]

    def boom(*a, **kw):
        raise AssertionError("recorded while tracing is off")

    with monkeypatch.context() as m:
        m.setattr(profiling, "_Span", boom)
        m.setattr(profiling.Recorder, "add", boom)
        off = run()
    with profiling.recording() as rec:
        on = run()
    assert rec.spans
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["exact", "seg", "extrapolate"])
def test_fom_spans_sit_under_their_trajectory(kind):
    with profiling.recording() as rec:
        results = [run_fom(kind, mu) for mu in (MU, (4.3, 0.029))]
    by_id = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.name == "fom.trajectory"]
    assert len(roots) == 2 and all(r.parent == 0 for r in roots)
    assert roots[0].request != roots[1].request
    assert {s.name for s in rec.spans} == set(FOM_SPANS)
    for s in rec.spans:
        if s.parent == 0:
            continue
        top = s
        while top.parent:
            top = by_id[top.parent]
        assert top.name == "fom.trajectory" and s.request == top.id
    its = sum(r.total_newton_its for r in results)
    names = [s.name for s in rec.spans]
    assert names.count("fom.solve") == names.count("fom.residual") == its
    assert names.count("fom.step_constant") == 2 * FOM_STEPS
    syncs = its + (2 * FOM_STEPS if kind == "extrapolate" else 0)
    assert names.count("fom.sync") == syncs
    assert rec.counters == {"fom.host_syncs": syncs}


def test_gn_systems_count_the_trajectory_engines_evals(hprom):
    """rom.gn_systems is the `evals` of ops/gn.trajectory_hprom on the same
    batch (traj_hprom_batch returns only the updates)."""
    p = hprom
    n_p = p["p6p"].shape[1]
    slbc = torch.stack([rf.traj_source(p["grid"], p["mesh"], DT, mu1, mu2,
                                       n_p, F64) for mu1, mu2 in HPROM_MUS])
    y0b = p["y0"].expand(len(HPROM_MUS), -1).contiguous()
    want = gn.trajectory_hprom(p["p6p"], y0b, slbc, p["wgt_p"],
                               p["y0"].shape[0], 0.5 * DT / p["grid"].dx,
                               0.5 * DT / p["grid"].dy, 8, unroll_its=3)
    with profiling.recording() as rec:
        _, its = run_hprom(p)
    assert torch.equal(its, want.its)
    assert rec.counters == {"rom.gn_systems": int(want.evals.sum())}
    assert int(its.sum()) < rec.counters["rom.gn_systems"]
    names = [(s.name, s.parent != 0) for s in rec.spans]
    assert names == [("rom.traj_inputs", True), ("rom.traj_batch", False)]


@pytest.mark.parametrize("unroll_its", [0, 3], ids=["exact", "unroll3"])
def test_prom_spans_sit_under_their_trajectory(prom, unroll_its):
    """Every span of two full-grid PROM trajectories nests under its
    request's rom.prom_trajectory; rom.prom_system and the counter
    rom.gn_full_systems count ROMResult.gn_evals; rom.gn_sync and
    rom.gn_host_syncs count the exact loop's stop checks (a step's every
    system but its first) and are absent when masked."""
    with profiling.recording() as rec:
        results = [run_prom(prom, unroll_its, mu)
                   for mu in (MU, (4.3, 0.029))]
    by_id = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent == 0]
    assert [r.name for r in roots] == ["rom.prom_trajectory"] * 2
    assert roots[0].request != roots[1].request
    for s in rec.spans:
        top = s
        while top.parent:
            top = by_id[top.parent]
        assert top.name == "rom.prom_trajectory" and s.request == top.id
    evals = sum(r.gn_evals for r in results)
    checks = evals - 2 * PROM_STEPS
    names = [s.name for s in rec.spans]
    assert names.count("rom.prom_system") == evals
    assert names.count("rom.prom_solve") == evals
    assert names.count("rom.gn_update") == checks
    assert names.count("rom.gn_sync") == (0 if unroll_its else checks)
    assert set(names) == set(PROM_SPANS) | (
        set() if unroll_its else {"rom.gn_sync"})
    want = {"rom.gn_full_systems": evals}
    if not unroll_its:
        want["rom.gn_host_syncs"] = checks
    assert rec.counters == want
    if unroll_its:
        assert evals == unroll_its * 2 * PROM_STEPS
    else:
        # a check after each update of a step, the last one stopping it
        assert checks == sum(r.total_gn_its for r in results)
    # each rom.gn_sync sits in a rom.gn_update; systems and solves
    # directly under the trajectory
    for s in rec.spans:
        parent = by_id.get(s.parent)
        if s.name == "rom.gn_sync":
            assert parent.name == "rom.gn_update"
        elif s.name != "rom.prom_trajectory":
            assert parent.name == "rom.prom_trajectory"


def test_spans_share_the_profilers_clock():
    """Under torch.profiler (CPU activity) each span opens a
    record_function of its name, and reads its clock after that event's
    start and after its end: so each span starts and ends at or after its
    event (5 us of rounding allowed), and in the median within 50 us of
    it. An offset between the two clocks would move every span alike; a
    lone span may lie further off where the host was preempted."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]), \
            profiling.recording():
        run_fom("exact")          # the first record_function is slow
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.recording() as rec:
        run_fom("exact")
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in FOM_SPANS:
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    starts, ends = [], []
    for name in FOM_SPANS:
        spans = sorted((s.start_ns, s.end_ns) for s in rec.spans
                       if s.name == name)
        got = sorted(events[name])
        assert len(spans) == len(got) > 0
        for (s0, s1), (e0, e1) in zip(spans, got):
            starts.append(s0 - e0)
            ends.append(s1 - e1)
    assert min(starts) > -5_000 and min(ends) > -5_000
    assert statistics.median(starts) < 50_000
    assert statistics.median(ends) < 50_000


def test_trace_writes_the_spans_into_the_chrome_trace(tmp_path, hprom):
    log_dir = tmp_path / "traces"
    with profiling.trace(str(log_dir)):
        assert profiling.enabled()
        run_fom("exact")
        run_hprom(hprom)
    assert not profiling.enabled()
    files = os.listdir(log_dir)
    assert len(files) == 1
    with open(log_dir / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(FOM_SPANS) | {"rom.traj_batch", "rom.traj_inputs"} <= names
