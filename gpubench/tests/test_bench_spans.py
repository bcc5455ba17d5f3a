"""The program's spans laid over a trace (gpubench/spans.py) on synthetic
events, its tiny runs on the CPU, and the harness leaving the program's
tracing off."""

import pytest
import torch

from finitedifference_tpu_torch import rom_factored as rf
from finitedifference_tpu_torch.ops import gn
from finitedifference_tpu_torch.utils import profiling
from finitedifference_tpu_torch.utils.profiling import SpanRecord
from gpubench import spans
from gpubench.harness import run_cell
from gpubench.tests import tiny

US = 1_000


class _Event:
    """A kineto event of a torch whose events do not name their activity
    type (2.11): told apart by device and name."""

    def __init__(self, kind, start, end, corr, name="k"):
        self._k, self._s, self._e = kind, start, end
        self._c, self._n = corr, name

    def device_type(self):
        on = self._k in ("kernel", "gpu_memcpy", "gpu_memset",
                         "gpu_user_annotation")
        return (torch.autograd.DeviceType.CUDA if on
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._k.endswith("user_annotation")

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c

    def name(self):
        return self._n


class _NamedKind(_Event):
    def activity_type(self):
        return self._k


@pytest.mark.parametrize("event", [_NamedKind, _Event])
def test_kernels_and_gaps_go_to_the_innermost_span(event):
    """request [0, 100] us holds solve [10, 30] and residual [40, 70],
    which holds sync [45, 70]. A kernel goes to the innermost span around
    its launch, wherever it runs; a gap to the span the host was in when
    it began; a launch outside every span to none."""
    sp = [SpanRecord("fom.trajectory", 0, 100 * US, 1, 0, 1),
          SpanRecord("fom.solve", 10 * US, 30 * US, 2, 1, 1),
          SpanRecord("fom.residual", 40 * US, 70 * US, 3, 1, 1),
          SpanRecord("fom.sync", 45 * US, 70 * US, 4, 3, 1)]
    ev = [
        event("cuda_runtime", 12 * US, 13 * US, 7, "cudaLaunchKernel"),
        event("kernel", 20 * US, 50 * US, 7, "wavefront_exact_kernel"),
        event("cuda_runtime", 41 * US, 42 * US, 8, "cudaLaunchKernel"),
        event("kernel", 55 * US, 58 * US, 8, "add"),
        event("cuda_runtime", 35 * US, 36 * US, 9, "cudaMemcpyAsync"),
        event("gpu_memcpy", 58 * US, 59 * US, 9, "Memcpy DtoD"),
        event("cuda_runtime", 150 * US, 151 * US, 10, "cudaMemsetAsync"),
        event("gpu_memset", 152 * US, 154 * US, 10, "Memset"),
        event("gpu_user_annotation", 10 * US, 160 * US, 0, "fom.solve"),
        event("cpu_op", 12 * US, 13 * US, 8, "aten::add"),
    ]
    got = spans.attribute(ev, sp)
    assert dict(got.kernels["fom.solve"]) == {"wavefront_exact_kernel": 1}
    assert dict(got.kernels["fom.residual"]) == {"add": 1}
    assert dict(got.kernels["fom.trajectory"]) == {"Memcpy DtoD": 1}
    assert dict(got.kernels[None]) == {"Memset": 1}
    assert got.device_s["fom.solve"] == pytest.approx(30e-6)
    # gaps: [50, 55] us begins in sync, [59, 152] us in sync too
    assert dict(got.idle_s) == pytest.approx({"fom.sync": 98e-6})
    assert got.unattributed_share == pytest.approx(2 / 36)


def test_the_innermost_span_of_a_time():
    sp = [SpanRecord("a", 0, 10, 1, 0, 1), SpanRecord("b", 0, 4, 2, 1, 1),
          SpanRecord("c", 6, 8, 3, 1, 1), SpanRecord("d", 20, 30, 4, 0, 4)]
    index = spans.SpanIndex(sp)
    got = [getattr(index.at(t), "name", None)
           for t in (-1, 0, 3, 5, 7, 9, 15, 20, 31)]
    assert got == [None, "b", "b", "a", "c", "a", None, "d", None]


def test_a_traced_tiny_fom_counts_one_sync_an_update(tmp_path):
    s, bench = tiny.write(str(tmp_path))
    run, metrics, rep = spans.run(s, "tiny_exact", 3, bench=bench,
                                  device="cpu")
    its = run.total("newton_its")
    assert its > 0 and run.counters == {"fom.host_syncs": its}
    assert metrics["fom.host_syncs_per_newton_it"] == 1.0
    assert metrics["fom.enqueue_ms_per_newton_it"] > 0
    # no device on the CPU: nothing to lay the spans over
    assert "fom.residual_device_ms_per_newton_it" not in metrics
    assert not rep["device_s"] and rep["spans_per_pass"] > 3 * its
    assert len(rep["untraced_s"]) == len(rep["spans_on_s"]) == 2


def test_a_traced_tiny_hprom_counts_the_kernels_systems(tmp_path):
    """rom.gn_systems_per_update is the plain version's evals over its
    updates, on the batches of the traced pass."""
    s, bench = tiny.write(str(tmp_path))
    run, metrics, _ = spans.run(s, "tiny_hprom", 4, bench=bench,
                                device="cpu")
    evals, its = run.counters["rom.gn_systems"], run.total("gn_its")
    assert metrics["rom.gn_systems_per_update"] == evals / its
    assert metrics["rom.inputs_host_ms_per_batch"] > 0

    # the same batches straight through ops/gn.trajectory_hprom
    from gpubench import traffic
    from gpubench.drivers import hprom_trajectory as drv
    from gpubench.harness import open_cell

    _, _, ctx = open_cell(s, "tiny_hprom", bench, "cpu")
    state = drv.setup(ctx)
    p6p, y0, dt = state["p6p"], state["y0"], ctx.cfg["dt"]
    gen = traffic.requests(ctx.cfg, ctx.traffic, 4)
    want_evals = want_its = 0
    for _ in run.records:
        mus = next(gen)
        slbc = torch.stack([rf.traj_source(state["grid"], state["mesh"], dt,
                                           m1, m2, p6p.shape[1], p6p.dtype)
                            for m1, m2 in mus])
        out = gn.trajectory_hprom(
            p6p, y0.expand(len(mus), -1).contiguous(), slbc,
            state["wgt_p"], y0.shape[0], 0.5 * dt / state["grid"].dx,
            0.5 * dt / state["grid"].dy, ctx.cfg["num_steps"],
            **state["kwargs"])
        want_evals += int(out.evals.sum())
        want_its += int(out.its.sum())
    assert (evals, its) == (want_evals, want_its) and its < evals


@pytest.mark.parametrize("trace", [False, True])
def test_the_harness_leaves_the_programs_tracing_off(tmp_path, trace):
    """A harness run, traced or not, serves every request with the
    program's spans off; the span metrics find nothing to read in its Run
    and are left out of the line without an error."""
    s, bench = tiny.write(str(tmp_path))
    seen = []

    def patch(driver):
        serve = driver.serve

        def watched(state, req, *a, **kw):
            seen.append(profiling.enabled())
            return serve(state, req, *a, **kw)
        driver.serve = watched

    for name in spans.SPAN_METRICS:
        s["per_layer"].append({"name": name, "unit": "x", "better": "lower",
                               "source": "program_counter", "layer": "t",
                               "moves": "fom_steps_per_s"})
    result, _ = run_cell(s, "tiny_exact", 5, 0.05, trace, bench=bench,
                         device="cpu", patch=patch)
    assert result["correct"] and seen and not any(seen)
    assert not set(spans.SPAN_METRICS) & set(result["metrics"])
