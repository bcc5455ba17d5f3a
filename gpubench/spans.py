#!/usr/bin/env python3
"""The program's spans laid over a device trace, and the per-layer
metrics that read the program's spans and counters.

Each kernel, copy and fill of a torch.profiler trace is put down to the
innermost program span (finitedifference_tpu_torch/utils/profiling) that
encloses the host start of its launch: the CUDA runtime call with the
same correlation id. Each idle gap between the device's busy intervals
goes to the innermost span the host was in when the gap began. Spans and
kineto events share one clock, nanoseconds since the Unix epoch.

    python3 gpubench/spans.py --workload NAME --seed N [--rounds R]

serves a cell's traced requests (its traffic's `trace_requests`) with
the program's spans and counters on, from the root of a checkout: once
untraced; once under the device-only profiler (trace.Traced), spans
recorded, which gives the device and idle seconds by span; then R rounds
of untraced, spans on, spans on, untraced, timed on the host's clock,
whose first spans-on pass gives the host times and counters and whose
rounds give the cost of tracing when on (the median over rounds of the
spans-on seconds over the untraced seconds). It prints the by-span lines
and the cost on standard error and one JSON line on standard output:
the per-layer metrics of SPAN_METRICS and the cell's own, read from a
harness Run that carries `spans`, `counters` and `by_span`.
"""

from __future__ import annotations

import bisect
import collections
import os
import statistics
import sys
import time

# the per-layer metrics that read the program's spans and counters
SPAN_METRICS = ("fom.host_syncs_per_newton_it",
                "fom.enqueue_ms_per_newton_it",
                "fom.residual_device_ms_per_newton_it",
                "rom.gn_systems_per_update", "rom.inputs_host_ms_per_batch")


class SpanIndex:
    """The innermost span around a host time, for spans that nest (one
    thread's)."""

    def __init__(self, spans):
        # a parent before a child that starts in the same nanosecond
        self.spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
        self.starts = [s.start_ns for s in self.spans]
        self.by_id = {s.id: s for s in self.spans}

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        # the latest span to start is inside every span around t
        while s is not None and s.end_ns < t:
            s = self.by_id.get(s.parent)
        return s


class BySpan:
    """Device and idle seconds by span name (None: under no span), and
    the device kernels by span name {span: Counter(kernel name)}."""

    def __init__(self):
        self.device_s = collections.Counter()
        self.idle_s = collections.Counter()
        self.kernels = collections.defaultdict(collections.Counter)

    @property
    def unattributed_share(self):
        """The share of the device time whose launch is under no span."""
        total = sum(self.device_s.values())
        return self.device_s[None] / total if total else None


# kineto's activity types: what runs on the device, and what launches it
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_KINDS = {"cuda_runtime", "cuda_driver"}


def _kind(ev) -> str:
    import torch

    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    # torch 2.11's events do not name their activity type
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        annotation = getattr(ev, "is_user_annotation", None)
        return ("gpu_user_annotation" if annotation and annotation()
                else "kernel")
    return "cuda_runtime" if ev.name().startswith("cu") else "cpu_op"


def attribute(events, spans) -> BySpan:
    """Kineto events of one profiled window and the program spans
    recorded in it, laid over each other."""
    launches, dev = {}, []
    for ev in events:
        kind = _kind(ev)
        if kind in DEVICE_KINDS:
            dev.append(ev)
        elif kind in LAUNCH_KINDS:
            launches[ev.correlation_id()] = ev.start_ns()
    index = SpanIndex(spans)
    out = BySpan()
    busy = []
    for ev in dev:
        t = launches.get(ev.correlation_id())
        s = index.at(t) if t is not None else None
        name = s.name if s is not None else None
        out.device_s[name] += ev.duration_ns() * 1e-9
        out.kernels[name][ev.name()] += 1
        busy.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    busy.sort()
    end = None
    for s, e in busy:
        if end is not None and s > end:
            g = index.at(end)
            out.idle_s[g.name if g is not None else None] += (s - end) * 1e-9
        end = e if end is None else max(end, e)
    return out


def span_ms(spans, name):
    """Host milliseconds in the spans named `name`, or None where there is
    none."""
    ns = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return sum(ns) * 1e-6 if ns else None


def uncovered_ms(spans, root, inner):
    """Host milliseconds in the spans named `root` that no span named
    `inner` of the same request covers, or None where no span is named
    `root`."""
    roots = [s for s in spans if s.name == root]
    if not roots:
        return None
    ids = {s.request for s in roots}
    inside = sum(s.end_ns - s.start_ns for s in spans
                 if s.name == inner and s.request in ids)
    return (sum(s.end_ns - s.start_ns for s in roots) - inside) * 1e-6


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _top(counter, n=4):
    return dict(counter.most_common(n))


def run(spec, cell_name, seed, *, bench=None, device="cuda", rounds=1):
    """Serves `cell_name`'s traced requests the ways the module docstring
    says. Returns (harness Run with spans, counters and by_span; {metric:
    value} of SPAN_METRICS and the cell's per-layer metrics that read
    something; report dict)."""
    from finitedifference_tpu_torch.utils import profiling
    from gpubench import traffic as traffic_gen
    from gpubench.harness import Bench, Run, cell_metrics, open_cell
    from gpubench.trace import Traced

    bench = bench or Bench()
    _, driver, ctx = open_cell(spec, cell_name, bench, device)
    state = driver.setup(ctx)
    _sync(device)
    gen = traffic_gen.requests(ctx.cfg, ctx.traffic, seed)
    reqs = [next(gen) for _ in range(int(ctx.traffic["trace_requests"]))]

    def serve_all():
        t0 = time.perf_counter()
        recs = [driver.serve(state, r)[0] for r in reqs]
        _sync(device)
        return recs, time.perf_counter() - t0

    _, untraced_s = serve_all()
    with profiling.recording() as dev_rec, Traced() as tr:
        records, _ = serve_all()
    events = tr.prof.profiler.kineto_results.events()
    by_span = attribute(events, dev_rec.spans)
    kinds = collections.Counter(_kind(ev) for ev in events)
    tstats = tr.stats()
    tstats.untraced_s = untraced_s

    off, on, host = [], [], None
    for _ in range(rounds):
        for traced in (False, True, True, False):
            if traced:
                with profiling.recording() as rec:
                    _, s = serve_all()
                on.append(s)
                if host is None:
                    host = rec
            else:
                off.append(serve_all()[1])
    info = driver.release(state)

    r = Run(info, records, None, tr.window_s, tstats, bench.kernel_map())
    r.spans, r.counters, r.by_span = host.spans, host.counters, by_span
    names = list(SPAN_METRICS) + [m["name"] for m in
                                  cell_metrics(spec, cell_name, True)]
    metrics = {}
    for name in names:
        value = bench.module("metrics", name).read(r)
        if value is not None:
            metrics[name] = float(value)
    # each round's spans-on seconds over its untraced seconds: a drift
    # of the host's pace over the round cancels to first order
    rounds_pct = [100.0 * (sum(on[i:i + 2]) / sum(off[i:i + 2]) - 1.0)
                  for i in range(0, len(on), 2)]
    report = {
        "cost_pct": statistics.median(rounds_pct),
        "cost_rounds_pct": rounds_pct,
        "untraced_s": off, "spans_on_s": on,
        "spans_per_pass": len(host.spans), "counters": host.counters,
        "device_s": {str(k): v for k, v in by_span.device_s.items()},
        "idle_s": {str(k): v for k, v in by_span.idle_s.items()},
        "kernels": {str(k): _top(c) for k, c in by_span.kernels.items()},
        "launches": {str(k): sum(c.values())
                     for k, c in by_span.kernels.items()},
        "unattributed_share": by_span.unattributed_share,
        "event_kinds": dict(kinds),
        "busy_s": tstats.busy_s, "window_s": tstats.window_s,
    }
    return r, metrics, report


def _line(table):
    return " ".join(f"{k}={v:.6f}" for k, v in
                    sorted(table.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from gpubench.harness import ROOT, card_line, forbidden_modules

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=1)
    a = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    _, metrics, rep = run(spec, a.workload, a.seed, rounds=a.rounds)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"device by span: {_line(rep['device_s'])}", file=sys.stderr)
    print(f"idle by span: {_line(rep['idle_s'])}", file=sys.stderr)
    print(f"program tracing on: {rep['cost_pct']:+.1f}%", file=sys.stderr)
    print(json.dumps({"workload": a.workload, "seed": a.seed,
                      "metrics": metrics, **rep}), flush=True)
    return 0


if __name__ == "__main__":
    HERE = os.path.dirname(os.path.abspath(__file__))
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    sys.path.insert(0, os.path.dirname(HERE))
    sys.exit(main())
