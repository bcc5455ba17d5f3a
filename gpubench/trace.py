"""The reduction of a torch.profiler trace to what the per-layer metrics
read: device busy time (the union of the device's activity intervals),
device kernels by name, and the idle gaps named by what the host was
doing.

`Traced()` wraps the measured requests of a `--trace 1` run and records
the device's activity alone (kernels, copies, fills, and the CUDA
runtime calls that launch them); its window runs from the profiler's
start, after a synchronise, to a synchronise after the last traced
request. Even so the profiler costs a host-paced loop some of its time
(a 750² FOM trajectory on an H100 2.47 s traced against 2.04 s
untraced), which would read as idle, so the idle share is the busy time
over the seconds of the same requests run untraced in the same process.
Recording the host's operators too costs far more, so
`Traced(host=True)` does that in a pass of its own, whose trace only
names the idle gaps.
"""

from __future__ import annotations

import bisect
import collections
import re
import time

import torch

_COPY = re.compile(r"^(Memcpy|Memset)")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Traced:
    def __init__(self, host: bool = False):
        self.host = host

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        _sync()
        # without a card (the CPU tests) the host's pass is all there is
        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        if self.host or not acts:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def stats(self) -> "TraceStats":
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             self.window_s, name_gaps=self.host)


class TraceStats:
    """busy_s, window_s, kernels {name: (count, seconds)}, copies {name:
    (count, seconds)}, gaps [(host label, seconds)]; `untraced_s`, which
    the harness sets, the seconds of the same requests run untraced."""

    def __init__(self, busy_s, window_s, kernels, copies, gaps):
        self.busy_s, self.window_s = busy_s, window_s
        self.kernels, self.copies, self.gaps = kernels, copies, gaps
        self.untraced_s = None

    @property
    def idle_pct(self):
        """The share of the untraced seconds of the traced requests in
        which the device was not busy, in %."""
        if not self.untraced_s:
            return None
        return 100.0 * (1.0 - self.busy_s / self.untraced_s)

    @property
    def kernel_count(self) -> int:
        return sum(n for n, _ in self.kernels.values())

    def seconds_matching(self, patterns) -> float:
        """Device seconds of the kernels whose names match any pattern."""
        rx = [re.compile(p) for p in patterns]
        return sum(s for name, (_, s) in self.kernels.items()
                   if any(r.search(name) for r in rx))

    def breakdown(self, top: int = 10) -> dict:
        ops = collections.Counter()
        for table in (self.kernels, self.copies):
            for name, (_, s) in table.items():
                ops[name] += s
        gaps = collections.Counter()
        for label, s in self.gaps:
            gaps[label] += s
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}


def _is_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def reduce_events(events, window_s: float,
                  name_gaps: bool = True) -> TraceStats:
    dev, host = [], []
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        if _is_device(ev):
            dev.append((start, start + dur, ev.name()))
        else:
            host.append((start, start + dur, ev.name()))
    kernels = collections.defaultdict(lambda: [0, 0.0])
    copies = collections.defaultdict(lambda: [0, 0.0])
    for s, e, name in dev:
        table = copies if _COPY.match(name) else kernels
        table[name][0] += 1
        table[name][1] += (e - s) * 1e-9
    dev.sort()
    busy, gaps_ns = 0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps_ns.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return TraceStats(busy * 1e-9, window_s,
                      {k: tuple(v) for k, v in kernels.items()},
                      {k: tuple(v) for k, v in copies.items()},
                      _label_gaps(gaps_ns, host) if name_gaps else [])


def _label_gaps(gaps, host, keep: int = 2000):
    """Each of the `keep` longest gaps named by the host event that covers
    most of it, the innermost on a tie."""
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:keep]
    host = sorted(host)
    starts = [h[0] for h in host]
    out = []
    for gs, ge in gaps:
        best, label = (0, 0), "host: no event"
        hi = bisect.bisect_right(starts, ge)
        for hs, he, name in host[max(0, hi - 400):hi]:
            ov = min(he, ge) - max(hs, gs)
            if ov <= 0:
                continue
            key = (ov, -(he - hs))
            if key > best:
                best, label = key, "host: " + name
        out.append((label, (ge - gs) * 1e-9))
    return out
