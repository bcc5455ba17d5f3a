"""Program tracing and device profiling (role of the reference's ad-hoc
time.time() instrumentation, SURVEY.md §5).

Spans and counters mark where the program's work happens:

    with span("fom.solve"):
        du, dv = solve(...)
    count("fom.host_syncs")

Both are off by default. Off, `span` returns one shared object that does
nothing and `count` returns at once, each after one check of a module
flag: nothing is allocated, launched or synchronised. `recording()`
switches them on for a block and yields the Recorder that keeps them:

    with recording() as rec:
        run_something()
    torch.cuda.synchronize()
    rec.spans, rec.counters

On, a span keeps its name, its start and end in nanoseconds since the
Unix epoch (`time.time_ns`: the clock of torch.profiler's kineto events,
so that a span can be laid over a device trace), its own id, its
parent's id (0 for a root) and its request: the id of its root span,
shared by every span opened inside it. Under an active torch.profiler
session a span also opens `record_function(name)`. Even on, a span or a
counter never synchronises and launches nothing: a counter given a
tensor keeps it and sums it only when `Recorder.counters` is read, after
the caller's own synchronise. Spans are kept for the thread that opens
them; the program opens them from one thread.

`trace(log_dir)` profiles a block with torch.profiler, the program's
spans switched on, and writes a Chrome trace (chrome://tracing,
Perfetto) that shows the spans beside the operators and kernels:

    with trace("traces/run1") as prof:
        run_something()
    # prof.key_averages() for the table

The trace is the counterpart of finitedifference_tpu/utils/profiling.py.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import torch

_clock = time.time_ns
_on = False
_recorder: "Recorder | None" = None


class SpanRecord(NamedTuple):
    name: str
    start_ns: int     # time.time_ns() at the span's start
    end_ns: int
    id: int
    parent: int       # the enclosing span's id, 0 for a root
    request: int      # the root span's id


class Recorder:
    """The spans (SpanRecord, in the order they closed) and counters of
    one `recording()`."""

    def __init__(self):
        self.spans: list[SpanRecord] = []
        self._open: list[tuple[int, int]] = []   # (id, request) of each
        self._next_id = 1
        self._ints: dict[str, int] = {}
        self._tensors: dict[str, list] = {}

    def add(self, name: str, n):
        if isinstance(n, torch.Tensor):
            self._tensors.setdefault(name, []).append(n)
        else:
            self._ints[name] = self._ints.get(name, 0) + int(n)

    @property
    def counters(self) -> dict:
        """{name: total}. A counter given tensors reads them back here:
        read it after the device work that fills them has finished."""
        out = dict(self._ints)
        for name, ts in self._tensors.items():
            out[name] = out.get(name, 0) + sum(int(t.sum()) for t in ts)
        return out


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "request", "start", "rf")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.id = rec._next_id
        rec._next_id += 1
        if rec._open:
            self.parent, self.request = rec._open[-1]
        else:
            self.parent, self.request = 0, self.id
        rec._open.append((self.id, self.request))
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = _clock()
        rec = self.rec
        rec._open.pop()
        rec.spans.append(SpanRecord(self.name, self.start, end, self.id,
                                    self.parent, self.request))
        return False


def span(name: str):
    """A context manager that records the block as a span named `name`
    while recording is on, and does nothing otherwise."""
    if not _on:
        return _NO_SPAN
    return _Span(_recorder, name)


def count(name: str, n=1):
    """Adds `n` (an int, or a tensor summed when the counters are read) to
    the counter `name` while recording is on."""
    if _on:
        _recorder.add(name, n)


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def recording():
    """Switches spans and counters on for the block; yields the Recorder.
    A recording inside another keeps the block's spans to itself."""
    global _on, _recorder
    saved = (_on, _recorder)
    rec = Recorder()
    _on, _recorder = True, rec
    try:
        yield rec
    finally:
        _on, _recorder = saved


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler, the CPU and the CUDA device
    where there is one, with the program's spans on. Writes
    `trace_<pid>_<ns>.json` (Chrome trace format) under `log_dir`,
    creating it; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
