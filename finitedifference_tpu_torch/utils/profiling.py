"""Device profiling (role of the reference's ad-hoc time.time()
instrumentation, SURVEY.md §5): structured traces via torch.profiler
(PyTorch).

Counterpart of finitedifference_tpu/utils/profiling.py. Usage:

    with trace("traces/run1") as prof:
        run_something()
    # a Chrome trace under traces/run1 (chrome://tracing, Perfetto);
    # prof.key_averages() for the table
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler: the CPU, and the CUDA
    device where there is one. Writes `trace_<pid>_<ns>.json` (Chrome
    trace format) under `log_dir`, creating it; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Rolling wall-clock step-rate meter (prints like the reference's
    per-timestep progress lines but with rates)."""

    def __init__(self, label: str = "step", every: int = 50):
        self.label = label
        self.every = every
        self.count = 0
        self.t0 = time.time()

    def tick(self):
        self.count += 1
        if self.count % self.every == 0:
            rate = self.count / (time.time() - self.t0)
            print(f"... {self.label} {self.count} ({rate:.2f}/s)")
