"""utils/ of the port on the CPU: Timer, phase_breakdown (the JAX keys,
positive times) and trace (a Chrome trace file under the log directory;
the program's spans: tests/test_torch_tracing.py)."""

import functools
import json
import os
import time

import numpy as np
import torch

from finitedifference_tpu.utils import timers as jtimers
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.utils import profiling, timers
from tests.test_ecsw import setup_problem

to_torch = functools.partial(convert.to_torch, device="cpu")


def test_timer_measures_the_block():
    with timers.Timer() as t:
        x = t.sync(torch.ones(1000).cumsum(0))
        time.sleep(0.01)
    assert t.elapsed >= 0.01
    assert float(x[-1]) == 1000.0
    with timers.Timer() as t2:   # nothing registered: still times
        pass
    assert 0.0 <= t2.elapsed < t.elapsed


def test_phase_breakdown_keys_and_times():
    """The JAX package's keys, each a positive time per call, on the
    device of the basis (here the CPU), plain and weighted."""
    jg, _, _, w0, basis, s1 = setup_problem(nx=10, ny=10, num_steps=4, k=5)
    grid = Grid2D(nx=10, ny=10, x_up=100.0, y_up=100.0)
    args = (s1[:, 2], s1[:, 1], 4.25, 0.0225, 0.05)
    want = jtimers.phase_breakdown(jg, basis, *args, reps=2)
    for weights in (None, np.linspace(0.5, 2.0, grid.state_dim)):
        got = timers.phase_breakdown(grid, to_torch(basis),
                                     *(to_torch(a) for a in args[:2]),
                                     *args[2:], weights=weights, reps=2)
        assert set(got) == set(want) == {"res_time", "jac_time", "ls_time"}
        assert all(np.isfinite(v) and v > 0 for v in got.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "traces"
    with profiling.trace(str(log_dir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())

