"""The benchmark harness: one run of one cell.

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

A cell of BENCHMARK.json names a configuration and a traffic mix. The
harness finds everything by name, in the directories of `Bench.search`:

    configs/<config>.json     the deployment: sizes, dtypes, guarantees
    workloads/<traffic>.json  the traffic mix, read by traffic.py; its
                              `driver` names the adapter to the program
    drivers/<driver>.py       setup, serve one request, release, check
    metrics/<metric>.py       read(run) -> a number, or None where the
                              run holds nothing to read

A run: set-up (imports, the program's build and inputs, a warm-up), then
requests in a closed loop for `--seconds` (with `--trace 1`, the
traffic's `trace_requests` requests untraced, then the same requests
under torch.profiler recording the device alone, then one more with the
host's operators too, whose trace only names the idle gaps), then the
device's memory peak, the program's state freed, the check of a sample
of the answers against the plain reference, and one JSON line on
standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time

from gpubench import traffic as traffic_gen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "finitedifference_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """Finds configurations, traffic mixes, drivers and metric readers by
    name: the first of `search` that holds the file wins. Caches go under
    the first directory."""

    def __init__(self, search=(HERE,)):
        self.search = [os.path.abspath(p) for p in search]

    def path(self, kind: str, name: str, ext: str) -> str:
        for root in self.search:
            p = os.path.join(root, kind, name + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under "
                                f"{self.search}")

    def json(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name, ".json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        return load_module(self.path(kind, name, ".py"),
                           f"gpubench_{kind}_{name}".replace(".", "_"))

    def kernel_map(self) -> dict:
        for root in self.search:
            p = os.path.join(root, "kernels.json")
            if os.path.exists(p):
                with open(p) as f:
                    return json.load(f)
        return {}

    @property
    def cache_root(self) -> str:
        return self.search[0]


class Context:
    """What a driver sees: its configuration (and the file it came from,
    which names the offline model's cache), the traffic, the device and
    where to cache. A driver adds to `inputs_s` the seconds its set-up
    spends making or loading the benchmark's own inputs."""

    def __init__(self, bench, cfg, cfg_path, traffic, device):
        self.bench, self.cfg, self.cfg_path = bench, cfg, cfg_path
        self.traffic, self.device = traffic, device
        self.inputs_s = 0.0


class Run:
    """What a metric reader sees."""

    def __init__(self, info, records, setup_s, window_s, trace,
                 kernel_map):
        self.info, self.records = info, records
        self.setup_s, self.window_s = setup_s, window_s
        self.trace, self.kernel_map = trace, kernel_map

    def total(self, key: str):
        """Sum of a counter over the measured requests, None where no
        request carries it."""
        vals = [r[key] for r in self.records if key in r]
        return sum(vals) if vals else None


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics of `spec` that `cell` reports in a run of this kind."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def open_cell(spec: dict, cell_name: str, bench: Bench, device):
    """(cell, driver, context) of a cell of `spec`, found by name."""
    cell = next(w for w in spec["workloads"] if w["name"] == cell_name)
    traffic = bench.json("workloads", cell["traffic"])
    ctx = Context(bench, bench.json("configs", cell["config"]),
                  bench.path("configs", cell["config"], ".json"), traffic,
                  device)
    return cell, bench.module("drivers", traffic["driver"]), ctx


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, *, bench: Bench | None = None, device="cuda",
             t_start: float | None = None, patch=None):
    """Runs one cell once. Returns (result dict, checks): checks a list of
    (name, value, limit). `patch(driver)` may replace a driver's functions
    (the tests plant faults through it)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or Bench()
    cell, driver, ctx = open_cell(spec, cell_name, bench, device)
    cfg, traffic = ctx.cfg, ctx.traffic
    if patch is not None:
        patch(driver)
    state = driver.setup(ctx)
    _sync(device)
    # the benchmark's own inputs (an offline model) are no set-up of the
    # program: their seconds are reported apart
    setup_s = time.perf_counter() - t_start - ctx.inputs_s
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    gen = traffic_gen.requests(cfg, traffic, seed)
    sample = traffic_gen.check_sample(traffic, seed)
    if trace:
        n_trace = int(traffic["trace_requests"])
        sample = sorted({min(i, n_trace - 1) for i in sample})
    records, kept, served, bad = [], {}, [], []

    def serve_one(req=None):
        req = next(gen) if req is None else req
        t = time.perf_counter()
        rec, payload = driver.serve(state, req)
        rec["seconds"] = time.perf_counter() - t
        i = len(served)
        served.append((req, rec))
        if i in sample:
            kept[i] = payload
        return rec

    tstats = None
    _sync(device)
    if trace:
        from gpubench.trace import Traced

        reqs = [next(gen) for _ in range(n_trace)]
        # the same requests untraced first: the profiler's own cost on the
        # host would read as idle, so the device's busy time is read
        # against these seconds
        t0 = time.perf_counter()
        bad = [driver.serve(state, req)[0].get("failed") for req in reqs]
        _sync(device)
        untraced_s = time.perf_counter() - t0
        with Traced() as tr:
            for req in reqs:
                records.append(serve_one(req))
        window_s = tr.window_s
        tstats = tr.stats()
        tstats.untraced_s = untraced_s
        # the next request under the host's profiler too, to name the gaps
        with Traced(host=True) as named:
            serve_one()
        tstats.gaps = named.stats().gaps
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            records.append(serve_one())
        _sync(device)
        window_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        mem_peak = max(torch.cuda.max_memory_allocated(i)
                       for i in range(torch.cuda.device_count()))
    else:
        mem_peak = 0
    # answers drawn for the check that the window did not reach: waited
    # for after it, outside every metric
    while len(served) <= max(sample):
        serve_one()
    _sync(device)

    info = driver.release(state)
    del state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    checks = driver.check(ctx, [(served[i][0], served[i][1], kept[i])
                                for i in sample])
    failed = sum(bool(r.get("failed")) for r in records)
    correct = not any(bad) and not any(
        r.get("failed") for _, r in served) and all(
        isinstance(v, float) and math.isfinite(v) and v <= lim
        for _, v, lim in checks)

    run = Run(info, records, setup_s, window_s, tstats,
              bench.kernel_map())
    metrics = {}
    for m in cell_metrics(spec, cell_name, trace):
        value = bench.module("metrics", m["name"]).read(run)
        if value is None:
            print(f"metric {m['name']}: nothing to read in this run",
                  file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = torch.device(device)
    if dev.type == "cuda":
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": int(cell.get("chips", 1)),
                       "memory_peak_bytes": int(mem_peak)}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": 0}
    result = {"request_seconds": [r["seconds"] for r in records],
              "correct": bool(correct), "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": device_info}
    if tstats is not None:
        device_info["busy_s"] = tstats.busy_s
        device_info["window_s"] = tstats.window_s
        result["breakdown"] = tstats.breakdown()
    result["inputs_s"] = ctx.inputs_s
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result, checks


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not readable"


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = next((w for w in spec["workloads"] if w["name"] == a.workload),
                None)
    if cell is None:
        print(f"no workload {a.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    chips = int(cell.get("chips", 1))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"this cell needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result, checks = run_cell(spec, a.workload, a.seed, a.seconds,
                              bool(a.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              f"may load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"inputs made or loaded, outside setup_s: "
          f"{result['inputs_s']:.3f} s", file=sys.stderr)
    print("request seconds: " + " ".join(
        f"{s:.4f}" for s in result.pop("request_seconds")), file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
