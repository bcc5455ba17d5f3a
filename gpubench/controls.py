#!/usr/bin/env python3
"""Readings of a cell's compared numbers, for the program and for the
controls that have to fail the check, at the cell's own size:

    python3 gpubench/controls.py --workload NAME --seeds 11,12,13 \
        [--kinds program,program_f32,reference_f32] [--out FILE]

For each seed, the request that the seed's traffic draws for the check
is served by each kind in the program's place and compared with the plain
reference as a run's check compares it. Kinds: `program` (the timed
path), `program_f32` (the program with its own float32 path switched on),
`reference_f32` (the plain reference computed in float32), and for the
FOM cells `program_f32_solves` (float32 solves under a float64 state).
One JSON line per reading on standard output (and appended to FILE). The
traffic files' limits are set from these readings (PERF.md); the
benchmark's runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from gpubench import traffic as traffic_gen  # noqa: E402
from gpubench.harness import ROOT, Bench, open_cell  # noqa: E402


def readings(spec, cell_name, seeds, kinds, *, bench=None, device="cuda"):
    """Yields {"seed", "kind", "request", numbers...} for each seed and
    kind."""
    _, driver, ctx = open_cell(spec, cell_name, bench or Bench(), device)
    cfg, traffic = ctx.cfg, ctx.traffic
    state = driver.setup(ctx)
    for seed in seeds:
        first = traffic_gen.check_sample(traffic, seed)[0]
        gen = traffic_gen.requests(cfg, traffic, seed)
        for _ in range(first):
            next(gen)
        request = next(gen)
        for kind in kinds:
            t0 = time.perf_counter()
            if kind == "program":
                rec, answer = driver.serve(state, request)
            else:
                rec, answer = driver.serve_control(ctx, state, request,
                                                   kind)
            t1 = time.perf_counter()
            numbers = driver.compare(ctx, request, rec, answer)
            out = {"cell": cell_name, "seed": seed, "kind": kind,
                   "request": request, **numbers,
                   "serve_s": t1 - t0,
                   "compare_s": time.perf_counter() - t1}
            yield out
            del answer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--kinds", default="program,program_f32,reference_f32")
    p.add_argument("--out")
    a = p.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    seeds = [int(s) for s in a.seeds.split(",")]
    for r in readings(spec, a.workload, seeds, a.kinds.split(",")):
        line = json.dumps(r)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
