#!/usr/bin/env python3
"""Run one benchmark cell once, from the root of a checkout:

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints one JSON line as the last line of standard output (harness.py).
Set-up is timed from the start of this process.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache of a run at a fixed path in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(HERE, ".cache", sub)
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path.insert(0, ROOT)

from gpubench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
