"""gn_full_roofline: the least time of the traced trajectories' full-grid
Gauss-Newton systems over the device time of the system kernel and its
float64 reduction, in %.

The work of a system is counted from the shapes (roofline_gn_full: the
live basis halves over the real cells read once, the scalars, the J V
rows and the Gram), times the systems the program built (the records'
`gn_systems`). The kernels are found by name here: the fused rows and
Gram kernel of csrc/gn_full.cu and the partial-Gram reduction of
csrc/gn_common.cuh."""

from gpubench import roofline_gn_full

PATTERNS = (r"\bfull_system_kernel\b", r"\breduce_partials_kernel\b")


def read(run):
    systems = run.total("gn_systems")
    info = run.info
    if run.trace is None or not systems or "modes" not in info:
        return None
    busy = run.trace.seconds_matching(PATTERNS)
    if busy <= 0:
        return None
    t = roofline_gn_full.least_seconds(info["nx"] * info["ny"],
                                       info["modes"], info["dtype"], systems)
    return 100.0 * t / busy
