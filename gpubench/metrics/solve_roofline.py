"""solve_roofline: the least time of the Newton solves' work over the
device time of the kernels that kernels.json assigns to "solve", in %.

The work of one solve is counted from the shapes (roofline.
wavefront_solve): u, v, ru, rv read once and du, dv written once in the
Newton state's dtype, the same count for the exact and the segmented
solve, for whatever later replaces them, and whatever precision the
program solves in; one solve per Newton update."""

from gpubench import roofline


def read(run):
    its = run.total("newton_its")
    if run.trace is None or not its or "nx" not in run.info:
        return None
    busy = run.trace.seconds_matching(run.kernel_map.get("solve", []))
    if busy <= 0:
        return None
    nbytes, ops = roofline.wavefront_solve(run.info["nx"], run.info["ny"],
                                           run.info["state_dtype"])
    t, _ = roofline.least_time(nbytes, ops, run.info["state_dtype"])
    return 100.0 * its * t / busy
