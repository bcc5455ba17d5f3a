"""prom.kernels_per_system: device kernels in the traced window (copies
and fills not counted) over the full-grid Gauss-Newton systems built
there: the system kernel and its reduction, then the eager reduced solve
(the Cholesky of the Gram, its solve, the norm) and the masked update."""


def read(run):
    systems = run.total("gn_systems")
    if run.trace is None or not systems or not run.trace.kernel_count:
        return None
    return run.trace.kernel_count / systems
