"""fom.kernels_per_newton_it: device kernels in the traced window (copies
and fills not counted) over the program's Newton updates there."""


def read(run):
    its = run.total("newton_its")
    if run.trace is None or not its or not run.trace.kernel_count:
        return None
    return run.trace.kernel_count / its
