"""fom.enqueue_ms_per_newton_it: host milliseconds inside the program's
fom.trajectory spans that no fom.sync span (the stop decision's
read-back) covers, over the Newton updates: what the host spends issuing
an update, in a pass with spans on and no profiler."""

from gpubench import spans as sp


def read(run):
    spans = getattr(run, "spans", None)
    its = run.total("newton_its")
    if not spans or not its:
        return None
    ms = sp.uncovered_ms(spans, "fom.trajectory", "fom.sync")
    return None if ms is None else ms / its
