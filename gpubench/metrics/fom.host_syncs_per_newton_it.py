"""fom.host_syncs_per_newton_it: the program's host read-backs in the
Newton loop (the counter fom.host_syncs, one a stop decision) over its
Newton updates, in a pass with the program's spans and counters on."""


def read(run):
    counters = getattr(run, "counters", None) or {}
    its = run.total("newton_its")
    if "fom.host_syncs" not in counters or not its:
        return None
    return counters["fom.host_syncs"] / its
