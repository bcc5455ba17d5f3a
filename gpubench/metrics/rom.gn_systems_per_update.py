"""rom.gn_systems_per_update: Gauss-Newton systems the whole-trajectory
kernel built (the program's counter rom.gn_systems, B6's `evals`) over
its Gauss-Newton updates (`its`)."""


def read(run):
    counters = getattr(run, "counters", None) or {}
    its = run.total("gn_its")
    if "rom.gn_systems" not in counters or not its:
        return None
    return counters["rom.gn_systems"] / its
