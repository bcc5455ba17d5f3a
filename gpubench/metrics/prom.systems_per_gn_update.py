"""prom.systems_per_gn_update: the full-grid Gauss-Newton systems the
program built over its updates: the program's counter
rom.gn_full_systems (one a launch of the system kernel on the card) where
a pass recorded the counters, else the records' `gn_systems`
(ROMResult.gn_evals)."""


def read(run):
    counters = getattr(run, "counters", None) or {}
    systems = counters.get("rom.gn_full_systems", run.total("gn_systems"))
    its = run.total("gn_its")
    if run.total("gn_systems") is None or not systems or not its:
        return None
    return systems / its
