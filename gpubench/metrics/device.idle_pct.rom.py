"""device.idle_pct.rom: the share of a reduced-model cell's traced
requests in which no kernel, copy or fill ran on the device, in %, as
device.idle_pct.fom reads it."""


def read(run):
    if run.trace is None or run.total("gn_its") is None \
            or run.trace.busy_s <= 0:
        return None
    return run.trace.idle_pct
