"""device.idle_pct.fom: the share of a FOM cell's traced requests in which
no kernel, copy or fill ran on the device, in %: 1 - (the union of the
device's activity intervals in the device-only trace) / (the seconds of
the same requests run untraced just before, in the same process)."""


def read(run):
    if run.trace is None or run.total("newton_its") is None \
            or run.trace.busy_s <= 0:
        return None
    return run.trace.idle_pct
