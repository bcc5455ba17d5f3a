"""fom.residual_device_ms_per_newton_it: device milliseconds of the
kernels launched inside the program's fom.residual spans (the eager
residual, its norm and the stop expression of ops/skewed.
skewed_residual_iter), in the device-only trace, over the Newton
updates."""


def read(run):
    by_span = getattr(run, "by_span", None)
    its = run.total("newton_its")
    if by_span is None or not its or "fom.residual" not in by_span.device_s:
        return None
    return 1e3 * by_span.device_s["fom.residual"] / its
