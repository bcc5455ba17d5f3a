"""fom_steps_per_s: implicit FOM time steps completed in the window over
the window's seconds, on the host's clock; the window ends at the
completion of the last trajectory begun within --seconds, in a
synchronise."""


def read(run):
    steps = run.total("fom_steps")
    if steps is None or run.trace is not None:
        return None
    return steps / run.window_s
