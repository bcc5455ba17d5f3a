"""rom_steps_per_s: reduced-model time steps completed in the window, mu
points times steps of every finished batch, over the window's seconds,
on the host's clock."""


def read(run):
    steps = run.total("rom_point_steps")
    if steps is None or run.trace is not None:
        return None
    return steps / run.window_s
