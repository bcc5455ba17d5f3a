"""fom.newton_its_per_step: the program's Newton updates
(FOMResult.total_newton_its) over the time steps of the traced
requests."""


def read(run):
    its, steps = run.total("newton_its"), run.total("fom_steps")
    if its is None or not steps:
        return None
    return its / steps
