"""rom.gn_its_per_step: the program's Gauss-Newton updates (the `its` of
traj_hprom_batch) over mu points times steps of the traced batches."""


def read(run):
    its, steps = run.total("gn_its"), run.total("rom_point_steps")
    if its is None or not steps:
        return None
    return its / steps
