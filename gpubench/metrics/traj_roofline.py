"""traj_roofline: the least time of the traced batches' whole-trajectory
work over the device time of the kernels that kernels.json assigns to
"traj", in %.

The work of a batch (roofline.hprom_trajectories) is counted over the
weighted cells and the live modes, at the whole card's rate, for the
batch's Gauss-Newton updates and the fewest systems those updates need
(roofline.hprom_evals_needed)."""

from gpubench import roofline


def read(run):
    info = run.info
    if run.trace is None or "weighted_cells" not in info:
        return None
    busy = run.trace.seconds_matching(run.kernel_map.get("traj", []))
    if busy <= 0:
        return None
    t = 0.0
    for r in run.records:
        evals = roofline.hprom_evals_needed(r["gn_its"], r["steps"],
                                            r["points"], info["unroll_its"])
        nbytes, ops = roofline.hprom_trajectories(
            info["weighted_cells"], info["modes"], r["steps"], r["points"],
            r["gn_its"], evals, info["solve_iters"], info["dtype"])
        t += roofline.least_time(nbytes, ops, info["dtype"])[0]
    return 100.0 * t / busy
