"""The yardstick of the rooflines: the card's peaks and the work that a
call needs, counted from its shapes.

Peaks of one NVIDIA H100 SXM 80GB (NVIDIA's data sheet, dense, at the
full power limit of 700 W; a card set below it runs slower under load,
so each run prints the limit it found): HBM 3.35 TB/s, float32 outside
the tensor cores 67 TFLOP/s, float64 outside the tensor cores 34 TFLOP/s.

Work is what these inputs need, never what a kernel happens to read
again: each input byte read once and each output byte written once, and
the operations of the iterations that the inputs took. The least time of
a call is the larger of its bytes over the memory rate and its operations
over the rate of its type.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_CARD = "NVIDIA H100 SXM 80GB, 700 W"
ITEM_BYTES = {"float32": 4, "float64": 8}

# operations of one cell of the wavefront substitution: the 2x2 block and
# its determinant (18), the reciprocal (1), the two right-hand sides (18)
# and the solve (8)
WAVEFRONT_OPS = 45


def least_time(nbytes: float, ops: float, dtype: str):
    """(seconds, "bytes" or "operations"): the least time of the work."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def wavefront_solve(nx: int, ny: int, dtype: str):
    """(bytes, operations) of one solve of the implicit FOM's Jacobian
    system: u, v, ru, rv read and du, dv written, once each, over the
    nx * ny cells, whatever the algorithm (exact or segmented)."""
    cells = nx * ny
    return 6 * cells * ITEM_BYTES[dtype], WAVEFRONT_OPS * cells


def gram_ops(rows: int, k: int) -> int:
    """Operations of the symmetric Gram of `rows` rows over k + 1 lanes."""
    return rows * (k + 1) * (k + 2)


def hprom_trajectories(weighted_cells: int, k: int, steps: int, batch: int,
                       its: int, evals: int, cg_iters: int, dtype: str):
    """(bytes, operations) of `batch` whole HPROM trajectories of `steps`
    steps on one sampled mesh: the six basis blocks, the weights and each
    point's source read once, the reduced coordinates written once; per
    system built (`evals`) the scalars, the weighted rows and their Gram
    over the weighted cells' u and v rows, per update (`its`) a CG of
    `cg_iters` steps, and per step the scalars of the step constant."""
    n = weighted_cells
    nbytes = (6 * n * k + n + batch * n + batch * k
              + batch * steps * k) * ITEM_BYTES[dtype]
    scalars = 12 * n * k
    per_eval = scalars + 18 * n * k + gram_ops(2 * n, k)
    cg = cg_iters * (2 * k * k + 10 * k)
    return nbytes, evals * per_eval + its * cg + batch * steps * scalars


def hprom_evals_needed(its: int, steps: int, batch: int,
                       unroll_its: int) -> int:
    """The fewest Gauss-Newton systems that `its` updates over `batch` x
    `steps` steps need: every update needs its system, and a step that
    stops below `unroll_its` updates needs one more to see that it stops.
    At most its / unroll_its steps take every update, so at least the
    rest stop early."""
    point_steps = batch * steps
    return its + max(0, point_steps - its // unroll_its)
