"""The work of the full-grid Gauss-Newton system (the kernel of
csrc/gn_full.cu), counted from its shapes, for the roofline of
roofline.py's peaks.

One system needs the two basis halves over the real cells and the k live
modes read once, and y (k), the row mask and the step's source term or
constant (three fields over the cells) read once, and the (k + 1)^2
float64 Gram extension written once; its operations are the state's
scalars (two products of the basis halves with y), the J V rows (five
products and four sums a lane in each of u and v) and the symmetric Gram
of the 2 x cells rows over k + 1 lanes (roofline.gram_ops). Padding,
dead cells and lanes past k are no work. A trajectory needs this for
every system the program built.
"""

from __future__ import annotations

from gpubench.roofline import ITEM_BYTES, gram_ops, least_time

JV_OPS = 18      # a cell and a mode: 5 products + 4 sums, for u and for v


def system(cells: int, k: int, dtype: str):
    """(bytes, operations) of one full-grid Gauss-Newton system over
    `cells` real cells and k modes in `dtype`."""
    nbytes = (2 * cells * k + k + 3 * cells) * ITEM_BYTES[dtype] \
        + (k + 1) ** 2 * ITEM_BYTES["float64"]
    ops = 4 * cells * k + JV_OPS * cells * k + gram_ops(2 * cells, k)
    return nbytes, ops


def least_seconds(cells: int, k: int, dtype: str, systems: int) -> float:
    """The least time of `systems` systems on the card."""
    return systems * least_time(*system(cells, k, dtype), dtype)[0]
