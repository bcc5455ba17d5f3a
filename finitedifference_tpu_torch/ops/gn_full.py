"""Full-grid LSPG Gauss-Newton system: layout, plain version, dispatch.

Counterpart of finitedifference_tpu/ops/pallas_gn_full.py. On the full
grid the upwind stencil's neighbours are regular shifts, so one pass over
the padded basis halves (Vu, Vv) per Gauss-Newton iteration gives the
state scalars V y, the Crank-Nicolson residual, the J V rows and the
(k+1, k+1) Gram extension

    gext = [J V | r]^T [J V | r]:  gext[:k, :k] the Gram,
           gext[:k, k] = (J V)^T r, gext[k, k] = ||r||^2,

without forming J V in a separate GEMM chain.

Layout (the JAX package's, so convert.py carries the padded arrays
across unchanged): grid rows are padded from nx to nx_pad = round_up(nx +
1, 8) with DEAD cells carrying zero basis rows, ny to a multiple of
tile_rows, and the mode axis to kp = round_up(k + 1, 128) with the
residual in lane k. A dead row tail doubles as the west zero ghost of
the next row's inflow column. Dead cells still see a real west or south
neighbour, so their assembled rows are masked out by the full-length
`row_mask` (1 on real cells, 0 on the dead column tail AND the dead
bottom rows: unmasked, the bottom rows put +14% into ||r||^2 at 250^2).

`gn_full_first` / `gn_full_system` run the kernel of csrc/gn_full.cu
(ops/cuda_gn_full.py) on CUDA tensors and the plain PyTorch version
`gn_full_ref` on CPU tensors; any other device raises. Both compute
per-tile partial Grams in the working dtype and reduce them in float64.
Each system they build counts one `rom.gn_full_systems` while a recording
is on (utils/profiling): on the card, one launch of the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.ops.cuda_gn_full import gn_full_cuda
from finitedifference_tpu_torch.utils import profiling

KP = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def full_layout(grid, tile_rows: int = 4):
    """(nx_pad, ny_pad, tile) of the dead-cell-padded row layout."""
    nx_pad = _round_up(grid.nx + 1, 8)   # >= nx+1: a real west ghost
    ny_pad = _round_up(grid.ny, tile_rows)
    return nx_pad, ny_pad, tile_rows * nx_pad


def pad_field_full(f2d, grid, tile_rows: int = 4, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """(ny, nx) field -> flat (ny_pad * nx_pad,) with zero dead cells."""
    nx_pad, ny_pad, _ = full_layout(grid, tile_rows)
    f2d = as_tensor(f2d, device)
    device = f2d.device if device is None else device
    out = torch.zeros((ny_pad, nx_pad), dtype=dtype, device=device)
    out[: grid.ny, : grid.nx] = f2d.to(device=device, dtype=dtype)
    return out.reshape(-1)


def pad_basis_full(basis, grid, tile_rows: int | None = None,
                   dtype=torch.float32):
    """Split + pad a (2n, k) basis for the full-grid system.

    Returns (vu_p, vv_p, tile_rows): (ny_pad * nx_pad, kp) halves in
    `dtype` (float32 as in the JAX package, or float64) on the basis's
    device, in the dead-cell row layout, with k+1 padded to a multiple of
    128 lanes.
    """
    basis = as_tensor(basis)
    n = grid.n_cells
    k = basis.shape[1]
    if tile_rows is None:
        tile_rows = 4
    nx_pad, ny_pad, _ = full_layout(grid, tile_rows)
    kp = _round_up(k + 1, KP)

    def padded(half):
        out = torch.zeros((ny_pad, nx_pad, kp), dtype=dtype,
                          device=basis.device)
        out[: grid.ny, : grid.nx, :k] = half.reshape(grid.ny, grid.nx,
                                                     k).to(dtype)
        return out.reshape(ny_pad * nx_pad, kp)

    return padded(basis[:n]), padded(basis[n:]), tile_rows


def row_mask(grid, tile_rows: int = 4, dtype=torch.float32,
             device=None) -> torch.Tensor:
    """(n_pad, 1) mask: 1 at real cells, 0 at the dead column tail AND
    the dead bottom rows (ny..ny_pad-1), whose real south neighbour would
    otherwise leak flux into the Gram."""
    nx_pad, ny_pad, _ = full_layout(grid, tile_rows)
    m = np.zeros((ny_pad, nx_pad, 1), np.float64)
    m[: grid.ny, : grid.nx] = 1.0
    return torch.as_tensor(m.reshape(ny_pad * nx_pad, 1), dtype=dtype,
                           device=device)


def _reduce_gram(partials: torch.Tensor) -> torch.Tensor:
    """float64 sum of the per-tile partial Grams (n_tiles, kp, kp).
    Summing them in f32 doubled the trajectory error in the JAX package."""
    return partials.to(torch.float64).sum(dim=0)


def _pad_y(y, kp, dtype):
    y_pad = torch.zeros(kp, dtype=dtype, device=y.device)
    y_pad[: y.shape[0]] = y.to(dtype)
    return y_pad


def gn_full_ref(vu_p, vv_p, y, aux, dmask, k: int, nxp: int, tile: int,
                hdx: float, hdy: float, first: bool):
    """Plain PyTorch version of the full-grid system kernel (B3).

    first=True: aux is the padded source + inflow term slbc (n_pad[, 1]);
    derives the step constant cp (n_pad, 2) from y's scalars, masked by
    dmask, and returns (gext, cp). first=False: aux is cp; returns
    (gext, None). gext is (kp, kp) float64: per-`tile` partial Grams in
    the working dtype, summed in float64.
    """
    dtype = vu_p.dtype
    n_pad, kp = vu_p.shape
    y_pad = _pad_y(y, kp, dtype)
    u_s = vu_p @ y_pad
    v_s = vv_p @ y_pad
    dm = dmask.reshape(-1).to(dtype)

    def west(f):       # flat i-1: the previous row's dead tail at x=0
        return torch.cat((torch.zeros_like(f[:1]), f[:-1]))

    def south(f):      # flat i-nxp: one padded grid row down
        return torch.cat((torch.zeros_like(f[:nxp]), f[:-nxp]))

    u_w, v_w, u_so, v_so = west(u_s), west(v_s), south(u_s), south(v_s)
    qdx, qdy = 0.5 * hdx, 0.5 * hdy
    fuv = u_s * v_s
    ru_f = qdx * (u_s * u_s - u_w * u_w) + qdy * (fuv - u_so * v_so)
    rv_f = qdy * (v_s * v_s - v_so * v_so) + qdx * (fuv - u_w * v_w)
    if first:
        slbc = aux.reshape(-1).to(dtype)
        cp_u = (-u_s + ru_f - slbc) * dm
        cp_v = (-v_s + rv_f) * dm
        cp = torch.stack((cp_u, cp_v), dim=1)
    else:
        cp_u, cp_v = aux[:, 0].to(dtype), aux[:, 1].to(dtype)
        cp = None
    ru = u_s + ru_f + cp_u
    rv = v_s + rv_f + cp_v

    def col(c):
        return c[:, None]

    ju = col(1.0 + hdx * u_s + qdy * v_s) * vu_p \
        + col(-hdx * u_w) * west(vu_p) + col(-qdy * v_so) * south(vu_p) \
        + col(qdy * u_s) * vv_p + col(-qdy * u_so) * south(vv_p)
    jv = col(qdx * v_s) * vu_p + col(-qdx * v_w) * west(vu_p) \
        + col(1.0 + hdy * v_s + qdx * u_s) * vv_p \
        + col(-qdx * u_w) * west(vv_p) + col(-hdy * v_so) * south(vv_p)
    lane = torch.arange(kp, device=vu_p.device)
    au = torch.where(lane == k, col(ru), ju) * col(dm)
    av = torch.where(lane == k, col(rv), jv) * col(dm)
    au = au.reshape(n_pad // tile, tile, kp)
    av = av.reshape(n_pad // tile, tile, kp)
    partials = au.mT @ au + av.mT @ av
    return _reduce_gram(partials), cp


def _check_device(x):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the Gauss-Newton systems run on CUDA (kernel) "
                         f"or CPU (plain) tensors, got {x.device}")


def _system(vu_p, vv_p, y, aux, dmask, k, nxp, tile, hdx, hdy, first):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    _check_device(vu_p)
    if vu_p.is_cuda:
        out = gn_full_cuda(vu_p, vv_p, y, aux, dmask, k, nxp, hdx, hdy,
                           first=first)
    else:
        out = gn_full_ref(vu_p, vv_p, y, aux, dmask, k, nxp, tile, hdx, hdy,
                          first=first)
    profiling.count("rom.gn_full_systems")
    return out


def gn_full_first(vu_p, vv_p, y, slbc_p, dmask, k: int, nxp: int,
                  tile: int, hdx: float, hdy: float):
    """First GN iteration of a time step: the system at the incoming
    state and the step constant. Returns (gext (kp, kp) float64,
    cp (n_pad, 2)). `tile` sets the plain version's partial-Gram tiles;
    the kernel picks its own."""
    return _system(vu_p, vv_p, y, slbc_p, dmask, k, nxp, tile, hdx, hdy,
                   first=True)


def gn_full_system(vu_p, vv_p, y, cp, dmask, k: int, nxp: int, tile: int,
                   hdx: float, hdy: float):
    """A later GN iteration: the system at y with the step's cp.
    Returns gext (kp, kp) float64."""
    return _system(vu_p, vv_p, y, cp, dmask, k, nxp, tile, hdx, hdy,
                   first=False)[0]
