"""Sampled-mesh (ECSW) Gauss-Newton system: padding, plain versions,
dispatch.

Counterpart of finitedifference_tpu/ops/pallas_gn.py. One call evaluates
the whole weighted Gauss-Newton system of the factored HPROM
(rom_factored.py) from the six stencil-position basis blocks p6: the
scalars p6[p] y, the residual, the weighted rows of [J V | r] and the
Gram extension

    gext[:k, :k] the Gram, gext[:k, k] = J^T W^2 r, gext[k, k] = ||W r||^2.

Padding (the JAX package's, so convert.py carries the arrays across
unchanged): sampled cells pad to a multiple of `tile` with weight 0, the
mode axis to kp = round_up(k + 1, 128) with zero basis columns, and the
weighted residual rides in lane k.

`gn_system` / `gn_step` run the kernels of csrc/gn_sampled.cu
(ops/cuda_gn.py) on CUDA tensors and the plain PyTorch versions
`gn_system_ref` / `gn_step_ref` on CPU tensors; `trajectory_hprom` runs a
whole HPROM trajectory, batched over μ, in one launch of the kernel of
csrc/gn_traj.cu, or its plain version `trajectory_hprom_ref`. Any other
device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from finitedifference_tpu_torch.device import as_tensor
from finitedifference_tpu_torch.ops.cuda_gn import (
    TRAJ_CELLS,
    gn_step_cuda,
    gn_system_cuda,
    gn_traj_cuda,
)
from finitedifference_tpu_torch.ops.gn_full import (
    KP,
    _check_device,
    _pad_y,
    _round_up,
)
from finitedifference_tpu_torch.solvers import cg_normal


def pad_factored_inputs(p6, wgt, tile: int = 256, dtype=torch.float32):
    """Pad (6, n_s, k) blocks and (n_s,) weights for the kernels.

    Returns (p6p (6, n_p, kp), wgt_p (n_p, 1)) in `dtype` (float32 as in
    the JAX package, or float64) on the blocks' device, n_p a multiple of
    `tile`, kp = k + 1 rounded up to 128 lanes; padded cells carry weight
    0 and zero basis rows."""
    p6 = as_tensor(p6)
    _, n_s, k = p6.shape
    kp = _round_up(k + 1, KP)
    n_p = _round_up(n_s, tile)
    p6p = torch.zeros((6, n_p, kp), dtype=dtype, device=p6.device)
    p6p[:, :n_s, :k] = p6.to(dtype)
    wgt_p = torch.zeros((n_p, 1), dtype=dtype, device=p6.device)
    wgt_p[:n_s, 0] = torch.as_tensor(wgt, device=p6.device).to(dtype)
    return p6p, wgt_p


def gn_system_ref(p6p, y, cp, wgt_p, k: int, hdx: float, hdy: float,
                  tile: int = 256):
    """Plain PyTorch version of the sampled system kernel (B4): gext
    (kp, kp) in p6p's dtype, from per-`tile` partial Grams summed in
    float64."""
    dtype = p6p.dtype
    _, n_p, kp = p6p.shape
    s = (p6p.reshape(6 * n_p, kp) @ _pad_y(y, kp, dtype)).reshape(6, n_p)
    u_s, u_w, u_so, v_s, v_w, v_so = s
    qdx, qdy = 0.5 * hdx, 0.5 * hdy
    w = wgt_p.reshape(-1).to(dtype)
    fuv = u_s * v_s
    ru = u_s + qdx * (u_s * u_s - u_w * u_w) + qdy * (fuv - u_so * v_so) \
        + cp[:, 0]
    rv = v_s + qdy * (v_s * v_s - v_so * v_so) + qdx * (fuv - u_w * v_w) \
        + cp[:, 1]

    def col(c):
        return (c * w)[:, None]

    ju = col(1.0 + hdx * u_s + qdy * v_s) * p6p[0] \
        + col(-hdx * u_w) * p6p[1] + col(-qdy * v_so) * p6p[2] \
        + col(qdy * u_s) * p6p[3] + col(-qdy * u_so) * p6p[5]
    jv = col(qdx * v_s) * p6p[0] + col(-qdx * v_w) * p6p[1] \
        + col(1.0 + hdy * v_s + qdx * u_s) * p6p[3] \
        + col(-qdx * u_w) * p6p[4] + col(-hdy * v_so) * p6p[5]
    lane = torch.arange(kp, device=p6p.device)
    au = torch.where(lane == k, col(ru), ju).reshape(n_p // tile, tile, kp)
    av = torch.where(lane == k, col(rv), jv).reshape(n_p // tile, tile, kp)
    partials = au.mT @ au + av.mT @ av
    return partials.to(torch.float64).sum(dim=0).to(dtype)


def gn_step_ref(p6p, y, cp, wgt_p, k: int, hdx: float, hdy: float,
                tile: int = 256, solve_iters: int = 24):
    """Plain PyTorch version of the fused step kernel (B5): the system,
    then `solve_iters` CG steps on gext[:k, :k] dy = -gext[:k, k] (row
    and column k masked out). Returns (dy (k,), rn 0-dim)."""
    g = gn_system_ref(p6p, y, cp, wgt_p, k, hdx, hdy, tile)
    return cg_normal(g[:k, :k], -g[k, :k], solve_iters), torch.sqrt(g[k, k])


class Trajectory(NamedTuple):
    """What the whole-trajectory engine returns, per trajectory."""
    ys: torch.Tensor      # (B?, num_steps, k) reduced coords after each step
    its: torch.Tensor     # (B?,) int: Gauss-Newton updates in all
    evals: torch.Tensor   # (B?,) int: Gauss-Newton systems built


def trajectory_hprom_ref(p6p, y0, slbc_p, wgt_p, k: int, hdx: float,
                         hdy: float, num_steps: int, *, unroll_its: int = 3,
                         solve_iters: int = 24, relnorm_cutoff: float = 1e-5,
                         min_delta: float = 0.1) -> Trajectory:
    """Plain PyTorch version of the whole-trajectory kernel (B6), in p6p's
    dtype, for trajectories that share p6p and wgt_p.

    y0 (k,) or (B, k); slbc_p (n_p, 1) or (B, n_p, 1), the padded source
    plus inflow term of each trajectory. Each step takes the step
    constant and init_norm at the incoming state, then `unroll_its`
    masked Gauss-Newton iterations (stopping checks before the update:
    rn / init_norm < relnorm_cutoff, or once an update was made,
    |rn_prev - rn| / rn_prev < min_delta; iterations past the stop leave
    y unchanged, so they are skipped), each solving the reduced system by
    `solve_iters` masked CG steps. The Gram is summed in partials of
    TRAJ_CELLS cells (their u and v rows) in the working dtype, reduced in
    float64. The trajectories run one after the other, as the kernel's
    CTAs run side by side: a point's result does not depend on the batch.
    """
    if y0.dim() == 2:
        runs = [trajectory_hprom_ref(p6p, y, s, wgt_p, k, hdx, hdy,
                                     num_steps, unroll_its=unroll_its,
                                     solve_iters=solve_iters,
                                     relnorm_cutoff=relnorm_cutoff,
                                     min_delta=min_delta)
                for y, s in zip(y0, slbc_p.reshape(-1, p6p.shape[1])
                                .expand(y0.shape[0], -1))]
        return Trajectory(*(torch.stack(x) for x in zip(*runs)))
    dtype, device = p6p.dtype, p6p.device
    _, n_p, kp = p6p.shape
    y = _pad_y(y0, kp, dtype)
    slbc = slbc_p.reshape(n_p).to(dtype)
    w = wgt_p.reshape(n_p).to(dtype)
    qdx, qdy = 0.5 * hdx, 0.5 * hdy
    # whole chunks of TRAJ_CELLS cells: the padded cells have weight 0
    pad = -n_p % TRAJ_CELLS
    p6c, w_c = F.pad(p6p, (0, 0, 0, pad)), F.pad(w, (0, pad))

    ys = torch.empty((num_steps, k), dtype=dtype, device=device)
    its = evals = 0
    for t in range(num_steps):
        u_s, u_w, u_so, v_s, v_w, v_so = \
            (p6p.reshape(6 * n_p, kp) @ y).reshape(6, n_p)
        fuv = u_s * v_s
        hf_u = qdx * (u_s * u_s - u_w * u_w) + qdy * (fuv - u_so * v_so)
        hf_v = qdy * (v_s * v_s - v_so * v_so) + qdx * (fuv - u_w * v_w)
        cp = torch.stack((-u_s + hf_u - slbc, -v_s + hf_v), dim=1)
        init_norm = torch.linalg.vector_norm(
            w[:, None] * (torch.stack((u_s + hf_u, v_s + hf_v), dim=1) + cp))
        cp = F.pad(cp, (0, 0, 0, pad))
        it, rn_prev = 0, init_norm
        for _ in range(unroll_its):
            g = gn_system_ref(p6c, y, cp, w_c, k, hdx, hdy, tile=TRAJ_CELLS)
            rn = torch.sqrt(g[k, k])
            evals += 1
            stop = bool(rn / init_norm < relnorm_cutoff) or (
                it > 0 and bool(torch.abs(rn_prev - rn) / rn_prev
                                < min_delta))
            if stop:
                break
            y[:k] += cg_normal(g[:k, :k], -g[k, :k], solve_iters)
            it += 1
            rn_prev = rn
        its += it
        ys[t] = y[:k]
    return Trajectory(ys, torch.tensor(its, device=device),
                      torch.tensor(evals, device=device))


def trajectory_hprom(p6p, y0, slbc_p, wgt_p, k: int, hdx: float, hdy: float,
                     num_steps: int, *, unroll_its: int = 3,
                     solve_iters: int = 24, relnorm_cutoff: float = 1e-5,
                     min_delta: float = 0.1) -> Trajectory:
    """The whole HPROM trajectory of each μ point (trajectory_hprom_ref's
    arguments): on CUDA tensors ONE launch of the kernel of
    csrc/gn_traj.cu runs every step of every trajectory, on CPU tensors
    the plain version runs; any other device raises."""
    _check_device(p6p)
    kw = dict(unroll_its=unroll_its, solve_iters=solve_iters,
              relnorm_cutoff=relnorm_cutoff, min_delta=min_delta)
    if p6p.is_cuda:
        return Trajectory(*gn_traj_cuda(p6p, y0, slbc_p, wgt_p, k, hdx, hdy,
                                        num_steps, **kw))
    return trajectory_hprom_ref(p6p, y0, slbc_p, wgt_p, k, hdx, hdy,
                                num_steps, **kw)


def gn_system(p6p, y, cp, wgt_p, k: int, hdx: float, hdy: float, *,
              tile: int = 256):
    """One weighted Gauss-Newton system evaluation.

    p6p:  (6, n_p, kp) padded blocks (pad_factored_inputs)
    y:    (k,) reduced coords, p6p's dtype
    cp:   (n_p, 2) per-step residual constants [cp_u, cp_v]
    wgt_p:(n_p, 1) padded ECSW weights
    Returns gext (kp, kp). `tile` sets the plain version's partial-Gram
    tiles; the kernel picks its own.
    """
    _check_device(p6p)
    if p6p.is_cuda:
        return gn_system_cuda(p6p, y, cp, wgt_p, k, hdx, hdy)
    return gn_system_ref(p6p, y, cp, wgt_p, k, hdx, hdy, tile)


def gn_step(p6p, y, cp, wgt_p, k: int, hdx: float, hdy: float, *,
            tile: int = 256, solve_iters: int = 24):
    """One fused Gauss-Newton iteration: the system and its masked CG
    solve. Returns (dy (k,), rn 0-dim)."""
    _check_device(p6p)
    if p6p.is_cuda:
        return gn_step_cuda(p6p, y, cp, wgt_p, k, hdx, hdy,
                            solve_iters=solve_iters)
    return gn_step_ref(p6p, y, cp, wgt_p, k, hdx, hdy, tile, solve_iters)
