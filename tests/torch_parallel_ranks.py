"""Rank functions of tests/test_torch_parallel.py (no jax here: the ranks
are fresh processes that import only torch and the port).

world4 runs every case on one spawn of 4 gloo ranks on the CPU
(parallel/mesh.spawn) and returns rank 0's results;
the inputs are numpy arrays made from a seed in the test module.
"""

import numpy as np
import torch

from finitedifference_tpu_torch.closures.common import manifold_decoder
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops.stencil import (
    inflow_bc_term,
    source_term,
)
from finitedifference_tpu_torch.parallel import mesh as pmesh
from finitedifference_tpu_torch.parallel.mesh import make_mesh
from finitedifference_tpu_torch.parallel.spatial import (
    make_sharded_residual,
    sharded_fom_step,
    sharded_skewed_fom,
    sharded_sweep_fom_step,
)
from finitedifference_tpu_torch.parallel.sweep import (
    make_sweep_mesh,
    sharded_factored_hprom,
    sweep_fom,
    sweep_hprom,
    sweep_lspg,
    sweep_manifold,
)
from finitedifference_tpu_torch.rom import prepare_hprom
from finitedifference_tpu_torch.rom_factored import (
    factored_hprom,
    precompute_factored_blocks,
)

DT = 0.05
F64 = torch.float64
CPU = "cpu"


def grid(nx, ny):
    return Grid2D(nx=nx, ny=ny, x_up=100.0, y_up=100.0)


def t(a):
    return torch.as_tensor(np.asarray(a), device=CPU)


def stencil_terms(g, mu1, mu2):
    return (source_term(g, mu2, DT, dtype=F64, device=CPU),
            inflow_bc_term(g, mu1, DT, dtype=F64, device=CPU))


def hprom_inputs(case, g):
    smesh, sw, basis_aug = prepare_hprom(g, case["weights"],
                                         t(case["basis"]))
    return smesh, sw, basis_aug, t(case["y0"])


def world4(cases):
    """Every case on 4 ranks: the residual, the block-Jacobi step and the
    skewed trajectory over sp = 4; the sample-sharded HPROM; the sweeps
    over dp = 4; on a (dp, sp) = (2, 2) mesh the batched step and the
    skewed trajectory over sp = 2; factored_hprom's group of one rank."""
    out = {"primitives": primitives()}
    sp = make_mesh((4,), ("sp",))

    c = cases["residual"]
    g = grid(12, 16)
    f = make_sharded_residual(sp, g, DT)
    out["residual"] = f(*(t(c[k]) for k in ("u", "v", "up", "vp")),
                        *stencil_terms(g, 4.75, 0.02))

    g = grid(8, 16)
    wp = torch.ones(g.state_dim, dtype=F64)
    up, vp = g.split_fields(wp)
    step = sharded_fom_step(sp, g, DT, num_sweeps=24)
    out["fom_step"] = step(up, vp, *stencil_terms(g, 4.75, 0.02))

    g = grid(24, 16)
    before = pmesh.EXCHANGES
    out["skewed"] = sharded_skewed_fom(sp, g, torch.ones(g.state_dim,
                                                         dtype=F64),
                                       DT, 20, 4.75, 0.02)
    out["skewed_exchanges"] = pmesh.EXCHANGES - before

    c = cases["hprom"]
    g = grid(10, 8)
    smesh, sw, basis_aug, y0 = hprom_inputs(c, g)
    out["hprom"] = sharded_factored_hprom(
        g, smesh, sw, y0, basis_aug, DT, 12, 5.0, 0.024, mesh=sp,
        ls_method="normal")
    unit = dict(c, weights=np.ones(g.n_cells))
    smesh, sw, basis_aug, y0 = hprom_inputs(unit, g)
    out["hprom_unit"] = sharded_factored_hprom(
        g, smesh, sw, y0, basis_aug, DT, 10, 5.0, 0.024, mesh=sp,
        ls_method="normal")

    dp = make_sweep_mesh()
    c = cases["sweeps"]
    g = grid(8, 8)
    w0 = torch.ones(g.state_dim, dtype=F64)
    for engine in ("standard", "skewed"):
        out[f"sweep_fom_{engine}"] = sweep_fom(g, w0, DT, 5, c["fom_mus"],
                                               mesh=dp, engine=engine)
    basis = t(c["basis"])
    out["sweep_lspg"] = sweep_lspg(g, w0, DT, 5, c["rom_mus"], basis,
                                   mesh=dp)
    decode, dec_jac = manifold_decoder(t(c["basis5"]), None, None)
    out["sweep_manifold"] = sweep_manifold(
        g, t(c["basis5"]).T @ w0, decode, dec_jac, DT, 6, c["rom_mus"],
        mesh=dp)
    h = cases["hprom"]
    hg = grid(10, 8)
    smesh, sw, basis_aug, y0 = hprom_inputs(h, hg)
    for engine, kw in (("generic", {}), ("factored",
                                         dict(ls_method="normal"))):
        out[f"sweep_hprom_{engine}"] = sweep_hprom(
            hg, smesh, sw, y0, basis_aug, DT, 8, h["mus"], mesh=dp,
            engine=engine, **kw)
    out["sweep_hprom_pallas_traj"] = sweep_hprom(
        hg, smesh, sw.float(), y0.float(), basis_aug.float(), DT, 8,
        h["mus"], mesh=dp, engine="pallas_traj", unroll_its=3)

    c = cases["sweep_step"]
    g = grid(8, 16)
    dpsp = make_mesh((2, 2), ("dp", "sp"))
    terms = [stencil_terms(g, m1, m2) for m1, m2 in c["mus"]]
    ones = torch.ones((len(terms), g.ny, g.nx), dtype=F64)
    step = sharded_sweep_fom_step(dpsp, g, DT, num_sweeps=16, max_its=20)
    out["sweep_step"] = step(ones, ones,
                             torch.stack([s for s, _ in terms]),
                             torch.stack([b for _, b in terms]))

    # two-way row sharding: the sp groups of the (2, 2) mesh, each dp row
    # running the same trajectory
    g = grid(16, 16)
    out["skewed_sp2"] = sharded_skewed_fom(
        dpsp, g, torch.ones(g.state_dim, dtype=F64), DT, 10, 5.19, 0.026)

    # factored_hprom over a real process group of one rank (the sp groups
    # of a (4, 1) mesh) and with group=None
    c = cases["hprom"]
    g = grid(10, 8)
    smesh, sw, basis_aug, y0 = hprom_inputs(c, g)
    blocks = precompute_factored_blocks(smesh, basis_aug)
    ones_sp = make_mesh((4, 1), ("dp", "sp"))
    for key, group in (("group_none", None),
                       ("group_one", ones_sp.group("sp"))):
        out[key] = factored_hprom(g, smesh, sw, y0, blocks, DT, 12, 5.0,
                                  0.024, ls_method="normal", group=group)
    return out


def primitives():
    """shift_south, psum and all_gather on a (2, 2) mesh, from blocks that
    name their rank."""
    m = make_mesh((2, 2), ("dp", "sp"))
    r = pmesh.world_rank()
    x = torch.arange(6, dtype=F64).reshape(3, 2) + 10.0 * r
    return dict(
        shift_rows=pmesh.shift_south(x, m, "sp", dim=0),
        shift_cols=pmesh.shift_south(x, m, "dp", dim=1),
        psum=pmesh.psum(x, m, "sp"),
        gather=pmesh.all_gather(x, m, "dp", dim=0),
        coords=(m.rank("dp"), m.rank("sp")))


def fail_on_rank_one():
    if pmesh.world_rank() == 1:
        return 1 / 0
    return None


def hang():
    import time
    time.sleep(3600)


def card_halo_and_skewed(seed):
    """On ranks sharing card 0 over gloo: shift_south of this rank's rows
    of a seeded (8, 6) CUDA tensor, staged through the host, gathered; and
    the sharded skewed trajectory at 40 x 24, float64, 6 steps."""
    dev = pmesh.rank_device()
    n = pmesh.world_size()
    sp = make_mesh((n,), ("sp",))
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(8, 6)),
                        device=dev)
    rows = 8 // n
    block = x[pmesh.world_rank() * rows:(pmesh.world_rank() + 1) * rows]
    shifted = pmesh.all_gather(pmesh.shift_south(block, sp, "sp"), sp, "sp")
    g = grid(40, 24)
    snaps, its = sharded_skewed_fom(
        sp, g, torch.ones(g.state_dim, dtype=F64, device=dev), DT, 6, 4.75,
        0.02)
    return dict(x=x, shifted=shifted, snaps=snaps, its=its,
                device=str(snaps.device))
