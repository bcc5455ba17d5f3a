"""The multi-rank paths (parallel/mesh, parallel/spatial, the sweeps'
`mesh=`, sharded_factored_hprom, factored_hprom's `group`,
entry.dryrun_multichip, run_fom --spatial-shard) against the JAX package
on the CPU.

The port's ranks are gloo processes on the CPU (parallel/mesh.spawn): one
spawn of 4 ranks runs every case (tests/torch_parallel_ranks.py), in
float64, the 2-rank cases over an axis of size 2 of a 2 x 2 mesh. Each
case goes through JAX's sharded function on a Mesh of as many of the
conftest's virtual CPU devices as the port has ranks, on inputs made
from a seed with numpy.
The tolerances are tests/test_parallel.py's: the residual atol 1e-13,
the block-Jacobi step rtol 1e-10, the skewed trajectory rtol 1e-12 with
equal Newton counts, the sample-sharded HPROM rtol 1e-9 with equal
Gauss-Newton counts (and against lspg_prom with unit weights on every
cell), the sweeps rtol 1e-12 (FOM) and 1e-11 (ROMs; the factored engine
against JAX's factored engine). Every spawn has its own timeout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import oracle
import torch_parallel_ranks as ranks
from finitedifference_tpu.closures.common import (
    manifold_decoder as jmanifold_decoder,
)
from finitedifference_tpu.ecsw import (
    compute_ecsw_weights,
    ecsw_training_matrix,
)
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import stencil as jst
from finitedifference_tpu.parallel import spatial as jsp
from finitedifference_tpu.parallel import sweep as jsw
from finitedifference_tpu.pod import pod
from finitedifference_tpu.rom import lspg_prom as jlspg
from finitedifference_tpu.rom import prepare_hprom as jprepare
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.entry import dryrun_multichip
from finitedifference_tpu_torch.fom import inviscid_burgers_implicit2d_skewed
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.parallel import mesh as pmesh
from finitedifference_tpu_torch.parallel import sweep as tsw
from finitedifference_tpu_torch.rom import prepare_hprom as tprepare
from finitedifference_tpu_torch.runners import run_fom

to_torch = functools.partial(convert.to_torch, device="cpu")

DT = 0.05
TIMEOUT = 300.0      # seconds a spawn may take before it fails


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one torch thread here (the ranks get one each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jgrid(nx, ny):
    return JGrid2D(nx=nx, ny=ny, x_up=100.0, y_up=100.0)


def jmesh(n, names=("sp",)):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} virtual devices")
    return JMesh(np.asarray(devs[:n]).reshape(
        (n,) if len(names) == 1 else (2, n // 2)), names)


@pytest.fixture(scope="module")
def cases():
    """The inputs of every case, numpy arrays from seeds and the oracle."""
    rng = np.random.default_rng(0)
    residual = {k: 1 + rng.uniform(size=(16, 12))
                for k in ("u", "v", "up", "vp")}

    jg = jgrid(10, 8)
    ops, xc = oracle.make_problem(nx=10, ny=8)
    w0 = np.ones(jg.state_dim)
    s = oracle.implicit_trajectory(w0, [4.25, 0.0225], DT, 15, ops, xc)
    basis = np.asarray(pod(s, num_modes=6, method="svd")[0])
    c = np.asarray(ecsw_training_matrix(
        jg, jnp.asarray(s[:, 1:15:3]), jnp.asarray(s[:, 0:14:3]),
        jnp.asarray(basis), 4.25, 0.0225, DT))
    weights = compute_ecsw_weights(c, jg, bc_w=5.0, method="nnls",
                                   rel_err_thresh=1e-4)
    mus, _ = jsw.pad_to_multiple(np.array([[4.5, 0.02], [5.0, 0.028],
                                           [5.19, 0.026]]), 4)
    hprom = dict(basis=basis, weights=np.asarray(weights), y0=basis.T @ w0,
                 mus=mus)

    ops, xc = oracle.make_problem(nx=8, ny=8)
    w0 = np.ones(2 * 64)
    s = oracle.implicit_trajectory(w0, [4.25, 0.0225], DT, 10, ops, xc)
    sweeps = dict(
        basis=np.asarray(pod(s, num_modes=6, method="svd")[0]),
        basis5=np.asarray(pod(s, num_modes=5, method="svd")[0]),
        fom_mus=jsw.pad_to_multiple(np.array(
            [[4.25, 0.015], [5.5, 0.03], [4.75, 0.02]]), 4)[0],
        rom_mus=jsw.pad_to_multiple(np.array(
            [[4.5, 0.02], [5.0, 0.028]]), 4)[0])
    sweep_step = dict(mus=[(4.25, 0.02), (4.75, 0.025), (5.0, 0.018),
                           (5.5, 0.03)])
    return dict(residual=residual, hprom=hprom, sweeps=sweeps,
                sweep_step=sweep_step)


@pytest.fixture(scope="module")
def world4(cases):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")       # the ranks' torch threads
        return pmesh.spawn(ranks.world4, 4, cases, device="cpu",
                           timeout=TIMEOUT)


def test_collectives_on_a_2x2_mesh(world4):
    """Rank 0's view of the primitives (rank r's block is arange(6) + 10 r
    in 3 x 2; rank = 2 dp + sp): JAX's ppermute i -> i + 1 with zeros on
    the first rank, psum and the gather in rank order."""
    p = world4["primitives"]
    x = torch.arange(6, dtype=torch.float64).reshape(3, 2)
    assert p["coords"] == (0, 0)
    assert torch.equal(p["shift_rows"], torch.cat((torch.zeros(1, 2),
                                                   x[:-1])))
    assert torch.equal(p["shift_cols"], torch.cat((torch.zeros(3, 1),
                                                   x[:, :-1]), dim=1))
    assert torch.equal(p["psum"], 2 * x + 10)           # ranks 0 and 1
    assert torch.equal(p["gather"], torch.cat((x, x + 20)))   # 0 and 2


def test_sharded_residual_matches_jax(world4, cases):
    c = cases["residual"]
    jg = jgrid(12, 16)
    f = jsp.make_sharded_residual(jmesh(4), jg, DT)
    want = f(*(jnp.asarray(c[k]) for k in ("u", "v", "up", "vp")),
             jst.source_term(jg, 0.02, DT, dtype=jnp.float64),
             jst.inflow_bc_term(jg, 4.75, DT, dtype=jnp.float64))
    for got, w in zip(world4["residual"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-13)


def test_sharded_fom_step_matches_jax(world4):
    jg = jgrid(8, 16)
    up, vp = jg.split_fields(jnp.ones(jg.state_dim))
    step = jsp.sharded_fom_step(jmesh(4), jg, DT, num_sweeps=24)
    want = step(up, vp, jst.source_term(jg, 0.02, DT, dtype=jnp.float64),
                jst.inflow_bc_term(jg, 4.75, DT, dtype=jnp.float64))
    for got, w in zip(world4["fom_step"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-11)


@pytest.mark.parametrize("key,n,nx,ny,steps,mu", [
    ("skewed", 4, 24, 16, 20, (4.75, 0.02)),
    ("skewed_sp2", 2, 16, 16, 10, (5.19, 0.026)),
], ids=["4ranks_24x16", "2ranks_16x16"])
def test_sharded_skewed_matches_jax(world4, key, n, nx, ny, steps, mu):
    """The row-sharded skewed trajectory over n ranks against JAX's on n
    devices (tests/test_parallel.py holds JAX's against its unsharded
    engine)."""
    snaps, its = world4[key]
    jg = jgrid(nx, ny)
    want, jits = jsp.sharded_skewed_fom(jmesh(n), jg, jnp.ones(jg.state_dim),
                                        DT, steps, *mu)
    np.testing.assert_allclose(snaps.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)
    assert its == int(jits)
    if n == 4:
        # a Newton iteration: one exchange a diagonal (nx + ny - 1 of
        # them) and one of the state's column in the solve, one in the
        # residual; and one in each step's first residual
        assert world4["skewed_exchanges"] == \
            its * (nx + ny - 1 + 2) + steps


def test_sharded_factored_hprom_matches_jax(world4, cases):
    c = cases["hprom"]
    jg = jgrid(10, 8)
    smesh, sw, basis_aug = jprepare(jg, c["weights"], c["basis"])
    want = jsw.sharded_factored_hprom(
        jg, smesh, sw, jnp.asarray(c["y0"]), basis_aug, DT, 12, 5.0, 0.024,
        mesh=jsw.make_sweep_mesh(jax.devices()[:4], axis_name="sp"),
        ls_method="normal")
    got = world4["hprom"]
    np.testing.assert_allclose(got.red_coords.numpy(),
                               np.asarray(want.red_coords), rtol=1e-9,
                               atol=1e-11)
    assert got.total_gn_its == int(want.total_gn_its)


def test_sharded_factored_hprom_unit_weights_is_lspg(world4, cases):
    """Unit weights on every cell make the sample-sharded engine a
    row-sharded LSPG PROM: it must match JAX's lspg_prom."""
    c = cases["hprom"]
    jg = jgrid(10, 8)
    want = jlspg(jg, jnp.ones(jg.state_dim), DT, 10, 5.0, 0.024,
                 jnp.asarray(c["basis"]), ls_method="normal").red_coords
    np.testing.assert_allclose(world4["hprom_unit"].red_coords.numpy(),
                               np.asarray(want), rtol=1e-9, atol=1e-11)


def _jax_sweep(name, cases):
    jmesh_dp = jsw.make_sweep_mesh(jax.devices()[:4])
    c = cases["sweeps"]
    jg = jgrid(8, 8)
    w0 = jnp.ones(jg.state_dim)
    if name.startswith("sweep_fom"):
        engine = name.rsplit("_", 1)[1]
        kw = dict(use_pallas=False) if engine == "skewed" else {}
        return jsw.sweep_fom(jg, w0, DT, 5, c["fom_mus"], mesh=jmesh_dp,
                             engine=engine, **kw)
    if name == "sweep_lspg":
        return jsw.sweep_lspg(jg, w0, DT, 5, c["rom_mus"], c["basis"],
                              mesh=jmesh_dp)
    if name == "sweep_manifold":
        decode, dec_jac = jmanifold_decoder(c["basis5"], None, None)
        return jsw.sweep_manifold(jg, jnp.asarray(c["basis5"].T) @ w0,
                                  decode, dec_jac, DT, 6, c["rom_mus"],
                                  mesh=jmesh_dp)
    h = cases["hprom"]
    hg = jgrid(10, 8)
    smesh, sw, basis_aug = jprepare(hg, h["weights"], h["basis"])
    engine = name.rsplit("_", 1)[1]
    kw = dict(ls_method="normal") if engine == "factored" else {}
    return jsw.sweep_hprom(hg, smesh, sw, jnp.asarray(h["y0"]), basis_aug,
                           DT, 8, h["mus"], mesh=jmesh_dp, engine=engine,
                           **kw)


@pytest.mark.parametrize("name,rtol", [
    ("sweep_fom_standard", 1e-12),
    ("sweep_fom_skewed", 1e-12),
    ("sweep_lspg", 1e-11),
    ("sweep_manifold", 1e-11),
    ("sweep_hprom_generic", 1e-11),
    ("sweep_hprom_factored", 1e-11),
])
def test_sweeps_with_mesh_match_jax(world4, cases, name, rtol):
    """Each sweep over a dp = 4 mesh (every rank a block of the padded
    batch) against JAX's sweep sharded over 4 devices."""
    got = world4[name]
    want = np.asarray(_jax_sweep(name, cases))
    assert got.shape == want.shape and got.shape[0] == 4
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * 1e-1)


def test_sweep_pallas_traj_with_mesh_matches_one_launch(world4, cases):
    """The whole-trajectory engine over dp = 4 (each rank one call of its
    block) against the port's unsharded sweep, which
    tests/test_torch_sweep.py holds against JAX's Pallas kernel: the
    plain version's trajectories do not depend on the batch."""
    h = cases["hprom"]
    tg = Grid2D(nx=10, ny=8)
    smesh, sw, basis_aug = tprepare(tg, h["weights"], to_torch(h["basis"]))
    want = tsw.sweep_hprom(tg, smesh, sw.float(),
                           to_torch(h["y0"]).float(), basis_aug.float(), DT,
                           8, h["mus"], engine="pallas_traj", unroll_its=3)
    got = world4["sweep_hprom_pallas_traj"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_sharded_sweep_fom_step_matches_jax(world4, cases):
    """The (dp, sp) = (2, 2) batched step against JAX's on a 2 x 2 mesh."""
    jg = jgrid(8, 16)
    mus = cases["sweep_step"]["mus"]
    src = jnp.stack([jst.source_term(jg, m2, DT, dtype=jnp.float64)
                     for _, m2 in mus])
    lbc = jnp.stack([jst.inflow_bc_term(jg, m1, DT, dtype=jnp.float64)
                     for m1, _ in mus])
    ones = jnp.ones((len(mus), jg.ny, jg.nx))
    step = jsp.sharded_sweep_fom_step(jmesh(4, ("dp", "sp")), jg, DT,
                                      num_sweeps=16, max_its=20)
    want = step(ones, ones, src, lbc)
    for got, w in zip(world4["sweep_step"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-11)


def test_factored_hprom_group_of_one_is_group_none(world4):
    """A real process group of one rank sums nothing: bit for bit the
    trajectory of group=None, whose code path is the unsharded engine's."""
    a, b = world4["group_none"], world4["group_one"]
    assert torch.equal(a.red_coords, b.red_coords)
    assert a.total_gn_its == b.total_gn_its


def test_dryrun_multichip_on_eight_cpu_ranks(monkeypatch):
    """entry.dryrun_multichip(8): dp 4 x sp 2, every phase against its
    unsharded twin (it raises on a mismatch)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = dryrun_multichip(8, device="cpu", timeout=TIMEOUT)
    assert (out["dp"], out["sp"]) == (4, 2)
    assert out["skewed_its"] > 0 and out["hprom_gn_its"] > 0
    assert np.isfinite(out["train_loss"])


def test_run_fom_spatial_shard_on_cpu_ranks(tmp_path, monkeypatch):
    """run_fom --spatial-shard 2 --device cpu at 12^2: rank 0 saves the
    snapshots, equal to the unsharded skewed engine's."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run_fom.main(num_cells=12, num_steps=8, device="cpu", spatial_shard=2)
    saved = list(tmp_path.glob("param_snaps_12x12/*.npy"))
    assert len(saved) == 1
    g = Grid2D(nx=12, ny=12)
    want = inviscid_burgers_implicit2d_skewed(
        g, torch.ones(g.state_dim, dtype=torch.float64), 0.05, 8, 4.75,
        0.02)
    np.testing.assert_allclose(np.load(saved[0]), want.snaps.numpy(),
                               rtol=1e-12, atol=1e-13)


def test_more_cuda_ranks_than_cards_raise(monkeypatch):
    """NCCL puts a rank on a card: asking for more CUDA ranks than cards
    raises at once, in spawn and in run_fom; nothing runs fewer ranks,
    another backend or the CPU."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="gloo"):
        pmesh.spawn(ranks.hang, n, device="cuda")
    with pytest.raises(SystemExit, match="--device cpu"):
        run_fom.main(num_cells=12, num_steps=2, device="cuda",
                     spatial_shard=n)
    with pytest.raises(ValueError, match="gloo"):
        pmesh.spawn(ranks.hang, 2, device="cpu", backend="nccl")


def test_spawn_raises_for_a_failed_rank_and_a_hang():
    """A rank that raises fails the spawn with its traceback; a rank that
    never ends fails it at the timeout; every rank is killed."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 .*ZeroDivisionError"):
        pmesh.spawn(ranks.fail_on_rank_one, 2, device="cpu",
                    timeout=TIMEOUT)
    with pytest.raises(TimeoutError):
        pmesh.spawn(ranks.hang, 2, device="cpu", timeout=3.0)


def test_run_sweep_sharded_path_on_cpu_ranks(tmp_path, monkeypatch):
    """run_sweep's sharded path (one rank a card where there are more
    cards than one) on 2 gloo CPU ranks: the padded 3 x 1 grid in blocks,
    gathered equal to the unsharded sweep."""
    from finitedifference_tpu_torch.runners import run_sweep
    from finitedifference_tpu_torch.runners.common import default_config

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = default_config(12, 6)
    mus, n_real = tsw.pad_to_multiple(
        np.array([[4.25, 0.015], [4.875, 0.0225], [5.5, 0.03]]), 2)
    args = (mus, n_real, "fom", 6, cfg, False, "skewed")
    _, got = run_sweep._run_sharded(2, *args, device="cpu", timeout=TIMEOUT)
    _, want = run_sweep._sweep(*args, torch.device("cpu"), report=False)
    assert got.shape == (4, 2 * 144, 7)
    assert torch.equal(got, want)
