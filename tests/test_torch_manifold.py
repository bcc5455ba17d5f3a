"""The manifold-ROM layer of the port against the JAX package, on the CPU,
float64, at 12^2 and 10 steps: rom.make_manifold_stepper / manifold_rom
(full mesh and ECSW sampled mesh), solvers.fit_reduced_coords and
ecsw.ecsw_training_matrix_closure.

Inputs: oracle (SciPy) trajectories at two training points, their
8-mode POD split 3 + 5, the projected pairs, and a global RBF closure
fitted by the JAX package and carried across (convert.global_rbf_from_jax)
or a kNN closure likewise. Tolerances: reduced coordinates, fitted
coordinates and training matrices to 1e-10 relative; Gauss-Newton
iteration counts equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu import ecsw as jecsw
from finitedifference_tpu import rom as jrom
from finitedifference_tpu import solvers as jsolvers
from finitedifference_tpu.closures import common as jcommon
from finitedifference_tpu.closures import rbf as jrbf
from finitedifference_tpu.grid import Grid2D as JGrid2D
from finitedifference_tpu.ops import sampled as jsm
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch import ecsw as tecsw
from finitedifference_tpu_torch import rom as trom
from finitedifference_tpu_torch import solvers as tsolvers
from finitedifference_tpu_torch.closures import common as tcommon
from finitedifference_tpu_torch.closures import rbf as trbf
from finitedifference_tpu_torch.ops import sampled as tsm
from tests import oracle

to_torch = functools.partial(convert.to_torch, device="cpu")
N = 12
DT = 0.05
STEPS = 10
MU = (4.75, 0.02)
MU_B = (5.19, 0.026)
N_P, N_S = 3, 5
EPS = 2.0           # the kernel matrix's condition number stays ~1e3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads only spin, and
    their load slows the tests that share the machine. One thread for the
    module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    b = np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def problem():
    jgrid = JGrid2D(nx=N, ny=N, x_up=100.0, y_up=100.0)
    ops, xc = oracle.make_problem(nx=N, ny=N)
    w0 = np.ones(jgrid.state_dim)
    snaps = np.hstack([oracle.implicit_trajectory(w0, mu, DT, 20, ops, xc)
                       for mu in ([4.25, 0.0225], [5.5, 0.015])])
    u = np.linalg.svd(snaps, full_matrices=False)[0][:, :N_P + N_S]
    u_p, u_s = u[:, :N_P], u[:, N_P:]
    q = u.T @ snaps
    q_p, q_s = q[:N_P].T, q[N_P:].T
    jglobal = jrbf.fit_global_rbf(q_p, q_s, EPS, kernel="gaussian")
    jknn = jrbf.fit_knn_rbf(q_p, q_s, EPS, 10, kernel="gaussian")
    # a sampled mesh: every third cell, positive weights from a seed
    rng = np.random.default_rng(2)
    sample_inds = np.arange(0, jgrid.n_cells, 3)
    weights = rng.uniform(0.5, 2.0, size=sample_inds.size)
    return dict(jgrid=jgrid, tgrid=convert.grid_from_jax(jgrid), w0=w0,
                snaps=snaps, u_p=u_p, u_s=u_s, jglobal=jglobal, jknn=jknn,
                sample_inds=sample_inds, weights=weights)


def _closures(p, kind):
    if kind == "global":
        return (jrbf.global_rbf_closure(p["jglobal"]),
                trbf.global_rbf_closure(convert.global_rbf_from_jax(
                    p["jglobal"], device="cpu")))
    return (jrbf.knn_rbf_closure(p["jknn"]),
            trbf.knn_rbf_closure(convert.knn_rbf_from_jax(p["jknn"],
                                                          device="cpu")))


def _run_both(p, kind, sampled, option, mu=MU):
    """manifold_rom through both packages: (jax result, torch result)."""
    jc, tc = _closures(p, kind)
    u_p, u_s = p["u_p"], p["u_s"]
    y0 = u_p.T @ p["w0"]
    if sampled:
        jmesh = jsm.build_sampled_mesh(p["jgrid"], p["sample_inds"])
        tmesh = tsm.build_sampled_mesh(p["tgrid"], p["sample_inds"],
                                       device="cpu")
        idx = np.asarray(jsm.augmented_state_indices(
            jmesh, p["jgrid"].n_cells))
        np.testing.assert_array_equal(
            tsm.augmented_state_indices(tmesh, p["tgrid"].n_cells).numpy(),
            idx)
        u_p, u_s = u_p[idx], u_s[idx]
        jkw = dict(mesh=jmesh, sample_weights=jnp.asarray(p["weights"]))
        tkw = dict(mesh=tmesh, sample_weights=to_torch(p["weights"]))
    else:
        jkw, tkw = {}, {}
    jdec, jjac = jcommon.manifold_decoder(u_p, u_s, jc)
    u_p_t, u_s_t = to_torch(u_p), to_torch(u_s)
    tdec, tjac = tcommon.manifold_decoder(u_p_t, u_s_t, tc)
    if option == "line_search":
        jkw["line_search"] = tkw["line_search"] = True
    elif option == "fused":
        jkw["decode_and_jac"] = jcommon.manifold_decoder_fused(u_p, u_s, jc)
        tkw["decode_and_jac"] = tcommon.manifold_decoder_fused(u_p_t, u_s_t,
                                                               tc)
    jres = jrom.manifold_rom(p["jgrid"], jnp.asarray(y0), jdec, jjac, DT,
                             STEPS, *mu, **jkw)
    tres = trom.manifold_rom(p["tgrid"], to_torch(y0), tdec, tjac, DT,
                             STEPS, *mu, **tkw)
    return jres, tres


@pytest.mark.parametrize("option", ["plain", "line_search", "fused"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["full", "sampled"])
def test_manifold_rom_global_matches_jax(problem, sampled, option):
    jres, tres = _run_both(problem, "global", sampled, option)
    assert tres.red_coords.shape == (N_P, STEPS + 1)
    assert tres.red_coords.dtype == torch.float64
    assert rel(tres.red_coords, jres.red_coords) <= 1e-10
    assert tres.total_gn_its == int(jres.total_gn_its) > STEPS


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["full", "sampled"])
def test_manifold_rom_knn_matches_jax(problem, sampled):
    jres, tres = _run_both(problem, "knn", sampled, "fused")
    assert rel(tres.red_coords, jres.red_coords) <= 1e-10
    assert tres.total_gn_its == int(jres.total_gn_its) > STEPS


def test_linear_closure_equals_lspg(problem):
    """closure=None is the linear decoder: manifold_rom equals the port's
    lspg_prom on the primary block (tests/test_closures.py's check), and
    the JAX manifold_rom."""
    p = problem
    u_p = p["u_p"]
    dec, jac = tcommon.manifold_decoder(to_torch(u_p), None, None)
    y0 = to_torch(u_p.T @ p["w0"])
    res = trom.manifold_rom(p["tgrid"], y0, dec, jac, DT, STEPS, *MU)
    prom = trom.lspg_prom(p["tgrid"], to_torch(p["w0"]), DT, STEPS, *MU,
                          to_torch(u_p))
    np.testing.assert_allclose(res.red_coords.numpy(),
                               prom.red_coords.numpy(), rtol=1e-10,
                               atol=1e-12)
    assert res.total_gn_its == prom.total_gn_its
    jdec, jjac = jcommon.manifold_decoder(u_p, None, None)
    jres = jrom.manifold_rom(p["jgrid"], jnp.asarray(u_p.T @ p["w0"]),
                             jdec, jjac, DT, STEPS, *MU)
    assert rel(res.red_coords, jres.red_coords) <= 1e-10
    assert res.total_gn_its == int(jres.total_gn_its)


def test_manifold_stepper_takes_mu_at_run_time(problem):
    """One stepper, two test points: each run equals manifold_rom there,
    and the JAX stepper's run at the second point."""
    p = problem
    jc, tc = _closures(p, "global")
    u_p_t, u_s_t = to_torch(p["u_p"]), to_torch(p["u_s"])
    dec, jac = tcommon.manifold_decoder(u_p_t, u_s_t, tc)
    y0 = to_torch(p["u_p"].T @ p["w0"])
    run = trom.make_manifold_stepper(p["tgrid"], dec, jac, DT, STEPS,
                                     dtype=torch.float64)
    jdec, jjac = jcommon.manifold_decoder(p["u_p"], p["u_s"], jc)
    jrun = jrom.make_manifold_stepper(p["jgrid"], jdec, jjac, DT, STEPS,
                                      dtype=jnp.float64)
    for mu in (MU, MU_B):
        red, its = run(y0, *mu)
        res = trom.manifold_rom(p["tgrid"], y0, dec, jac, DT, STEPS, *mu)
        assert torch.equal(red, res.red_coords) and its == res.total_gn_its
    jred, jits = jrun(jnp.asarray(y0.numpy()), *MU_B)
    assert rel(red, jred) <= 1e-10 and its == int(jits)


def test_fit_reduced_coords_matches_jax(problem):
    """The inner Gauss-Newton fit of the closure training matrix: from the
    projection, min ||decode(y) - snapshot|| to 1e-2 of the start's
    residual, at most 10 iterations, no stagnation stop."""
    p = problem
    jc, tc = _closures(p, "global")
    jdec, jjac = jcommon.manifold_decoder(p["u_p"], p["u_s"], jc)
    tdec, tjac = tcommon.manifold_decoder(to_torch(p["u_p"]),
                                          to_torch(p["u_s"]), tc)
    its = []
    for i in (3, 11, 20, 35):
        snap = p["snaps"][:, i]
        y_init = p["u_p"].T @ snap
        jres = jsolvers.fit_reduced_coords(jdec, jjac, jnp.asarray(y_init),
                                           jnp.asarray(snap))
        tres = tsolvers.fit_reduced_coords(tdec, tjac, to_torch(y_init),
                                           to_torch(snap))
        assert rel(tres.y, jres.y) <= 1e-10
        assert tres.num_its == int(jres.num_its)
        assert rel(tres.resnorm, jres.resnorm) <= 1e-8
        its.append(tres.num_its)
        # capped at max_its, as JAX
        capped = tsolvers.fit_reduced_coords(tdec, tjac, to_torch(y_init),
                                             to_torch(snap), max_its=1,
                                             relnorm_cutoff=1e-30)
        jcap = jsolvers.fit_reduced_coords(jdec, jjac, jnp.asarray(y_init),
                                           jnp.asarray(snap), max_its=1,
                                           relnorm_cutoff=1e-30)
        assert capped.num_its == int(jcap.num_its) == 1
    assert max(its) > 0


def test_ecsw_training_matrix_closure_matches_jax(problem):
    p = problem
    jc, tc = _closures(p, "global")
    jdec, jjac = jcommon.manifold_decoder(p["u_p"], p["u_s"], jc)
    u_p_t = to_torch(p["u_p"])
    tdec, tjac = tcommon.manifold_decoder(u_p_t, to_torch(p["u_s"]), tc)
    u_p_j = jnp.asarray(p["u_p"].T)
    snaps = p["snaps"][:, :21]

    def jfit(snap):
        return jsolvers.fit_reduced_coords(jdec, jjac, u_p_j @ snap,
                                           snap).y

    def tfit(snap):
        return tsolvers.fit_reduced_coords(tdec, tjac, u_p_t.T @ snap,
                                           snap).y

    pairs = (snaps[:, 3:20:2], snaps[:, 0:17:2])
    want = jecsw.ecsw_training_matrix_closure(
        p["jgrid"], *pairs, jdec, jjac, jfit, *MU, DT)
    got = tecsw.ecsw_training_matrix_closure(
        p["tgrid"], *map(to_torch, pairs), tdec, tjac, tfit, *MU, DT)
    assert got.shape == want.shape == (9 * N_P, N * N)
    assert got.device.type == "cpu" and got.dtype == torch.float64
    assert rel(got, want) <= 1e-10


def test_stepper_runs_float32_state(problem):
    """An f32 state keeps the closure core in the model's f64 (the
    precision bridge) and stays near the f64 run."""
    p = problem
    _, tc = _closures(p, "global")
    f32 = torch.float32
    dec, jac = tcommon.manifold_decoder(to_torch(p["u_p"], dtype=f32),
                                        to_torch(p["u_s"], dtype=f32), tc)
    y0 = to_torch(p["u_p"].T @ p["w0"], dtype=f32)
    res = trom.manifold_rom(p["tgrid"], y0, dec, jac, DT, STEPS, *MU)
    _, ref = _run_both(p, "global", False, "plain")
    assert res.red_coords.dtype == f32
    assert rel(res.red_coords.double(), ref.red_coords) <= 1e-4
