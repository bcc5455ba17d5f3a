"""The hand-written residual kernels (csrc/skewed_residual.cu: one update
of the skewed FOM's Newton loop, and one step's constant, each with the
norm of its residual) against the plain PyTorch expressions on the card.

Tests marked `cuda` need an NVIDIA GPU and skip without one; on a machine
with a card run them with

    python -m pytest tests/test_torch_cuda_residual.py --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which this file does not
use). The tests without the marker run anywhere. Run as a script, the
file prints the device kernels of one call of each wrapper as one JSON
line (test_each_call_is_one_device_kernel runs it so).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch import fom
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.ops import cuda_skewed as cr
from finitedifference_tpu_torch.ops import skewed as sk
from finitedifference_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
DT = 0.05
MU = (4.75, 0.02)
# rn and init_norm: the kernel sums in the working type, as torch.sum does
# on the card, in another order
NORM_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def step_inputs(n, dtype, device, seed=0):
    """(grid, lay, valid, fields) at n^2: a step's start (up, vp) near 1,
    the current state (u, v) and an update (du, dv) near it, the source
    and inflow terms; every field zero off the band, as in the FOM."""
    grid = Grid2D(nx=n, ny=n)
    lay = sk.make_layout(grid)
    band = sk.valid_mask(lay, torch.float64).numpy()
    rng = np.random.default_rng(seed)
    shape = (lay.nd_pad, lay.ny_pad)
    up, vp = (1 + 0.2 * rng.uniform(size=shape) for _ in range(2))
    u, v = (x + 0.01 * rng.normal(size=shape) for x in (up, vp))
    du, dv = (1e-3 * rng.normal(size=shape) for _ in range(2))
    fields = {k: torch.as_tensor(x * band, dtype=dtype, device=device)
              for k, x in zip(("up", "vp", "u", "v", "du", "dv"),
                              (up, vp, u, v, du, dv))}
    fields["src"] = sk.skewed_source(lay, grid, MU[1], DT, dtype, device)
    fields["lbc"] = sk.skewed_inflow_bc(lay, grid, MU[0], DT, dtype, device)
    return grid, lay, sk.valid_mask(lay, dtype, device), fields


def rel(got, want):
    return float(abs(got.double() - want.double()) / abs(want.double()))


def run_both(n, dtype, device, seed=0, *, update=True, stagnation=True,
             cutoff=1e-12, scale=(1.0, 1.0)):
    """The step constant, then one update (or the guess's residual), by
    the kernels and by the plain expressions on the same card.
    init_norm and rn_prev are scaled by `scale` to reach either branch of
    the stop test. Returns (kernel outputs, plain outputs)."""
    grid, lay, valid, f = step_inputs(n, dtype, device, seed)
    ws = cr.ResidualWorkspace(lay, dtype, device)
    got_c = cr.step_constant_cuda(f["up"], f["vp"], DT, grid, lay, f["src"],
                                  f["lbc"], workspace=ws)
    want_c = sk.skewed_step_constant_norm_ref(f["up"], f["vp"], DT, grid,
                                              f["src"], f["lbc"], valid)
    init = want_c[4] * scale[0]
    kw = dict(init_norm=init, cutoff=cutoff,
              rn_prev=want_c[4] * scale[1] if stagnation else None)
    du, dv = (f["du"], f["dv"]) if update else (None, None)
    got_u = cr.update_residual_cuda(f["u"], f["v"], du, dv, *want_c[:2], DT,
                                    grid, lay, workspace=ws, **kw)
    want_u = sk.skewed_update_residual_ref(f["u"], f["v"], du, dv,
                                           *want_c[:2], DT, grid, valid,
                                           **kw)
    torch.cuda.synchronize()
    return (got_c, got_u), (want_c, want_u)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [250, 750])
@pytest.mark.parametrize("update", [True, False])
def test_kernels_give_the_eager_bits(cuda, n, dtype, update):
    """u', v', ru, rv, cp and r0 are the eager CUDA expressions' bits; rn
    and init_norm agree to rounding; stop is the eager stop."""
    (got_c, got_u), (want_c, want_u) = run_both(n, dtype, cuda,
                                                update=update)
    for name, g, w in zip(("cp_u", "cp_v", "r0u", "r0v"), got_c, want_c):
        assert g.dtype == dtype and torch.equal(g, w), name
    assert rel(got_c[4], want_c[4]) <= NORM_TOL[dtype]
    for name, g, w in zip(("u'", "v'", "ru", "rv"), got_u, want_u):
        assert torch.equal(g, w), name
    assert rel(got_u[4], want_u[4]) <= NORM_TOL[dtype]
    assert got_u[5].dtype == torch.bool
    assert bool(got_u[5]) == bool(want_u[5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("branch,scale,stagnation,stop", [
    ("neither", (1e-3, 1e3), True, False),
    ("cutoff", (1e15, 1e3), True, True),
    ("stagnation", (1e-3, 1e-3), True, True),
    ("no stagnation term", (1e-3, 1e-3), False, False),
])
def test_the_stop_test_takes_both_branches(cuda, dtype, branch, scale,
                                           stagnation, stop):
    """rn / init_norm < cutoff or rn > 0.99 rn_prev, as the eager
    expression decides it, in each branch."""
    cutoff = 1e-6 if dtype == torch.float32 else 1e-12
    (_, got), (_, want) = run_both(250, dtype, cuda, stagnation=stagnation,
                                   cutoff=cutoff, scale=scale)
    assert bool(got[5]) == bool(want[5]) == stop, branch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_are_deterministic_under_load(cuda, dtype):
    """Ten launches on the same inputs, other work on the card between
    them, give the same bits, the norms included: the last block sums the
    blocks' sums in block order, whichever block finishes last."""
    grid, lay, valid, f = step_inputs(750, dtype, cuda, seed=3)
    ws = cr.ResidualWorkspace(lay, dtype, cuda)

    def both():
        c = cr.step_constant_cuda(f["up"], f["vp"], DT, grid, lay, f["src"],
                                  f["lbc"], workspace=ws)
        r = cr.update_residual_cuda(f["u"], f["v"], f["du"], f["dv"], *c[:2],
                                    DT, grid, lay, init_norm=c[4],
                                    rn_prev=c[4], cutoff=1e-12, workspace=ws)
        return (*c, *r)

    first = both()
    busy = torch.randn((2048, 2048), device=cuda)
    for _ in range(10):
        busy = busy @ busy.T / 2048
        again = both()
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert int(ws.ticket) == 0


def profiled_kernels():
    """The device kernels of one call of each wrapper at 250^2, each call
    alone under torch.profiler, and the launch counters' moves over the
    two calls: {"kernels": {kernel name: [device kernels]}, "moved":
    [update launches, step-constant launches]}."""
    cuda = torch.device("cuda")
    grid, lay, _, f = step_inputs(250, torch.float64, cuda)
    ws = cr.ResidualWorkspace(lay, torch.float64, cuda)
    c = cr.step_constant_cuda(f["up"], f["vp"], DT, grid, lay, f["src"],
                              f["lbc"], workspace=ws)
    torch.cuda.synchronize()
    before = (cr.RESIDUAL_LAUNCHES, cr.STEP_CONSTANT_LAUNCHES)
    calls = {
        "skewed_step_constant_kernel": lambda: cr.step_constant_cuda(
            f["up"], f["vp"], DT, grid, lay, f["src"], f["lbc"],
            workspace=ws),
        "skewed_update_residual_kernel": lambda: cr.update_residual_cuda(
            f["u"], f["v"], f["du"], f["dv"], *c[:2], DT, grid, lay,
            init_norm=c[4], rn_prev=c[4], cutoff=1e-12, workspace=ws),
    }
    kernels = {}
    for name, call in calls.items():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels[name] = [e.key for e in prof.key_averages()
                         for _ in range(e.count)
                         if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels": kernels,
            "moved": [cr.RESIDUAL_LAUNCHES - before[0],
                      cr.STEP_CONSTANT_LAUNCHES - before[1]]}


@pytest.mark.cuda
def test_each_call_is_one_device_kernel(cuda):
    """torch.profiler counts one device kernel in a call of each wrapper,
    named so that no solve pattern of the benchmark takes it, and each
    call moves its launch counter by one. Counted in a process of its
    own (this file run as a script): on the H100 a profiler session
    after another one in the same process, with other work between them,
    has recorded no kernel of a one-kernel call, so the session stays
    out of the process that runs the other card tests."""
    proc = subprocess.run(
        [sys.executable, __file__], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, kernels in got["kernels"].items():
        assert len(kernels) == 1 and name in kernels[0], kernels
        assert "wavefront" not in kernels[0] and "seg_" not in kernels[0]
    assert len(got["kernels"]) == 2 and got["moved"] == [1, 1]


@pytest.mark.cuda
def test_kernels_raise_on_what_they_do_not_take(cuda):
    """A wrong shape, a mix of dtypes or devices, float16, a non-contiguous
    field, a norm that is not a 0-d tensor of the fields' dtype, a
    workspace of another layout and none raise; nothing launches."""
    grid, lay, valid, f = step_inputs(24, torch.float64, cuda)
    ws = cr.ResidualWorkspace(lay, torch.float64, cuda)
    c = sk.skewed_step_constant_norm_ref(f["up"], f["vp"], DT, grid,
                                         f["src"], f["lbc"], valid)
    other = cr.ResidualWorkspace(sk.make_layout(Grid2D(nx=300, ny=300)),
                                 torch.float64, cuda)
    wide = torch.zeros((lay.nd_pad, 2 * lay.ny_pad), dtype=torch.float64,
                       device=cuda)[:, :lay.ny_pad]

    def update(u=f["u"], du=f["du"], init=c[4], ws=ws):
        return cr.update_residual_cuda(u, f["v"], du, f["dv"], *c[:2], DT,
                                       grid, lay, init_norm=init,
                                       rn_prev=c[4], cutoff=1e-12,
                                       workspace=ws)

    before = (cr.RESIDUAL_LAUNCHES, cr.STEP_CONSTANT_LAUNCHES)
    cases = {
        "shape": lambda: update(u=f["u"][:-1].contiguous()),
        "dtype": lambda: update(du=f["du"].float()),
        "CUDA": lambda: update(du=f["du"].cpu()),
        "float32 or float64": lambda: cr.step_constant_cuda(
            *(f[k].half() for k in ("up", "vp")), DT, grid, lay,
            *(f[k].half() for k in ("src", "lbc")), workspace=ws),
        "contiguous": lambda: update(u=wide.copy_(f["u"])),
        "init_norm": lambda: update(init=c[4].reshape(1)),
        "workspace": lambda: update(ws=other),
        "workspace None": lambda: update(ws=None),
    }
    for match, call in cases.items():
        with pytest.raises(ValueError, match=match.split()[0]):
            call()
    assert (cr.RESIDUAL_LAUNCHES, cr.STEP_CONSTANT_LAUNCHES) == before


def plain_update(u, v, du, dv, cp_u, cp_v, dt, grid, lay, valid, *,
                 workspace, **kw):
    return sk.skewed_update_residual_ref(u, v, du, dv, cp_u, cp_v, dt, grid,
                                         valid, **kw)


def plain_step_constant(up, vp, dt, grid, lay, src, lbc, valid, *,
                        workspace):
    return sk.skewed_step_constant_norm_ref(up, vp, dt, grid, src, lbc,
                                            valid)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,dtype", [
    (dict(), torch.float64), (dict(seg=8, seg_overlap=64), torch.float64),
    (dict(extrapolate_guess=True), torch.float64), (dict(), torch.float32),
    (dict(seg=8, seg_overlap=64), torch.float32)],
    ids=["exact", "seg8", "extrapolate", "exact-f32", "seg8-f32"])
def test_trajectory_matches_the_eager_loop(cuda, monkeypatch, kw, dtype):
    """A 20-step 750^2 trajectory, float64 and float32 states, with the
    kernels against the same loop on the same card with the plain
    expressions in their place (the eager loop before the kernels): the
    same Newton counts (the float32 norm sums in float32 in another order
    than torch.sum, and must flip no stop decision), snapshots within
    1e-13, one update launch an update (and a step when extrapolating)
    and one step-constant launch a step."""
    grid = Grid2D(nx=750, ny=750)
    w0 = torch.ones(grid.state_dim, dtype=dtype, device=cuda)
    steps = 20
    before = (cr.RESIDUAL_LAUNCHES, cr.STEP_CONSTANT_LAUNCHES)
    got = fom.inviscid_burgers_implicit2d_skewed(grid, w0, DT, steps, *MU,
                                                 **kw)
    launches = (cr.RESIDUAL_LAUNCHES - before[0],
                cr.STEP_CONSTANT_LAUNCHES - before[1])
    with monkeypatch.context() as m:
        m.setattr(sk, "skewed_update_residual", plain_update)
        m.setattr(sk, "skewed_step_constant_norm", plain_step_constant)
        want = fom.inviscid_burgers_implicit2d_skewed(grid, w0, DT, steps,
                                                      *MU, **kw)
    assert got.total_newton_its == want.total_newton_its
    gap = torch.linalg.vector_norm(got.snaps - want.snaps) \
        / torch.linalg.vector_norm(want.snaps)
    assert float(gap) <= 1e-13
    extra = steps if kw.get("extrapolate_guess") else 0
    assert launches == (got.total_newton_its + extra, steps)
    if dtype == torch.float64:
        assert float(got.max_final_relnorm) < 1e-12


@pytest.mark.cuda
def test_traced_trajectory_counts_one_fused_residual_an_update(cuda):
    """With the program's spans on, a trajectory on the card counts one
    fused residual and one host sync an update."""
    grid = Grid2D(nx=48, ny=48)
    w0 = torch.ones(grid.state_dim, dtype=torch.float64, device=cuda)
    with profiling.recording() as rec:
        res = fom.inviscid_burgers_implicit2d_skewed(grid, w0, DT, 6, *MU)
    torch.cuda.synchronize()
    its = res.total_newton_its
    assert rec.counters == {"fom.host_syncs": its,
                            "fom.fused_residuals": its}
    names = [s.name for s in rec.spans]
    assert names.count("fom.residual") == its


# ----------------------------------------------------------------------
# anywhere
# ----------------------------------------------------------------------

def test_cpu_tensors_raise():
    """The kernels' wrappers take CUDA tensors only; they never fall back
    to the plain versions, and count no launch."""
    grid, lay, valid, f = step_inputs(8, torch.float64, "cpu")
    c = sk.skewed_step_constant_norm_ref(f["up"], f["vp"], DT, grid,
                                         f["src"], f["lbc"], valid)
    before = (cr.RESIDUAL_LAUNCHES, cr.STEP_CONSTANT_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cr.step_constant_cuda(f["up"], f["vp"], DT, grid, lay, f["src"],
                              f["lbc"], workspace=None)
    with pytest.raises(ValueError, match="CUDA"):
        cr.update_residual_cuda(f["u"], f["v"], f["du"], f["dv"], *c[:2],
                                DT, grid, lay, init_norm=c[4], rn_prev=c[4],
                                cutoff=1e-12, workspace=None)
    assert (cr.RESIDUAL_LAUNCHES, cr.STEP_CONSTANT_LAUNCHES) == before


def test_a_cpu_run_takes_no_workspace():
    """The plain versions need no scratch: a CPU run's workspace is None."""
    lay = sk.make_layout(Grid2D(nx=8, ny=6))
    assert sk.residual_workspace(lay, torch.float64, "cpu") is None


if __name__ == "__main__":
    # test_each_call_is_one_device_kernel's own process
    print(json.dumps(profiled_kernels()))
