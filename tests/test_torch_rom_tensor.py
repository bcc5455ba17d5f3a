"""The tensorized HPROM (rom_tensor.py) against the JAX package on the
CPU.

The 12x10 problem and 40-cell mesh of tests/test_rom.py's TestTensorHPROM
go through both packages in f64, with that test's assertions: normal
equations rtol 1e-8 / atol 1e-10 against the generic ecsw_hprom (the
JAX one and the port's) with equal Gauss-Newton counts, the unrolled loop
the same, CG rtol 1e-5 / atol 1e-7.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from finitedifference_tpu import rom_tensor as jrt
from finitedifference_tpu.rom import ecsw_hprom as jecsw
from finitedifference_tpu.rom import prepare_hprom as jprepare
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch import rom_tensor as trt
from finitedifference_tpu_torch.convert import grid_from_jax
from finitedifference_tpu_torch.rom import ecsw_hprom as tecsw
from finitedifference_tpu_torch.rom import prepare_hprom as tprepare
from tests.test_rom import DT, MU, setup_problem

# arrays go to the CPU, where the plain versions run
to_torch = functools.partial(convert.to_torch, device="cpu")

STEPS = 20


@pytest.fixture(scope="module")
def tensor_problem():
    grid, _, _, w0, basis = setup_problem(num_steps=STEPS)
    rng = np.random.default_rng(7)
    weights = np.zeros(grid.n_cells)
    chosen = rng.choice(grid.n_cells, size=40, replace=False)
    weights[chosen] = 1.0 + rng.uniform(size=40)
    jmesh, jsw, jba = jprepare(grid, weights, basis)
    tg = grid_from_jax(grid)
    tmesh, tsw, tba = tprepare(tg, weights, to_torch(basis))
    y0 = basis.T @ w0
    jt = jrt.precompute_hprom_tensors(grid, jmesh, jsw, jba, DT)
    tt = trt.precompute_hprom_tensors(tg, tmesh, tsw, tba, DT)
    ref = jecsw(grid, jmesh, jsw, jnp.asarray(y0), jba, DT, STEPS, MU[0],
                MU[1], ls_method="normal")
    own = tecsw(tg, tmesh, tsw, to_torch(y0), tba, DT, STEPS, MU[0], MU[1],
                ls_method="normal")
    return dict(jg=grid, tg=tg, jmesh=jmesh, jsw=jsw, tmesh=tmesh, tsw=tsw,
                y0=y0, jt=jt, tt=tt, ref=ref, own=own)


def test_tensors_match_jax(tensor_problem):
    p = tensor_problem
    for f in trt.HPROMTensors._fields:
        np.testing.assert_allclose(getattr(p["tt"], f).numpy(),
                                   np.asarray(getattr(p["jt"], f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    carried = convert.tensors_from_jax(p["jt"], device="cpu")
    for f, a in zip(trt.HPROMTensors._fields, carried):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(p["jt"], f)))


@pytest.mark.parametrize("kw", [
    dict(ls_method="normal"),
    dict(ls_method="normal", unroll_its=20),
], ids=["normal", "unroll20"])
def test_tensor_hprom_matches_generic(tensor_problem, kw):
    """Normal equations, dynamic or with a budget above the dynamic
    loop's worst per-step count: the generic engine's trajectory and
    counts, JAX's tensor_hprom too."""
    p = tensor_problem
    got = trt.tensor_hprom(p["tg"], p["tmesh"], p["tsw"], to_torch(p["y0"]),
                           p["tt"], DT, STEPS, MU[0], MU[1], **kw)
    want = jrt.tensor_hprom(p["jg"], p["jmesh"], p["jsw"],
                            jnp.asarray(p["y0"]), p["jt"], DT, STEPS, MU[0],
                            MU[1], **kw)
    for ref in (np.asarray(p["ref"].red_coords),
                p["own"].red_coords.numpy(), np.asarray(want.red_coords)):
        np.testing.assert_allclose(got.red_coords.numpy(), ref, rtol=1e-8,
                                   atol=1e-10)
    assert got.total_gn_its == int(p["ref"].total_gn_its) \
        == p["own"].total_gn_its == int(want.total_gn_its)


def test_tensor_hprom_cg_close(tensor_problem):
    p = tensor_problem
    got = trt.tensor_hprom(p["tg"], p["tmesh"], p["tsw"], to_torch(p["y0"]),
                           p["tt"], DT, STEPS, MU[0], MU[1], ls_method="cg")
    np.testing.assert_allclose(got.red_coords.numpy(),
                               np.asarray(p["ref"].red_coords), rtol=1e-5,
                               atol=1e-7)
    with pytest.raises(ValueError, match="ls_method"):
        trt.tensor_hprom(p["tg"], p["tmesh"], p["tsw"], to_torch(p["y0"]),
                         p["tt"], DT, 1, MU[0], MU[1], ls_method="fused")
