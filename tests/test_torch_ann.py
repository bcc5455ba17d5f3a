"""The port's RNM closure (finitedifference_tpu_torch.closures.ann) against
the JAX package's, on the CPU.

Every network is a Flax RNM_NN initialised from a JAX key, carried across
by convert.rnm_from_flax (the port's own init draws other bits from the
same distribution, checked on its own):
- forward and torch.func.jacfwd Jacobian against Flax apply and
  jax.jacfwd: float64 networks to 1e-12 (relative), float32 networks to
  2e-6 (three times the 6.4e-7 measured: XLA's and PyTorch's f32 GEMMs
  sum in different orders);
- rnm_closure_with_mu, its Jacobian with respect to q_p only;
- the closure under torch.func.vmap against jax.vmap and the lone calls;
- the init: zero biases, kernels inside +-2 std, the sample std within 5%
  of the truncated normal's, the default generator that of seed 0;
- sweep_manifold with an RNM closure against JAX's to 1e-10.
Plus a scan of the port and chip_smoke.py for imports of JAX, Flax,
optax, msgpack or the JAX package.
"""

import ast
import functools
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finitedifference_tpu.closures import ann as jann
from finitedifference_tpu_torch import convert
from finitedifference_tpu_torch.closures import ann as tann

to_torch = functools.partial(convert.to_torch, device="cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
N_P, N_S = 4, 7
TOL = {np.float64: 1e-12, np.float32: 2e-6}


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
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.linalg.norm(a - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def flax_net(dtype, n_in=N_P, n_out=N_S, seed=0):
    module, params = jann.init_rnm(n_in, n_out,
                                   key=jax.random.PRNGKey(seed))
    return module, jax.tree_util.tree_map(lambda x: x.astype(dtype), params)


def inputs(n=4, seed=1):
    return np.random.default_rng(seed).normal(size=(n, N_P)) * 3.0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_forward_and_jacobian_match_flax(dtype):
    module, params = flax_net(dtype)
    net = convert.rnm_from_flax(params, device="cpu")
    assert all(p.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
               for p in net.parameters())
    assert net.hidden == tann.HIDDEN
    want_c = jann.rnm_closure(module, params)
    want_predict, want_jac = jax.jit(want_c.predict), jax.jit(want_c.jacobian)
    got_c = tann.rnm_closure(net)
    for y in inputs():
        want = want_predict(jnp.asarray(y))
        got = got_c.predict(to_torch(y))
        assert got.dtype == torch.float64
        assert rel(got, want) <= TOL[dtype]
        jac = got_c.jacobian(to_torch(y))
        assert jac.shape == (N_S, N_P)
        assert rel(jac, want_jac(jnp.asarray(y))) <= TOL[dtype]
    # the module's own forward on a batch equals Flax's apply
    ys = inputs().astype(dtype)
    assert rel(net(to_torch(ys)), module.apply(params, jnp.asarray(ys))) \
        <= TOL[dtype]


def test_closure_with_mu_matches_flax():
    mu = (4.75, 0.02)
    module, params = flax_net(np.float64, n_in=N_P + 2)
    net = convert.rnm_from_flax(params, device="cpu")
    want_c = jann.rnm_closure_with_mu(module, params, mu)
    want_predict, want_jac = jax.jit(want_c.predict), jax.jit(want_c.jacobian)
    got_c = tann.rnm_closure_with_mu(net, mu)
    for y in inputs(3):
        assert rel(got_c.predict(to_torch(y)),
                   want_predict(jnp.asarray(y))) <= 1e-12
        jac = got_c.jacobian(to_torch(y))
        assert jac.shape == (N_S, N_P)
        assert rel(jac, want_jac(jnp.asarray(y))) <= 1e-12


def test_closure_under_vmap():
    module, params = flax_net(np.float64)
    want_c = jann.rnm_closure(module, params)
    got_c = tann.rnm_closure(convert.rnm_from_flax(params, device="cpu"))
    ys = inputs(5)
    vals = torch.func.vmap(got_c.predict)(to_torch(ys))
    jacs = torch.func.vmap(got_c.jacobian)(to_torch(ys))
    assert rel(vals, jax.vmap(want_c.predict)(jnp.asarray(ys))) <= 1e-12
    assert rel(jacs, jax.vmap(want_c.jacobian)(jnp.asarray(ys))) <= 1e-12
    for i, y in enumerate(ys):
        assert rel(vals[i], got_c.predict(to_torch(y))) <= 1e-14
        assert rel(jacs[i], got_c.jacobian(to_torch(y))) <= 1e-14


def test_init_distribution():
    """Flax's lecun_normal: zero biases, kernels inside +-2 std
    (std = sqrt(1 / fan_in) / 0.8796...), the sample std that of the
    truncated normal, sqrt(1 / fan_in), within 5% on the layers wide
    enough to say (>= 8,000 weights), as Flax's own sample is."""
    net = tann.init_rnm(10, 140, generator=torch.Generator().manual_seed(5),
                        device="cpu")
    _, fparams = jann.init_rnm(10, 140, key=jax.random.PRNGKey(5))
    for i, layer in enumerate(net.layers):
        fan_in = layer.in_features
        std = math.sqrt(1.0 / fan_in) / tann.TRUNC_STD
        w = layer.weight.detach()
        assert torch.all(layer.bias == 0)
        assert float(w.abs().max()) <= 2 * std
        flax_w = np.asarray(fparams["params"][f"Dense_{i}"]["kernel"])
        assert flax_w.shape == tuple(w.T.shape)
        if w.numel() >= 8000:
            for sample in (float(w.std()), float(flax_w.std())):
                assert abs(sample / math.sqrt(1.0 / fan_in) - 1) <= 0.05
    # one seed gives one network; no generator is the generator of seed 0
    again = tann.init_rnm(10, 140, generator=torch.Generator().manual_seed(5),
                          device="cpu")
    default = tann.init_rnm(10, 140, device="cpu")
    zero = tann.init_rnm(10, 140, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    for a, b, c, d in zip(net.parameters(), again.parameters(),
                          default.parameters(), zero.parameters()):
        assert torch.equal(a, b) and torch.equal(c, d)
    assert not torch.equal(net.layers[0].weight, zero.layers[0].weight)
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_init_does_not_touch_the_global_generator():
    torch.manual_seed(11)
    want = torch.rand(3)
    torch.manual_seed(11)
    tann.init_rnm(3, 5, device="cpu")
    assert torch.equal(torch.rand(3), want)


def test_sweep_manifold_with_rnm_matches_jax():
    """sweep_manifold of an RNM closure ROM over two μ points at 8^2,
    float64 network and state, against JAX's vmapped sweep: the reduced
    coordinates to 1e-10, and each row equal to a lone manifold_rom."""
    from finitedifference_tpu.closures.common import (
        manifold_decoder as jdecoder,
    )
    from finitedifference_tpu.grid import Grid2D as JGrid
    from finitedifference_tpu.parallel.sweep import (
        sweep_manifold as jsweep,
    )
    from finitedifference_tpu_torch.closures.common import manifold_decoder
    from finitedifference_tpu_torch.grid import Grid2D
    from finitedifference_tpu_torch.parallel.sweep import sweep_manifold
    from finitedifference_tpu_torch.rom import manifold_rom

    n, n_p, n_s, dt, steps = 8, 3, 4, 0.05, 6
    rng = np.random.default_rng(7)
    basis = np.linalg.qr(rng.normal(size=(2 * n * n, n_p + n_s)))[0]
    u_p, u_s = basis[:, :n_p], basis[:, n_p:]
    w0 = np.ones(2 * n * n)
    module, params = flax_net(np.float64, n_in=n_p, n_out=n_s)
    # a small closure: the decoded state stays near the linear one
    params = jax.tree_util.tree_map(lambda x: x * 0.1, params)
    mus = np.array([[4.5, 0.02], [5.0, 0.028]])
    y0 = u_p.T @ w0
    jgrid = JGrid(nx=n, ny=n, x_up=100.0, y_up=100.0)
    jdec, jjac = jdecoder(jnp.asarray(u_p), jnp.asarray(u_s),
                          jann.rnm_closure(module, params))
    want = np.asarray(jsweep(jgrid, jnp.asarray(y0), jdec, jjac, dt, steps,
                             mus))
    grid = Grid2D(nx=n, ny=n, x_up=100.0, y_up=100.0)
    closure = tann.rnm_closure(convert.rnm_from_flax(params, device="cpu"))
    dec, jac = manifold_decoder(to_torch(u_p), to_torch(u_s), closure)
    got = sweep_manifold(grid, to_torch(y0), dec, jac, dt, steps, mus)
    assert got.shape == (2, n_p, steps + 1)
    assert rel(got, want) <= 1e-10
    for i, (m1, m2) in enumerate(mus):
        lone = manifold_rom(grid, to_torch(y0), dec, jac, dt, steps, m1, m2)
        assert torch.equal(got[i], lone.red_coords)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_and_smoke_import_no_jax_flax_optax_or_msgpack():
    files = sorted((ROOT / "finitedifference_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in (
                "jax", "jaxlib", "flax", "optax", "msgpack",
                "finitedifference_tpu"), f"{path}: {mod}"
