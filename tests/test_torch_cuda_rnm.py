"""The RNM closure, its trainer and its checkpoint on the card against the
same calls on the CPU.

Tests marked `cuda` need an NVIDIA GPU and skip without one; on a machine
with a card run them with

    python -m pytest tests/test_torch_cuda_rnm.py --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which this file does not
use).

Tolerances, card against CPU on the same inputs: a float64 network's
values and Jacobians 1e-12 relative, a float32 network's 1e-5 (cuBLAS
and the CPU's GEMMs sum in different orders); one training epoch of 12
Adam steps from the same parameters and permutation 1e-9 in float64 and
1e-4 in float32 (Adam divides by the root of the second moment, which
lifts the rounding of a small gradient to the step's size), and three
epochs replayed from the trainer's CUDA graph against eager epochs on
the card to the same bounds; train_rnm on the card against the CPU,
float64, 8 epochs, 1e-8; a saved checkpoint loads back bit for bit.
"""

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch.closures import ann
from finitedifference_tpu_torch.training import minibatch
from finitedifference_tpu_torch.training import monitor as tmon
from finitedifference_tpu_torch.training import rnm_train

EPOCH_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
CLOSURE_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
TRAIN_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU references here are small: torch's intra-op threads only
    spin, and their load slows the tests that share the machine. One
    thread for the module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def rel(a, b):
    a = a.detach().cpu().double().numpy()
    b = b.detach().cpu().double().numpy()
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def pairs(n=200, n_p=4, n_s=6, seed=0):
    rng = np.random.default_rng(seed)
    q_p = rng.uniform(-1, 1, size=(n, n_p))
    q_s = np.tanh(q_p @ rng.normal(size=(n_p, n_s)))
    return q_p, q_s


def net(dtype, device, n_p=4, n_s=6, seed=3):
    return ann.init_rnm(n_p, n_s, generator=torch.Generator().manual_seed(
        seed), dtype=dtype, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_closure_on_card_matches_cpu(cuda, dtype):
    y = torch.tensor(np.random.default_rng(1).normal(size=4))
    c_cpu = ann.rnm_closure(net(dtype, "cpu"))
    c_gpu = ann.rnm_closure(net(dtype, cuda))
    assert rel(c_gpu.predict(y.to(cuda)), c_cpu.predict(y)) \
        <= CLOSURE_TOL[dtype]
    jac = c_gpu.jacobian(y.to(cuda))
    assert jac.shape == (6, 4) and jac.dtype == torch.float64
    assert rel(jac, c_cpu.jacobian(y)) <= CLOSURE_TOL[dtype]


@pytest.mark.cuda
def test_closure_under_vmap_on_card(cuda):
    """rnm_closure under torch.func.vmap on the card: each row equals the
    lone call, value and Jacobian (run_manifold decodes the trajectory
    this way)."""
    c = ann.rnm_closure(net(torch.float32, cuda))
    ys = torch.tensor(np.random.default_rng(2).normal(size=(5, 4)),
                      device=cuda)
    vals = torch.func.vmap(c.predict)(ys)
    jacs = torch.func.vmap(c.jacobian)(ys)
    for i in range(5):
        assert rel(vals[i], c.predict(ys[i])) <= 1e-6
        assert rel(jacs[i], c.jacobian(ys[i])) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_train_epoch_on_card_matches_cpu(cuda, dtype):
    q_p, q_s = pairs()
    perm = torch.randperm(200, generator=torch.Generator().manual_seed(4))
    out = {}
    for dev in ("cpu", cuda):
        module = net(dtype, dev)
        state = minibatch.adam_init_flat(module)
        qp = torch.tensor(q_p, dtype=dtype, device=dev)
        qs = torch.tensor(q_s, dtype=dtype, device=dev)
        _, loss = rnm_train._train_epoch(module, state, qp, qs,
                                         perm.to(dev), 16, 1e-3)
        out[str(dev)] = (minibatch.flat_params(module)[0], loss)
    (p_cpu, l_cpu), (p_gpu, l_gpu) = out["cpu"], out[str(cuda)]
    assert rel(p_gpu, p_cpu) <= EPOCH_TOL[dtype]
    assert rel(l_gpu, l_cpu) <= EPOCH_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_graphed_epochs_match_eager(cuda, dtype):
    """Three epochs replayed from the CUDA graph (minibatch.EpochGraph on
    the RNM loss, what train_rnm runs on the card) against _train_epoch on the card,
    from the same parameters and permutations: the same Adam counts, the
    parameters and losses within EPOCH_TOL (the graph divides by the bias
    corrections where the eager step multiplies by their reciprocals)."""
    q_p, q_s = pairs()
    qp = torch.tensor(q_p, dtype=dtype, device=cuda)
    qs = torch.tensor(q_s, dtype=dtype, device=cuda)
    eager, graphed = net(dtype, cuda), net(dtype, cuda)
    s_eager = minibatch.adam_init_flat(eager)
    graph = minibatch.EpochGraph(rnm_train._rnm_loss, graphed,
                                 minibatch.adam_init_flat(graphed), (qp, qs),
                                 16)
    for e in range(3):
        perm = torch.randperm(200, generator=torch.Generator().manual_seed(
            e)).to(cuda)
        s_eager, l_eager = rnm_train._train_epoch(eager, s_eager, qp, qs,
                                                  perm, 16, 1e-3)
        s_graph, l_graph = graph.run(graphed, (qp, qs), perm, 1e-3)
        assert s_graph.count == s_eager.count == 12 * (e + 1)
        assert rel(minibatch.flat_params(graphed)[0],
                   minibatch.flat_params(eager)[0]) \
            <= EPOCH_TOL[dtype]
        assert rel(l_graph, l_eager) <= EPOCH_TOL[dtype]


@pytest.mark.cuda
def test_train_rnm_on_card_matches_cpu(cuda, tmp_path):
    """train_rnm on the card (the graphed epochs) and on the CPU from the
    same seed, float64: the same split, init and permutations, so the same
    epochs and checkpoints within TRAIN_TOL."""
    q_p, q_s = pairs()
    kw = dict(epochs=8, lr=3e-3, batch_size=16, patience=20,
              train_dtype="float64")
    got, mon_g = rnm_train.train_rnm(q_p, q_s, model_path=str(
        tmp_path / "g.pt"), device=cuda, **kw)
    want, mon_w = rnm_train.train_rnm(q_p, q_s, model_path=str(
        tmp_path / "c.pt"), device="cpu", **kw)
    assert mon_g.epoch == mon_w.epoch
    assert rel(minibatch.flat_params(got)[0], minibatch.flat_params(want)[0]) \
        <= TRAIN_TOL
    np.testing.assert_allclose(mon_g.test_crits, mon_w.test_crits,
                               rtol=TRAIN_TOL)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    path = str(tmp_path / "rnm.pt")
    module = net(torch.float32, cuda)
    mon = tmon.TrainingMonitor(path, patience=5)
    mon.check_for_completion(1.0, 0.5, module)
    back = tmon.load_checkpoint(path, net(torch.float32, cuda, seed=9))
    for a, b in zip(module.parameters(), back.parameters()):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert torch.equal(a, b)
