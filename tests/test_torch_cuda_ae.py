"""The autoencoder, its trainer and its checkpoint on the card against the
same calls on the CPU.

Tests marked `cuda` need an NVIDIA GPU and skip without one; on a machine
with a card run them with

    python -m pytest tests/test_torch_cuda_ae.py --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which this file does not
use).

Tolerances, card against CPU on the same inputs (input width 40, latent
4): a float64 network's decode, batch of decodes and jacfwd Jacobian
1e-12 relative, a float32 network's 1e-5 (cuBLAS and the CPU's GEMMs sum
in different orders); three epochs replayed from the trainer's CUDA graph
(minibatch.EpochGraph, what train_autoencoder runs on the card) against
eager epochs on the card from the same parameters and permutations, 1e-9
for a float64 network and 1e-4 for a float32 one (Adam divides by the
root of the second moment, which lifts the rounding of a small gradient
to the step's size); train_autoencoder on the card against the CPU on
float64 data, 6 epochs, 1e-4: its parameters are float32 (Flax's), so
each Adam step rounds in float32; a saved checkpoint loads back bit for
bit.
"""

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch.closures import autoencoder as tae
from finitedifference_tpu_torch.training import ae_train
from finitedifference_tpu_torch.training import minibatch
from finitedifference_tpu_torch.training import monitor as tmon

DIM, LATENT = 40, 4
NET_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
EPOCH_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
TRAIN_TOL = 1e-4


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


def snapshots(n=120, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1, 1, size=(n, 2))
    return 1 + np.tanh(z @ rng.normal(size=(2, DIM)))


def scaled(dtype, device, seed=3):
    x = snapshots()
    module = tae.init_autoencoder(DIM, LATENT, generator=torch.Generator()
                                  .manual_seed(seed), device=device,
                                  dtype=dtype)
    return tae.ScaledAE(module, torch.tensor(x.mean(0), device=device),
                        torch.tensor(x.std(0) + 1e-10, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_decoder_on_card_matches_cpu(cuda, dtype):
    z = torch.tensor(np.random.default_rng(1).normal(size=(LATENT, 9)))
    cpu, gpu = scaled(dtype, "cpu"), scaled(dtype, cuda)
    for got, want in ((gpu.decode(z[:, 0].to(cuda)), cpu.decode(z[:, 0])),
                      (gpu.decode(z.to(cuda)), cpu.decode(z)),
                      (gpu.encode(gpu.decode(z.to(cuda))),
                       cpu.encode(cpu.decode(z)))):
        assert got.dtype == torch.float64
        assert rel(got, want) <= NET_TOL[dtype]
    _, jac_gpu, _ = tae.ae_decoder_fns(gpu)
    _, jac_cpu, _ = tae.ae_decoder_fns(cpu)
    jac = jac_gpu(z[:, 0].to(cuda))
    assert jac.shape == (DIM, LATENT) and jac.device.type == "cuda"
    assert rel(jac, jac_cpu(z[:, 0])) <= NET_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_graphed_epochs_match_eager(cuda, dtype):
    """Three epochs replayed from the CUDA graph against _train_epoch on
    the card, from the same parameters and permutations: the same Adam
    counts, the parameters and losses within EPOCH_TOL."""
    x = torch.tensor(snapshots(), dtype=dtype, device=cuda)
    eager, graphed = scaled(dtype, cuda), scaled(dtype, cuda)
    mu, sig = (t.to(dtype) for t in eager[1:])
    s_eager = minibatch.adam_init_flat(eager.module)
    graph = minibatch.EpochGraph(ae_train._loss(mu, sig), graphed.module,
                                 minibatch.adam_init_flat(graphed.module),
                                 (x,), 16)
    for e in range(3):
        perm = torch.randperm(120, generator=torch.Generator().manual_seed(
            e)).to(cuda)
        s_eager, l_eager = ae_train._train_epoch(eager.module, s_eager, x,
                                                 mu, sig, perm, 16)
        s_graph, l_graph = graph.run(graphed.module, (x,), perm, 1e-3)
        assert s_graph.count == s_eager.count == 7 * (e + 1)
        assert rel(minibatch.flat_params(graphed.module)[0],
                   minibatch.flat_params(eager.module)[0]) \
            <= EPOCH_TOL[dtype]
        assert rel(l_graph, l_eager) <= EPOCH_TOL[dtype]


@pytest.mark.cuda
def test_train_autoencoder_on_card_matches_cpu(cuda, tmp_path):
    """train_autoencoder on the card (the graphed epochs) and on the CPU
    from the same seed on float64 data: the same split, init and
    permutations, so the same epochs and checkpoints within TRAIN_TOL."""
    x = snapshots()
    kw = dict(epochs=6, lr=3e-3, batch_size=16, patience=20,
              train_dtype="float64")
    got, mon_g = ae_train.train_autoencoder(
        x, LATENT, model_path=str(tmp_path / "g.pt"), device=cuda, **kw)
    want, mon_w = ae_train.train_autoencoder(
        x, LATENT, model_path=str(tmp_path / "c.pt"), device="cpu", **kw)
    assert got.net_dtype == want.net_dtype == torch.float32
    assert got.mu_in.dtype == torch.float64
    assert mon_g.epoch == mon_w.epoch
    assert rel(minibatch.flat_params(got.module)[0],
               minibatch.flat_params(want.module)[0]) <= TRAIN_TOL
    np.testing.assert_allclose(mon_g.test_crits, mon_w.test_crits,
                               rtol=TRAIN_TOL)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    path = str(tmp_path / "ae.pt")
    module = scaled(torch.float32, cuda).module
    mon = tmon.TrainingMonitor(path, patience=5)
    mon.check_for_completion(1.0, 0.5, module)
    back = tmon.load_checkpoint(path, scaled(torch.float32, cuda,
                                             seed=9).module)
    for a, b in zip(module.parameters(), back.parameters()):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert torch.equal(a, b)
