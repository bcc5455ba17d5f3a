"""The multi-rank paths on the card: gloo ranks that share card 0, their
halos staged through the host (parallel/mesh).

Tests marked `cuda` need an NVIDIA GPU and skip without one; on a machine
with a card run them with

    python -m pytest tests/test_torch_cuda_parallel.py --noconftest -q

(--noconftest: tests/conftest.py configures JAX, which this file does not
use).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parallel_ranks as ranks
from finitedifference_tpu_torch.fom import inviscid_burgers_implicit2d_skewed
from finitedifference_tpu_torch.grid import Grid2D
from finitedifference_tpu_torch.parallel import mesh as pmesh

TIMEOUT = 300.0


@pytest.fixture(scope="module")
def on_card():
    """(one rank, two ranks) of ranks.card_halo_and_skewed over gloo on
    card 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return tuple(pmesh.spawn(ranks.card_halo_and_skewed, n, 0,
                             device="cuda", backend="gloo", timeout=TIMEOUT)
                 for n in (1, 2))


@pytest.mark.cuda
def test_staged_halo_is_a_local_shift(on_card):
    """Each rank's block shifted across the ranks through the host, then
    gathered: bit for bit the shift of the whole tensor on one card."""
    for out in on_card:
        want = F.pad(out["x"], (0, 0, 1, 0))[:-1]
        assert torch.equal(out["shifted"], want)


@pytest.mark.cuda
def test_two_ranks_on_one_card_equal_one_rank(on_card):
    """The sharded skewed trajectory over two gloo ranks on card 0 equals
    the one-rank run (the same recurrence; only the norm's sum is split)
    and B1's unsharded engine within 1e-12."""
    one, two = on_card
    assert one["device"].startswith("cuda") and two["device"] == \
        one["device"]
    assert two["its"] == one["its"]
    np.testing.assert_allclose(two["snaps"].numpy(), one["snaps"].numpy(),
                               rtol=1e-13, atol=1e-14)
    g = Grid2D(nx=40, ny=24)
    ref = inviscid_burgers_implicit2d_skewed(
        g, torch.ones(g.state_dim, dtype=torch.float64, device="cuda"),
        0.05, 6, 4.75, 0.02)
    assert ref.total_newton_its == two["its"]
    np.testing.assert_allclose(two["snaps"].numpy(),
                               ref.snaps.cpu().numpy(), rtol=1e-12,
                               atol=1e-13)


@pytest.mark.cuda
def test_nccl_needs_a_card_a_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    with pytest.raises(ValueError, match="gloo"):
        pmesh.spawn(ranks.hang, torch.cuda.device_count() + 1,
                    device="cuda")
