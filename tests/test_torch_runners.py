"""The port's runner CLIs on the CPU beside the JAX runners, each side in
its own working directory, at 12^2 and 8 steps.

- run_fom: the two snapshot files agree to 1e-12 (relative).
- run_prom and run_hprom get the same JAX-written basis_12x12.npy, so
  the two packages' randomized-SVD generators do not matter: equal N_e,
  weights to 1e-10, errors equal to 1e-6 percentage points, saved
  trajectories to 1e-10 (relative). The kernel engines, which the JAX
  runners cannot run on the CPU, are held against the port's generic
  engines (f32 against f64: 1e-4 relative, 1e-3 percentage points).
- Each package reads the other's artifacts (basis, weights, snapshot
  cache) and gets the other's numbers.
- run_sweep runs each --model; base_parser keeps the JAX flags but
  --platform, plus --device; a runner asked for the card where there is
  none fails at once.
"""

import contextlib
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from finitedifference_tpu_torch.runners import common as tcommon
from finitedifference_tpu_torch.runners import run_fom as trun_fom
from finitedifference_tpu_torch.runners import run_hprom as trun_hprom
from finitedifference_tpu_torch.runners import run_prom as trun_prom
from finitedifference_tpu_torch.runners import run_sweep as trun_sweep

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "runners"))
import common as jcommon  # noqa: E402
import run_fom as jrun_fom  # noqa: E402
import run_hprom as jrun_hprom  # noqa: E402
import run_prom as jrun_prom  # noqa: E402

SMALL = dict(num_cells=12, num_steps=8)
MU = (5.19, 0.026)
HPROM = dict(num_modes=6, bc_w=5.0, **SMALL)
FOM_FILE = os.path.join("param_snaps_12x12", "mu1_4.75+mu2_0.02.npy")
BASIS = "basis_12x12.npy"
WEIGHTS = "ecsw_weights_lspg_12x12.npy"
ROM_FILE = "rom_12x12_snaps_mu1_5.19_mu2_0.026.npy"
HPROM_FILE = "hprom_12x12_snaps_mu1_5.19_mu2_0.026.npy"


@contextlib.contextmanager
def cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) \
        / np.linalg.norm(np.asarray(b))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX workflow in one directory, then the port's in another that
    starts from the JAX basis: {side: (directory, results)}."""
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("torch")
    j, t = {}, {}
    with cwd(jdir):
        j["fom"] = jrun_fom.main(4.75, 0.02, **SMALL)
        j["prom"] = jrun_prom.main(*MU, num_modes=6, **SMALL)
        j["hprom"] = jrun_hprom.main(*MU, compute_ecsw=True, **HPROM)
        j["hprom_factored"] = jrun_hprom.main(*MU, engine="factored",
                                              **HPROM)
    shutil.copy(jdir / BASIS, tdir / BASIS)
    with cwd(tdir):
        t["fom"] = trun_fom.main(4.75, 0.02, **SMALL, device="cpu")
        t["prom"] = trun_prom.main(*MU, num_modes=6, **SMALL, device="cpu")
        t["prom_file"] = np.load(ROM_FILE)
        t["prom_pallas"] = trun_prom.main(*MU, num_modes=6, **SMALL,
                                          engine="pallas", device="cpu")
        t["prom_pallas_file"] = np.load(ROM_FILE)
        t["hprom"] = trun_hprom.main(*MU, compute_ecsw=True, **HPROM,
                                     device="cpu")
        t["hprom_file"] = np.load(HPROM_FILE)
        for engine in ("factored", "tensor", "pallas"):
            t[f"hprom_{engine}"] = trun_hprom.main(*MU, engine=engine,
                                                   **HPROM, device="cpu")
            t[f"hprom_{engine}_file"] = np.load(HPROM_FILE)
    return {"jax": (jdir, j), "torch": (tdir, t)}


def test_run_fom_matches_jax(runs):
    (jdir, j), (tdir, t) = runs["jax"], runs["torch"]
    want, got = np.load(jdir / FOM_FILE), np.load(tdir / FOM_FILE)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape == (2 * 144, 9)
    assert rel(got, want) <= 1e-12
    assert t["fom"][1] == j["fom"][1] == 0.0 and t["fom"][0] > 0


def test_run_prom_matches_jax(runs):
    (jdir, j), (tdir, t) = runs["jax"], runs["torch"]
    assert abs(t["prom"][1] - j["prom"][1]) <= 1e-6
    assert rel(t["prom_file"], np.load(jdir / ROM_FILE)) <= 1e-10
    # the port used the JAX basis as it found it
    np.testing.assert_array_equal(np.load(tdir / BASIS),
                                  np.load(jdir / BASIS))


def test_run_prom_pallas_engine(runs):
    """The streaming engine (f32, its plain version on the CPU) against
    the generic engine (f64) on the same basis."""
    t = runs["torch"][1]
    assert rel(t["prom_pallas_file"], t["prom_file"]) <= 1e-4
    assert abs(t["prom_pallas"][1] - t["prom"][1]) <= 1e-3


@pytest.mark.parametrize("engine", ["generic", "factored"])
def test_run_hprom_matches_jax(runs, engine):
    (jdir, j), (tdir, t) = runs["jax"], runs["torch"]
    w_j, w_t = np.load(jdir / WEIGHTS), np.load(tdir / WEIGHTS)
    assert int((w_t > 0).sum()) == int((w_j > 0).sum())
    assert rel(w_t, w_j) <= 1e-10
    key = "hprom" if engine == "generic" else "hprom_factored"
    assert abs(t[key][1] - j[key][1]) <= 1e-6
    if engine == "generic":
        assert rel(t["hprom_file"], np.load(jdir / HPROM_FILE)) <= 1e-10


@pytest.mark.parametrize("engine", ["tensor", "pallas"])
def test_run_hprom_other_engines(runs, engine):
    """The tensor engine (f64) and the sampled-system engine (f32) against
    the generic engine on the same weights."""
    t = runs["torch"][1]
    tol = 1e-10 if engine == "tensor" else 1e-4
    assert rel(t[f"hprom_{engine}_file"], t["hprom_file"]) <= tol
    assert abs(t[f"hprom_{engine}"][1] - t["hprom"][1]) <= 1e-3


def test_jax_runner_reads_port_artifacts(runs, tmp_path, monkeypatch):
    """A directory written by the port (its own basis from its own nine
    FOMs, its weights, its snapshot cache) drives the JAX runners to the
    port's numbers, and the port reads the JAX weights back."""
    monkeypatch.chdir(tmp_path)
    _, err_t = trun_prom.main(*MU, num_modes=6, load_basis=False, **SMALL,
                              device="cpu")
    _, herr_t = trun_hprom.main(*MU, compute_ecsw=True, **HPROM,
                                device="cpu")
    _, err_j = jrun_prom.main(*MU, num_modes=6, **SMALL)
    _, herr_j = jrun_hprom.main(*MU, **HPROM)
    assert abs(err_j - err_t) <= 1e-6
    assert abs(herr_j - herr_t) <= 1e-6
    (jdir, j), tdir = runs["jax"], runs["torch"][0]
    with cwd(tdir):     # the JAX basis, the JAX weights
        _, herr = trun_hprom.main(*MU, **HPROM,
                                  weights_path=str(jdir / WEIGHTS),
                                  device="cpu")
    assert abs(herr - j["hprom"][1]) <= 1e-6


@pytest.mark.parametrize("model", ["fom", "prom", "hprom"])
def test_run_sweep(runs, model, capsys):
    """Each model sweeps the 3x3 grid; every point with a cached FOM
    (the training point of the weights) is near it."""
    tdir = runs["torch"][0]
    with cwd(tdir):
        elapsed = trun_sweep.main(model=model, num_modes=6, **SMALL,
                                  device="cpu")
    out = capsys.readouterr().out
    assert elapsed > 0
    assert f"sweep: 9 points (9 padded) on 1 device(s), model={model}" \
        in out
    errs = [float(e) for e in re.findall(
        r"error vs the cached FOM ([\d.e+-]+)%", out)]
    assert errs and all(e < 5.0 for e in errs)


def test_base_parser_keeps_jax_flags():
    def flags(parser):
        return {s: a for a in parser._actions for s in a.option_strings}

    want, got = flags(jcommon.base_parser("x")), flags(
        tcommon.base_parser("x"))
    assert set(got) == (set(want) - {"--platform"}) | {"--device"}
    for name in set(got) & set(want):
        assert got[name].default == want[name].default, name
    assert got["--device"].default == "cuda"
    assert got["--device"].choices == ["cuda", "cpu"]
    ns = tcommon.base_parser("x").parse_args(["--device", "cpu", "--f32"])
    assert ns.device == "cpu" and ns.f32 and ns.mu1 == 5.19


@pytest.mark.parametrize("runner", ["run_fom", "run_prom", "run_hprom",
                                    "run_sweep"])
def test_runner_without_card_fails_at_once(runner, tmp_path, monkeypatch):
    """Without device="cpu" a runner asks for the card and, where there is
    none, raises before it computes or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    main = {"run_fom": trun_fom, "run_prom": trun_prom,
            "run_hprom": trun_hprom, "run_sweep": trun_sweep}[runner].main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(num_cells=12, num_steps=8)
    assert os.listdir(tmp_path) == []
