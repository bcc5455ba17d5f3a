"""The port's regression drivers, derivative checks and entry step beside
the JAX package's, on the CPU.

- run_tests / run_tests_hprom at 12^2, 8 steps, in a fresh directory,
  every point a `python -m finitedifference_tpu_torch.runners.<runner>
  --device cpu` process: the JAX drivers' models, test points and keys,
  a finite [seconds, error %] for each, the FOM's error 0; a second call
  skips every key and leaves the file as it was (tests/test_runners.py's
  test_tests_driver). run_with_retry and run_point_subproc give up with
  (None, None), as JAX's do.
- check_derivatives: the same closures and verdicts as JAX's (every one
  OK) for two kernels; the global RBF's, kNN RBF's and GP's fitted
  slopes within 0.05 of JAX's (measured 5.7e-5 at most: the same fits
  on the same data, the finite differences' rounding apart), the RNM's
  from another draw of its init, so only its verdict.
- entry(): the 250^2 float32 Newton step of __graft_entry__.entry (one
  step takes ~0.2 s here, JAX's ~1.4 s with its compile), the same
  example and the same state after the step to 1e-6 relative (measured
  1.9e-8: float32 sums in another order).
"""

import contextlib
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

from finitedifference_tpu_torch.runners import check_derivatives as tcheck
from finitedifference_tpu_torch.runners import common as tcommon
from finitedifference_tpu_torch.runners import run_tests as trt
from finitedifference_tpu_torch.runners import run_tests_hprom as trth

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "runners"))
import check_derivatives as jcheck  # noqa: E402
import run_tests as jrt  # noqa: E402
import run_tests_hprom as jrth  # noqa: E402

SMALL = dict(num_cells=12, num_steps=8, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads only spin, and
    their load slows the tests that share the machine. One thread for the
    module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quiet(fn, *args, **kw):
    """fn(*args, **kw) and its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args, **kw)
    return ret, buf.getvalue()


def test_driver_maps_are_jax():
    assert [tuple(m) for m in trt.TEST_POINTS] == \
        [tuple(m) for m in jrt.TEST_POINTS]
    assert trt.SCRIPT_BY_MODEL == jrt.SCRIPT_BY_MODEL
    assert trth.SCRIPT_BY_MODEL == jrth.SCRIPT_BY_MODEL
    for name in ("run_tests", "run_tests_hprom"):
        modules = {script for script, _ in
                   getattr(sys.modules[f"finitedifference_tpu_torch.runners."
                                       f"{name}"], "SCRIPT_BY_MODEL").values()}
        for script in modules:
            __import__("finitedifference_tpu_torch.runners."
                       + script[:-len(".py")])


@pytest.mark.parametrize("driver", ["run_tests", "run_tests_hprom"])
def test_driver_accumulates_and_skips(driver, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    main, model, jmain = {
        "run_tests": (trt.main, "prom", jrt),
        "run_tests_hprom": (trth.main, "hprom", jrth)}[driver]
    out = f"{driver}.npz"
    results, log = quiet(main, models=(model,), out=out, retries=0,
                         **SMALL)
    keys = {f"{model}_{m1}_{m2}" for m1, m2 in jmain.TEST_POINTS}
    if driver == "run_tests":
        keys |= {f"fom_{m1}_{m2}" for m1, m2 in jmain.TEST_POINTS}
    assert set(results) == keys, log
    for key, value in results.items():
        assert value.shape == (2,) and np.all(np.isfinite(value))
        assert value[0] > 0
        if key.startswith("fom_"):
            assert value[1] == 0.0
        else:
            assert 0 <= value[1] < 5.0
    on_disk = dict(np.load(out))
    assert set(on_disk) == keys
    again, log = quiet(main, models=(model,), out=out, retries=0, **SMALL)
    assert sorted(line for line in log.splitlines()
                  if line.startswith("skipping")) == sorted(
        f"skipping {k} (done)" for k in keys if not k.startswith("fom_"))
    assert "===" not in log
    for key in keys:
        np.testing.assert_array_equal(again[key], results[key])
        np.testing.assert_array_equal(np.load(out)[key], on_disk[key])


def test_failed_points_give_none(tmp_path, monkeypatch):
    """A runner that fails (an unknown flag) and a point function that
    raises: (None, None) after retries + 1 attempts."""
    monkeypatch.chdir(tmp_path)
    got, log = quiet(tcommon.run_point_subproc, "run_fom.py", (4.75, 0.02),
                     ("--no-such-flag",), retries=1, backoff_s=0.0)
    assert got == (None, None)
    assert "attempt 1 failed" in log and "attempt 2 failed" in log
    calls = []

    def flaky(mu):
        calls.append(mu)
        if len(calls) < 3:
            raise RuntimeError("worker lost")
        return 1.0, 2.0

    assert quiet(tcommon.run_with_retry, flaky, (1, 2), retries=2,
                 backoff_s=0.0)[0] == (1.0, 2.0)
    calls.clear()
    assert quiet(tcommon.run_with_retry, flaky, (1, 2), retries=1,
                 backoff_s=0.0)[0] == (None, None)
    assert len(calls) == 2


@pytest.mark.parametrize("kernel", ["gaussian", "imq"])
def test_check_derivatives_gives_jax_verdicts(kernel):
    want = jcheck.main(kernel=kernel, verbose=False)
    got, log = quiet(tcheck.main, kernel=kernel, device="cpu")
    assert list(got) == list(want)
    for name, (slope, min_err, ok) in got.items():
        assert ok and want[name][2], (name, slope, min_err, want[name])
        if name != "rnm":
            assert abs(slope - want[name][0]) <= 0.05, name
        assert f"{name:24s} slope=" in log


def test_entry_matches_jax():
    import __graft_entry__

    from finitedifference_tpu_torch.entry import entry

    jstep, jargs = __graft_entry__.entry()
    want = np.asarray(jax.jit(jstep)(*jargs))
    step, args = entry(device="cpu")
    for a, b in zip(args, jargs):
        assert a.dtype == torch.float32 and str(b.dtype) == "float32"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = step(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-6
