"""Guards of BENCHMARK.json and of the benchmark's sources (CPU)."""

import ast
import json
import os
import re
import time

import pytest

from gpubench.harness import HERE, ROOT, Bench, cell_metrics, run_cell
from gpubench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_the_allowed_characters():
    s = spec()
    names = [c["name"] for c in s["configs"]]
    for w in s["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    metrics = s["end_to_end"] + s["per_layer"]
    names += [m["name"] for m in metrics]
    for c in s["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in s[group]]
        assert len(got) == len(set(got)), group


def test_every_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    cells = {w["name"] for w in s["workloads"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        target = e2e[m["moves"]]
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert cell in target.get("workloads", [cell]), (m["name"], cell)
    for cell in cells:
        reported = [m["name"] for m in cell_metrics(s, cell, False)]
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert cell_metrics(s, cell, True), cell


def test_every_name_has_its_file():
    s = spec()
    b = Bench()
    for c in s["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in s["workloads"]:
        traffic = b.json("workloads", w["traffic"])
        b.path("drivers", traffic["driver"], ".py")
    for m in s["end_to_end"] + s["per_layer"]:
        assert hasattr(b.module("metrics", m["name"]), "read"), m["name"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(HERE):
        if os.sep + ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: finitedifference_tpu_torch is the
    port, finitedifference_tpu the JAX package."""
    found = set(_imports(path))
    assert not found & {"jax", "jaxlib", "flax", "finitedifference_tpu"}
    if os.sep + "reference" + os.sep in path:
        assert "finitedifference_tpu_torch" not in found
        assert found <= {"__future__", "math", "dataclasses", "hashlib",
                         "json", "os", "sys", "time", "typing", "numpy",
                         "scipy", "torch", "gpubench"}, found


def test_a_cell_written_to_another_directory_is_found_without_an_edit(
        tmp_path):
    """A configuration, a traffic mix and a metric reader that exist only
    in a temporary directory run through the harness."""
    s, bench = tiny.write(str(tmp_path))
    os.makedirs(tmp_path / "metrics")
    (tmp_path / "metrics" / "tiny.requests.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    s["end_to_end"].append({"name": "tiny.requests", "unit": "requests",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["tiny_exact"]})
    result, _ = run_cell(s, "tiny_exact", 7, 0.05, False, bench=bench,
                         device="cpu")
    assert result["correct"]
    assert result["metrics"]["tiny.requests"]["value"] == \
        result["attempted"] >= 1
    assert set(result["metrics"]) == {"fom_steps_per_s", "setup_s",
                                      "tiny.requests"}
    assert list(result)[-1] == "checks"


def test_the_offline_model_is_timed_apart_from_set_up(tmp_path):
    """The seconds a driver spends making or loading the benchmark's own
    inputs are reported as `inputs_s` and left out of `setup_s`."""
    s, bench = tiny.write(str(tmp_path))
    t0 = time.perf_counter()
    result, _ = run_cell(s, "tiny_hprom", 7, 0.05, False, bench=bench,
                         device="cpu", t_start=t0)
    assert result["correct"]
    assert result["inputs_s"] > 0
    assert 0 < result["metrics"]["setup_s"]["value"] \
        < time.perf_counter() - t0 - result["inputs_s"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny_exact", "tiny_hprom"])
def test_a_traced_run_checks_its_answers_and_names_its_gaps(tmp_path, cell):
    """A `--trace 1` run: the device pass, then one request under the
    host's profiler for the gaps; `correct` means the same as untraced."""
    s, bench = tiny.write(str(tmp_path))
    result, _ = run_cell(s, cell, 11, 0.05, True, bench=bench,
                         device="cpu")
    assert result["correct"]
    traffic = bench.json("workloads", cell)
    assert result["attempted"] == traffic["trace_requests"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0
