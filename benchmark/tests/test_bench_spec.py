"""BENCHMARK.json and the files it names: each found by name, and a new
cell, traffic mix, configuration or metric found without editing the
harness."""

import json
import shutil

import pytest

import harness
from conftest import BENCH

ROOT = BENCH.parent
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_loads(cell):
    spec = harness.load_spec(cell, ROOT)
    assert spec.config["name"] == spec.cell["config"]
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    assert len(spec.end_to_end) >= 2 and spec.per_layer
    for m in spec.end_to_end + spec.per_layer:
        assert callable(spec.readers[m["name"]].read)
    cfg = harness.slam_config(spec.config["slam"])
    assert type(cfg).__name__ == "SlamConfig"


def test_every_file_is_under_paths_and_named():
    assert BENCHMARK["paths"] == ["benchmark"]
    for c in BENCHMARK["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in BENCHMARK["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_contract_shape():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                              "per_layer"}
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_a_new_cell_is_found_by_name(tmp_path):
    """Files and entries only: a traffic mix, limits, a metric and a cell."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads(json.dumps(BENCHMARK))
    b["workloads"].append({"name": "default-slow-street", "config": "os1-64-default", "traffic": "slow-street",
                           "chips": 1, "why": "a later cell"})
    b["per_layer"].append({"name": "later_metric", "unit": "ms", "better": "lower", "source": "host_clock",
                           "layer": "realtime host", "moves": "scan_latency_p95_ms",
                           "workloads": ["default-slow-street"]})
    b["end_to_end"][1]["workloads"].append("default-slow-street")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    t = json.loads((BENCH / "traffic" / "online-street.json").read_text())
    t["rate_hz"] = 5.0
    (tmp_path / "benchmark" / "traffic" / "slow-street.json").write_text(json.dumps(t))
    (tmp_path / "benchmark" / "limits" / "default-slow-street.json").write_text(
        (BENCH / "limits" / "default-online-street.json").read_text())
    (tmp_path / "benchmark" / "metrics" / "later_metric.py").write_text("def read(obs):\n    return 1.0\n")
    mod = harness.load_module(tmp_path / "benchmark" / "harness.py")
    spec = mod.load_spec("default-slow-street", tmp_path)
    assert spec.traffic["rate_hz"] == 5.0
    assert spec.readers["later_metric"].read({}) == 1.0
    assert {m["name"] for m in spec.end_to_end} == {"scan_latency_p95_ms", "setup_s"}


def test_no_jax_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    for name in ("open3d_slam_private_tpu_torch_extra", "jaxtyping", "open3d_slam_private_tpu_torch.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    base = harness.forbidden_modules()
    for name in ("jax", "jaxlib.xla_client", "flax", "open3d_slam_private_tpu.slam"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    got = set(harness.forbidden_modules()) - set(base)
    assert got == {"jax", "jaxlib.xla_client", "flax", "open3d_slam_private_tpu.slam"}
    assert not any(m.startswith(("open3d_slam_private_tpu_torch", "jaxtyping")) for m in base)
