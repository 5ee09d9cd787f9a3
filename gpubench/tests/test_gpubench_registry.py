"""Every part of the benchmark is found by its name, and a configuration, a
cell and a per-layer metric are added by files and entries alone."""

import json
import shutil
import time

import pytest

from gpubench.harness import cell, spec

BENCH = spec.benchmark()


def test_every_entry_has_its_files():
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert spec.load_json(spec.ROOT / c["file"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        data = spec.workload(w["name"])
        assert data["config"] == w["config"] and data["traffic"] == w["traffic"]
        assert data["config_file"]["name"] == w["config"]
        assert hasattr(spec.driver(data["driver"]), "Driver")
        assert data["limits"], "a cell compares at least one number"
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_every_file_is_an_entry():
    names = {kind: {e["name"] for e in BENCH[kind]} for kind in ("configs", "workloads", "per_layer")}
    assert {p.stem for p in (spec.BENCH_DIR / "configs").glob("*.json")} == names["configs"]
    assert {p.stem for p in (spec.BENCH_DIR / "workloads").glob("*.json")} == names["workloads"]
    assert {p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py")} == names["per_layer"]
    drivers = {spec.workload(w)["driver"] for w in names["workloads"]}
    assert {p.stem for p in (spec.BENCH_DIR / "traffic").glob("*.py")} - {"__init__"} == drivers


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"] if spec.applies(m, w["name"])]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(spec.applies(m, w["name"]) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", [b["name"] for b in BENCH["workloads"]]):
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert spec.applies(moved, w), (m["name"], w)


DUMMY_METRIC = '''
def read(run):
    return float(run.record["window_s"])
'''


@pytest.fixture
def added(tmp_path, monkeypatch):
    """A copy of the benchmark with a new configuration (the flagship at 64x96
    with its DINOv2 branch at 28x42), a new cell on it (the closed-loop driver
    with other parameters) and a new per-layer metric, as files and
    BENCHMARK.json entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    config = spec.load_json(spec.BENCH_DIR / "configs" / "flagship.json")
    config.update(name="flagship_small",
                  sets=config["sets"] + ["framework.input_size=[64,96]",
                                         "framework.native_size=[60,80]"])
    config["reference_kwargs"].update(dinov2_image_size=[28, 42])
    (root / "gpubench/configs/flagship_small.json").write_text(json.dumps(config))
    cell_file = spec.workload("flagship.serve.c16")
    del cell_file["config_file"]
    cell_file.update(config="flagship_small", traffic="serve.c3")
    cell_file["params"].update(clients=3, frames=4, warmup_s=0.2, sample_per_client=1)
    (root / "gpubench/workloads/flagship_small.serve.c3.json").write_text(json.dumps(cell_file))
    (root / "gpubench/metrics/window_s.dummy.py").write_text(DUMMY_METRIC)
    bench["configs"].append({"name": "flagship_small", "source": "https://example.org/flagship",
                             "file": "gpubench/configs/flagship_small.json", "reduced": [],
                             "why": "a test's"})
    bench["workloads"].append({"name": "flagship_small.serve.c3", "config": "flagship_small",
                               "traffic": "serve.c3", "chips": 1, "why": "a test's"})
    bench["per_layer"].append({"name": "window_s.dummy", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "device", "moves": "serve_fps",
                               "workloads": ["flagship_small.serve.c3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "BENCH_DIR", root / "gpubench")
    monkeypatch.setattr(spec, "ROOT", root)
    return root


def test_an_added_entry_is_found_and_runs(added):
    bench = spec.benchmark()
    assert spec.workload("flagship_small.serve.c3")["config_file"]["name"] == "flagship_small"
    metrics = [m["name"] for m in spec.metrics_for(bench, "flagship_small.serve.c3", "per_layer")]
    assert "window_s.dummy" in metrics
    assert "window_s.dummy" not in [m["name"] for m in spec.metrics_for(
        bench, "flagship.serve.c16", "per_layer")]
    outcome = cell.run_cell("flagship_small.serve.c3", 2**33 + 5, 5.0, False, "cpu",
                            time.time_ns(), {"model_kwargs": {"dinov2_image_size": (28, 42)}})
    try:
        assert outcome.correct, outcome.numbers
        assert spec.metric_reader("window_s.dummy").read(outcome.run) >= 5.0
        assert outcome.driver.attempted > 0 and outcome.e2e["serve_fps"] > 0
    finally:
        outcome.close()
