"""The benchmark's files: every cell, configuration, driver and metric that
BENCHMARK.json names is a file that loads, and new ones are found by name
without an edit."""

import json
import shutil
import time

import pytest

from sebench import harness

REPO = harness.ROOT.parent
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_cell_names_files_that_exist():
    for cell in SPEC["workloads"]:
        workload = harness.load_json(harness.ROOT / "workloads" / f"{cell['name']}.json")
        assert workload["config"] == cell["config"]
        assert workload["chips"] == cell["chips"]
        assert (harness.ROOT / "configs" / f"{workload['config']}.json").is_file()
        assert callable(harness.load_module("traffic", workload["driver"]).run)
        assert set(workload["limits"]) and all(v > 0 for v in workload["limits"].values())
    for config in SPEC["configs"]:
        assert harness.load_json(REPO / config["file"])["name"] == config["name"]


def test_every_metric_has_a_reader_and_its_cells_exist():
    cells = {c["name"] for c in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for cell in cells:
        assert harness.declared(SPEC["per_layer"], cell)
        assert len(harness.declared(SPEC["end_to_end"], cell)) >= 2


DRIVER = '''
def run(bench):
    bench.setup_done()
    bench.open_window()
    bench.close_window()
    bench.e2e["dummy_rate"] = 2.0 * bench.params["scale"]
    bench.counters["dummy"] = 0.5
    bench.attempted = 1
    bench.check("dummy_gap", 0.0, bench.workload["limits"]["dummy_gap"])
'''
READER = '''
def read(bench):
    return bench.counters["dummy"] * 100
'''


def test_new_cell_config_driver_and_metric_are_found_as_new_files(tmp_path):
    root = tmp_path / "sebench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("_build", "_cache"))
    (root / "configs" / "dummy-config.json").write_text(json.dumps({"name": "dummy-config"}))
    (root / "workloads" / "dummy-cell.json").write_text(json.dumps(
        {"name": "dummy-cell", "config": "dummy-config", "driver": "dummy_driver", "chips": 1,
         "why": "test", "params": {"scale": 3.0}, "limits": {"dummy_gap": 1e-3}}))
    (root / "traffic" / "dummy_driver.py").write_text(DRIVER)
    (root / "metrics" / "dummy_metric.x.py").write_text(READER)
    spec = dict(SPEC)
    spec["end_to_end"] = SPEC["end_to_end"] + [
        {"name": "dummy_rate", "unit": "1/s", "better": "higher", "bound": 0.01,
         "source": "host_clock", "workloads": ["dummy-cell"]}]
    spec["per_layer"] = SPEC["per_layer"] + [
        {"name": "dummy_metric.x", "unit": "%", "better": "higher", "source": "program_counter",
         "layer": "test", "moves": "dummy_rate", "workloads": ["dummy-cell"]}]
    spec_path = tmp_path / "BENCHMARK.json"
    spec_path.write_text(json.dumps(spec))
    for trace, want in ((False, {"dummy_rate": 6.0}), (True, {"dummy_metric.x": 50.0})):
        result = harness.run_cell("dummy-cell", 5, 1.0, trace, t0=time.perf_counter(),
                                  root=root, spec_path=spec_path, device="cpu")
        assert result["correct"] is True
        assert list(result)[-1] == "checks"
        got = {k: v["value"] for k, v in result["metrics"].items()}
        if not trace:
            assert got.pop("setup_s") > 0
        assert got == want


def test_a_run_without_the_cells_card_raises_no_card(monkeypatch):
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NoCard):
        harness.run_cell("cmgan-serve-batch", 1, 1.0, False, t0=time.perf_counter(),
                         spec_path=REPO / "BENCHMARK.json")
