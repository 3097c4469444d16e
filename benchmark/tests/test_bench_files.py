"""Every cell of BENCHMARK.json loads, and names only files that are
there: its configuration, traffic, workload and driver, a reader for each
per-layer metric, the numbers its limits name; each configuration builds
the port's SystemConfig."""

import importlib
import json

import pytest

from benchmark.harness import check, core

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
NUMBERS = {"feature_miss_pct", "desc_bits_pct", "plane_mismatch",
           "plane_gap", "pose_gap", "ba_gap", "object_mismatch",
           "object_gap", "object_spread_gap", "frozen_frames"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    c = core.load_cell(cell)
    importlib.import_module(f"benchmark.drivers.{c['traffic']['driver']}")
    for m in c["per_layer"]:
        mod = importlib.import_module(f"benchmark.metrics.{m['name']}")
        assert callable(mod.read)
    assert {m["name"] for m in c["end_to_end"]} == {"fps", "setup_s"}
    assert set(c["workload"]["limits"]) <= NUMBERS
    assert set(c["workload"]["capture"]) <= set(check.TARGETS)
    cfg = core.system_config(c["config"])
    cam = c["config"]["system"]["camera"]
    assert (cfg.camera.width, cfg.camera.fx) == (cam["width"], cam["fx"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    d = json.loads((core.ROOT / conf["file"]).read_text())
    assert d["name"] == conf["name"]
    assert d["reduced"] == conf["reduced"]
    for key in d["reduced"]:
        assert key in d, f"reduced key {key} is not described in the file"
    run = importlib.import_module("benchmark.run")
    core.system_config(run.rehearsal_config(d))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for m in BENCH["per_layer"]:
        assert m["moves"] == "fps"
        importlib.import_module(f"benchmark.metrics.{m['name']}")
    for k in ("pose_opt", "ba_edge_full", "ba_edge_chi2", "chol_solve"):
        mod = importlib.import_module(f"benchmark.costs.{k}")
        assert mod.TRACE_NAME.startswith(k)
