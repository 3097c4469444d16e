"""Every cell of BENCHMARK.json loads, and names only files that are
there: its configuration, its scene and trajectory, traffic, workload and
driver, a reader for each per-layer metric, the kinds of check its
capture names (`benchmark/checks/`), each limit yielded by one of those
kinds or frozen_frames; each configuration builds the port's
SystemConfig. Every kind module declares what the harness asks of it."""

import importlib
import json

import pytest

from benchmark.harness import check, core

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
KINDS = check.all_kinds()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    c = core.load_cell(cell)
    importlib.import_module(f"benchmark.drivers.{c['traffic']['driver']}")
    for m in c["per_layer"]:
        mod = importlib.import_module(f"benchmark.metrics.{m['name']}")
        assert callable(mod.read)
    assert {m["name"] for m in c["end_to_end"]} == {"fps", "setup_s"}
    kinds = check.kind_modules(c["workload"]["capture"])
    yielded = {n for mod in kinds.values() for n in mod.NUMBERS}
    for limit in c["workload"]["limits"]:
        assert limit in yielded or limit == check.FROZEN, limit
    stream = c["config"]["stream"]
    scene = core.find_module("benchmark.gen.scenes", stream["scene"])
    assert callable(scene.make)
    assert stream["trajectory"] in scene.TRAJECTORIES
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


def test_kind_modules():
    assert KINDS
    seen = {check.FROZEN}
    for kind, mod in KINDS.items():
        mod_name, attr = mod.TARGET
        assert mod_name.startswith("eao_fusion_tpu_torch.") and attr, kind
        assert mod.NUMBERS and not seen & set(mod.NUMBERS), kind
        seen |= set(mod.NUMBERS)
        for fn in (mod.wrap, mod.numbers, mod.control):
            assert callable(fn), kind
        # nothing drawn: every number of the kind is there, and missing
        assert mod.numbers([]) == dict.fromkeys(mod.NUMBERS), kind
