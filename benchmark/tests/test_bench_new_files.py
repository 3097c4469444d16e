"""A scene, a trajectory and a kind of check that the harness has never
named are used from new files alone: `probe_scene.py` (the room with the
tour run backwards) and `probe_kind.py` (the quaternion norm of the poses
that drawn chunks report), both in this package, named by their whole
module names in a configuration and a workload file of a checkout made
for the test. A run at the rehearsal size on the CPU renders the probe's
stream, captures the probe kind, and prints the probe's number in its
verdict (about a minute); a limit that no kind yields refuses the cell
when it loads, and so does a kind that no module brings."""

import json
import os
import shutil

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import check, core
from benchmark.harness.stream import Stream

CELL = "fr3_office.chunked"
SEED = 2026101801
SCENE = "benchmark.tests.probe_scene"
KIND = "benchmark.tests.probe_kind"
NUMBER = "probe_quat_norm_gap"


def _checkout(tmp_path, monkeypatch, stream=None, capture=None,
              limits=None):
    """A checkout of the cell's files under `tmp_path`, the configuration's
    stream and the workload's capture and limits updated, and the harness
    pointed at it."""
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((core.ROOT / bench["configs"][0]["file"]).read_text())
    conf["stream"].update(stream or {})
    work = json.loads((core.BENCH / "workloads" / f"{CELL}.json")
                      .read_text())
    work["capture"].update(capture or {})
    work["limits"].update(limits or {})
    files = {"BENCHMARK.json": bench,
             bench["configs"][0]["file"]: conf,
             f"benchmark/workloads/{CELL}.json": work}
    for rel, data in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(json.dumps(data))
    shutil.copytree(core.BENCH / "traffic", tmp_path / "benchmark/traffic")
    monkeypatch.setattr(core, "ROOT", tmp_path)
    monkeypatch.setattr(core, "BENCH", tmp_path / "benchmark")
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "TORCHINDUCTOR_CACHE_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, os.environ.get(var, ""))


def test_new_scene_and_trajectory_from_a_new_file():
    cam = dict(width=40, height=30, fx=535.4 / 16, fy=539.2 / 16,
               cx=320.1 / 16, cy=247.6 / 16)
    spec = dict(layout_seed=0, frames=12, n_objects=4)
    back = Stream(dict(spec, scene=SCENE, trajectory="tour_backwards"),
                  cam, 5, torch.device("cpu"), 8)
    fwd = Stream(dict(spec, scene="room", trajectory="tour"), cam, 5,
                 torch.device("cpu"), 8)
    assert torch.equal(back.gray, fwd.gray.flip(0))
    assert torch.equal(back.depth, fwd.depth.flip(0))


def test_a_limit_that_no_kind_yields_is_refused_at_load(tmp_path,
                                                        monkeypatch):
    work = dict(capture={KIND: dict(samples=1, within=2)},
                limits={NUMBER: 1e-4, check.FROZEN: 0})
    assert set(check.require(work)) == {KIND}
    work["limits"]["no_kind_yields_this"] = 0
    with pytest.raises(core.BenchError, match="no_kind_yields_this"):
        check.require(work)
    with pytest.raises(core.BenchError, match="no module"):
        check.require(dict(capture={"benchmark.tests.no_such_kind": {}},
                           limits={}))
    _checkout(tmp_path, monkeypatch, limits={"no_kind_yields_this": 0})
    with pytest.raises(core.BenchError, match="no_kind_yields_this"):
        core.load_cell(CELL)
    assert bench_run.main(["--workload", CELL, "--seed", "1", "--seconds",
                           "1", "--rehearse"]) == 2


def test_new_kind_and_scene_in_a_run(tmp_path, monkeypatch, capsys):
    # the probe draws the window's first chunk: an 8 s window on a loaded
    # CPU may hold no more than two
    _checkout(tmp_path, monkeypatch,
              stream=dict(scene=SCENE, trajectory="tour_backwards"),
              capture={KIND: dict(samples=1, within=1)},
              limits={NUMBER: 1e-4})
    assert bench_run.main(["--workload", CELL, "--seed", str(SEED),
                           "--seconds", "8", "--rehearse"]) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert f"({SCENE}, tour_backwards)" in err
    line = [ln for ln in err.splitlines() if ln.startswith(NUMBER + " ")]
    assert len(line) == 1 and line[0].endswith("(limit 0.0001)")
    assert float(line[0].split()[1]) <= 1e-4
    assert result["correct"] is True, err[-3000:]
