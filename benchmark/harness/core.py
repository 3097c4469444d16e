"""Plumbing shared by the benchmark's runs: the files a cell is built
from (found by the names in BENCHMARK.json), the modules its files name
(scenes, kinds of check), the run's environment, the port's configuration
from a configuration file, and the check that nothing of JAX or of the
JAX package was loaded."""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
# whole top-level module names that a run may not hold once its window
# has closed (the port's own name begins with the last one)
FORBIDDEN = ("jax", "jaxlib", "flax", "eao_fusion_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result: no card, a missing file, a stream
    used up. The harness prints it and exits with a code other than 0."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    if not path.exists():
        raise BenchError(f"missing file {path.relative_to(ROOT)}")
    with open(path) as fh:
        return json.load(fh)


def find_module(package: str, name: str):
    """The module `name` of `package`, or, where `name` holds a dot, the
    module of that whole name: a file names what it uses, and a new file
    brings it."""
    full = name if "." in name else f"{package}.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as exc:
        if exc.name and (full + ".").startswith(exc.name + "."):
            raise BenchError(f"no module {full} for {name!r}") from exc
        raise


def load_cell(name: str) -> dict:
    """BENCHMARK.json's entry for cell `name` with its configuration,
    traffic and workload files, once each limit of the workload is
    yielded by a kind that its `capture` names (`check.require`)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(ROOT / configs[cell["config"]]["file"])
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    from .check import require
    require(workload)
    return dict(
        bench=bench, cell=cell, config=conf,
        traffic=load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        workload=workload,
        end_to_end=[m for m in bench["end_to_end"]
                    if name in m.get("workloads", [name])],
        per_layer=[m for m in bench["per_layer"]
                   if name in m.get("workloads", [name])])


def set_environment() -> None:
    """Every build or kernel cache the program could write goes to a fixed
    directory inside the checkout (the port builds its kernels into
    build/kernels/ by itself)."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"


def system_config(conf: dict, overrides: dict = None):
    """The port's SystemConfig: its defaults with the configuration file's
    `system` section (a dict for a nested group replaces those fields of
    it), then `overrides` in the same form."""
    from eao_fusion_tpu_torch.config import SystemConfig
    cfg = SystemConfig()
    for section in (conf.get("system", {}), overrides or {}):
        for key, val in section.items():
            cur = getattr(cfg, key)
            if isinstance(val, dict):
                val = dataclasses.replace(cur, **val)
            cfg = cfg.replace(**{key: val})
    return cfg


def forbidden_loaded() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)
