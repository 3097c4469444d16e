"""What decides `correct`: the answers of the timed path, captured in the
window, against the plain reference (`benchmark/reference/`), worked out
once the window has closed.

Captured, for calls drawn from the seed among the window's first calls
of each kind that the workload file's `capture` names (the program's own
inputs and outputs, copied on the device when the call is drawn): a kind
is a module of `benchmark/checks/`, which names the program's function
that it wraps, the numbers it yields and how it works them out against
the reference (features, planes, pose, local_ba and object today). And,
for every frame of the window, the pose that `slam_chunk` reports, for
the one number that belongs to no kind:

  frozen_frames       window frames that passed the tracker's own gate of
                      inliers and report, bit for bit, the pose of the
                      frame before while the ground truth moved: a pose
                      that is not the frame's own answer

Each number is compared against the cell's limit (workloads/<cell>.json).
A limit that no kind of the capture yields, and that is not
frozen_frames, is an error when the cell loads. A number with nothing to
compare (no drawn call was reached) is missing, and a missing number is
not correct."""

from __future__ import annotations

import importlib
import pkgutil

import numpy as np
import torch

from .core import BenchError, find_module

KINDS = "benchmark.checks"
FROZEN = "frozen_frames"


def kind_modules(names) -> dict:
    """{kind: its module} of the kinds `names`."""
    return {k: find_module(KINDS, k) for k in names}


def all_kinds() -> dict:
    """{kind: its module} of every module of `benchmark/checks/`."""
    pkg = importlib.import_module(KINDS)
    return kind_modules(m.name for m in pkgutil.iter_modules(pkg.__path__)
                        if not m.name.startswith("_"))


def require(workload: dict) -> dict:
    """The kind modules of the workload's `capture`, once each of its
    limits is yielded by exactly one of them or is frozen_frames."""
    kinds = kind_modules(workload["capture"])
    by = {}
    for kind, mod in kinds.items():
        for name in mod.NUMBERS:
            if name in by or name == FROZEN:
                raise BenchError(f"number {name!r} of kind {kind!r} is "
                                 f"also {by.get(name, FROZEN)!r}'s")
            by[name] = kind
    missing = sorted(set(workload["limits"]) - set(by) - {FROZEN})
    if missing:
        raise BenchError(f"limits {missing} are yielded by no kind of the "
                         f"capture {sorted(kinds)} and are not {FROZEN}")
    return kinds


class Capture:
    """Wraps the program's functions of the kinds named in `plan` ({kind:
    {"samples": n, "within": R}}) while installed, and keeps the inputs
    and outputs of the calls whose index (counted per kind from
    installation) was drawn from the seed: n of the first R."""

    def __init__(self, plan: dict, seed: int):
        rng = np.random.default_rng([int(seed), 17])
        self.kinds = kind_modules(plan)
        self.draws = {}
        for kind, spec in plan.items():
            R, n = int(spec["within"]), int(spec["samples"])
            self.draws[kind] = set(
                rng.choice(R, size=min(n, R), replace=False).tolist())
        self.calls = {k: 0 for k in plan}
        self.items = {k: [] for k in plan}
        self._saved = []

    def _take(self, kind) -> bool:
        i = self.calls[kind]
        self.calls[kind] += 1
        return i in self.draws[kind]

    def install(self) -> None:
        for kind, kmod in self.kinds.items():
            mod_name, attr = kmod.TARGET
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, kmod.wrap(
                orig, lambda kind=kind: self._take(kind),
                self.items[kind].append))

    def remove(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []


def frozen_frames(est, truth, first: int, n_inliers, gate: int):
    """Window frames (trajectory rows first, first + 1, ...; `n_inliers`
    theirs) that passed `gate` and repeat the previous frame's pose
    exactly while the truth moved."""
    count = 0
    for j, n_in in enumerate(n_inliers):
        t = first + j
        if (t > 0 and n_in >= gate and np.array_equal(est[t], est[t - 1])
                and not np.array_equal(truth[t], truth[t - 1])):
            count += 1
    return float(count)


def numbers(cap: Capture, run: dict, truth: np.ndarray,
            est: np.ndarray, names) -> dict:
    """{name: value or None} of the numbers in `names`: each captured
    kind that yields one of them works out all of its own."""
    out = {}
    with torch.no_grad():
        for kind, mod in cap.kinds.items():
            if set(mod.NUMBERS) & set(names):
                out.update(mod.numbers(cap.items[kind]))
    if FROZEN in names:
        out[FROZEN] = frozen_frames(est, truth, run["traj0"],
                                    run["n_inliers"], run["gate"])
    return out


def verdict(nums: dict, limits: dict):
    """({name: {"value", "limit"}}, correct) of the numbers `limits`
    names: correct where each is there and within its limit."""
    checks = {k: {"value": nums.get(k), "limit": v}
              for k, v in limits.items()}
    return checks, all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values())
