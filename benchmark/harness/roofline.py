"""Roofline shares of the port's kernels over a traced span: the least
time the chip could take for the launches recorded there (each from its
shapes, by `benchmark/costs/<kernel>.py`) over the device time the trace
gives the same kernels."""

from __future__ import annotations

import importlib
import re

from . import peaks

_costs = {}


def cost_module(kernel: str):
    """`benchmark/costs/<kernel>.py`, or None where there is none."""
    if kernel not in _costs:
        try:
            _costs[kernel] = importlib.import_module(
                f"benchmark.costs.{kernel}")
        except ModuleNotFoundError:
            _costs[kernel] = None
    return _costs[kernel]


def launch_shapes(kernel: str, args):
    mod = cost_module(kernel)
    return None if mod is None else mod.shapes(args)


def is_kernel(event_name: str, kernel_name: str) -> bool:
    """Whether a trace event is the kernel: its name holds the kernel's
    as a whole word ("(anonymous namespace)::pose_opt_kernel(...)",
    "void ...::ba_edge_chi2_kernel<true>(...)")."""
    return re.search(rf"(^|[^A-Za-z0-9_]){kernel_name}([^A-Za-z0-9_]|$)",
                     event_name) is not None


def share_pct(run: dict, kernels) -> float:
    """100 × Σ bound / Σ device time of `kernels` in the traced span, or
    None where they did not run there or a launch's shapes are unknown."""
    trace = run.get("trace")
    if not trace:
        return None
    bound, n_launch = 0.0, 0
    for kernel, sh in run["launches"]:
        if kernel not in kernels:
            continue
        mod = cost_module(kernel)
        if mod is None or sh is None:
            return None
        bound += peaks.bound_s(*mod.cost(sh))
        n_launch += 1
    names = [cost_module(k).TRACE_NAME for k in kernels
             if cost_module(k) is not None]
    dev_s = sum(t for n, t in trace["by_name"].items()
                if any(is_kernel(n, k) for k in names))
    if not n_launch or dev_s <= 0:
        return None
    return 100.0 * bound / dev_s
