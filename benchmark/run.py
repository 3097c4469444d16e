"""The benchmark of the PyTorch / CUDA port (`eao_fusion_tpu_torch`):
one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --rehearse        # on the CPU, at the configuration's small size

A run makes its stream from the seed on the card, builds the System, runs
the cell's traffic driver (`benchmark/drivers/<driver>.py`): set-up, then
a window of `--seconds`, and checks what the window produced against the
plain reference (`benchmark/harness/check.py`). Its last line on standard
output is one JSON object: `correct`, `attempted` (the window's frames),
`failed` (those under the tracker's own accept gate of inliers),
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones, each read by `benchmark/metrics/<metric>.py`), `device`,
and with `--trace 1` `breakdown`. Each number compared, beside its limit,
ends standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it
exits with 2 and prints no result; likewise if the port is missing, and
if JAX or the JAX package is loaded once the window has closed.
`--rehearse` runs the same path on the CPU at the configuration's
`rehearsal` size and prints a line that names no device metric.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's other tenants and the port's
# own threads spread the host-bound runs less (set before numpy loads)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from benchmark.harness import check, core  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at the configuration's rehearsal "
                         "size; no device metric")
    return ap.parse_args(argv)


def host_times() -> tuple:
    """(this process's CPU seconds, the host's steal seconds): the time
    the host's hypervisor ran other guests on this machine's cores, from
    /proc/stat where it is there."""
    steal = 0.0
    try:
        with open("/proc/stat") as fh:
            f = fh.readline().split()
        steal = int(f[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return time.process_time(), steal


class Hooks:
    """What the driver calls at the window's edges: the output capture,
    and in a traced run the profiler's span. The host's times over the
    window go to standard error, beside the window's length."""

    def __init__(self, capture, tracer):
        self.capture, self.tracer = capture, tracer
        self.tracing = tracer is not None

    def window_begin(self):
        self.capture.install()
        self.t0 = (time.perf_counter(),) + host_times()

    def window_end(self):
        t1 = (time.perf_counter(),) + host_times()
        self.capture.remove()
        wall, cpu, steal = (b - a for a, b in zip(self.t0, t1))
        core.log(f"host: {cpu:.3f} s of CPU in this process and {steal:.3f} "
                 f"s stolen from the host's cores over {wall:.3f} s")

    def trace_begin(self):
        self.tracer.begin()

    def trace_end(self, frames):
        self.tracer.end(frames)


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"
    return out[0] if out else "nvidia-smi: no output"


def rehearsal_config(conf: dict) -> dict:
    """The configuration at its `rehearsal` size: the camera scaled, the
    `system` overrides merged, a shorter stream."""
    r = conf["rehearsal"]
    conf = json.loads(json.dumps(conf))
    s = float(r["camera_scale"])
    cam = conf["system"]["camera"]
    for k in ("width", "height"):
        cam[k] = int(round(cam[k] * s))
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] = cam[k] * s
    for key, val in r.get("system", {}).items():
        if isinstance(val, dict):
            conf["system"].setdefault(key, {}).update(val)
        else:
            conf["system"][key] = val
    conf["stream"].update(r.get("stream", {}))
    return conf


def main(argv=None) -> int:
    args = parse_args(argv)
    core.set_environment()
    try:
        return _run(args)
    except core.BenchError as exc:
        core.log(f"benchmark: {exc}")
        return 2


def _run(args) -> int:
    c = core.load_cell(args.workload)
    conf, traffic, wl = c["config"], c["traffic"], c["workload"]
    import torch
    if args.rehearse:
        conf = rehearsal_config(conf)
        dev = torch.device("cpu")
        torch.set_num_threads(min(4, os.cpu_count() or 1))
    else:
        chips = int(c["cell"]["chips"])
        if not torch.cuda.is_available():
            raise core.BenchError("no CUDA device: the benchmark measures "
                                  "the port on the card")
        if torch.cuda.device_count() < chips:
            raise core.BenchError(f"the cell asks for {chips} cards, "
                                  f"{torch.cuda.device_count()} found")
        dev = torch.device("cuda", 0)
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        core.log(smi_line())
    try:
        from eao_fusion_tpu_torch.pipeline.system import System
    except ImportError as exc:
        raise core.BenchError(f"the port is not here: {exc}")
    from benchmark.harness import roofline, spans, stream as stream_mod, trace

    cfg = core.system_config(conf)
    stream = stream_mod.Stream(conf["stream"], conf["system"]["camera"],
                               args.seed, dev, cfg.objects.max_objects_2d)
    s = System(cfg, device=dev)
    tracer = None
    if args.trace and not args.rehearse:
        tracer = trace.Tracer(dev, roofline.launch_shapes)
        tracer.warm()
    plan = wl["capture"]
    if args.rehearse:
        # the rehearsal's short window draws among its own first calls
        w = int(conf["rehearsal"]["capture_within"])
        plan = {k: dict(v, within=min(int(v["within"]), w))
                for k, v in plan.items()}
    cap = check.Capture(plan, args.seed)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    run = driver.run(s, stream, traffic, conf, args.seconds,
                     Hooks(cap, tracer))
    setup_s = run["t_start"] - T_PROCESS
    fps = run["frames"] / run["window_s"]
    core.log(f"window: {run['frames']} frames in {run['window_s']:.3f} s, "
             f"{run['kf_inserted']} keyframes, events {run['events']}")

    # after the window: the peak, the GBA joined, the program's state freed
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    s._poll_gba(blocking=True)
    est = [t.copy() for t in s.trajectory]
    gate = cfg.tracking.min_matches_track
    failed = sum(1 for g in run["n_inliers"] if g < gate)
    truth = stream.tcw[[stream.index(k) for k in range(len(est))]]
    del s, stream
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    limits = wl["limits"]
    run = dict(run, gate=gate)
    checks, correct = check.verdict(
        check.numbers(cap, run, truth, est, limits), limits)

    loaded = core.forbidden_loaded()
    if loaded:
        raise core.BenchError("JAX or the JAX package is loaded: "
                              + ", ".join(loaded))

    if args.rehearse:
        core.log("rehearsal on the CPU: no device metric")
        for k, v in checks.items():
            core.log(f"{k} {v['value']} (limit {v['limit']})")
        print(json.dumps(dict(rehearsal=True, correct=correct,
                              attempted=run["frames"], failed=failed,
                              kf_inserted=run["kf_inserted"],
                              events=run["events"])))
        return 0

    if args.trace:
        record = spans.record()
        tracer.read(record)
        rec = dict(run, trace=tracer.summary, trace_frames=tracer.frames,
                   launches=tracer.launches, record=record)
        metrics = {}
        for m in c["per_layer"]:
            mod = importlib.import_module(f"benchmark.metrics.{m['name']}")
            val = mod.read(rec)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        summ = tracer.summary
        device = dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                      count=1, memory_peak_bytes=int(peak),
                      busy_s=summ["busy_s"], window_s=summ["window_s"])
        counts = {}
        for k, _ in tracer.launches:
            counts[k] = counts.get(k, 0) + 1
        core.log(f"traced span: {tracer.frames} frames, "
                 f"{summ['n_events']} device events, launches {counts}")
    else:
        values = dict(fps=("frames/s", fps), setup_s=("s", setup_s))
        metrics = {m["name"]: {"value": values[m["name"]][1],
                               "unit": values[m["name"]][0]}
                   for m in c["end_to_end"]}
        device = dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                      count=1, memory_peak_bytes=int(peak))
    result = dict(correct=correct, attempted=run["frames"], failed=failed,
                  metrics=metrics, device=device)
    if args.trace:
        result["breakdown"] = dict(device_ops=summ["device_ops"],
                                   idle_gaps=summ["idle_gaps"])
    for k, v in checks.items():
        core.log(f"{k} {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
