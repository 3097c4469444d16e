"""Run-to-run determinism of the fr3-scale production run on one card:
the 2-lap workload of `chip_smoke.py` phase 30
(`dev/torch_run_fr3_scale.run_scale`, the JAX script's configuration,
chunks of 8) twice in this process and once in each of `--processes`
fresh processes. For every chunk each run keeps a digest of its raw poses
and, after the epilogue, of every map field, the loop closer's bow table,
the object table and the track state, its event counters, its GBA
launches and whether a GBA is in flight (`run_scale`'s `ChunkLog`).
Prints, for every run against the first, the first chunk at which they
part, the fields that part there, the GBA launch and merge chunks before
it and what was in flight; then one JSON line (the card's `nvidia-smi`
name and power limit in it). `--endurance` first runs the endurance
contract's input (`chip_smoke.py` phase 25a: the tour's first 506 frames
into 24 keyframe slots, loop closing on, no GBA) twice in this process
through `process_frame`, comparing every frame's pose and map digests.
`--deterministic` runs everything under
`torch.use_deterministic_algorithms(True, warn_only=True)` (with the
cuBLAS workspace setting it needs): the operations that have a
deterministic form take it, and each call site of one that has none is
printed once, for telling an order-dependent operation from thread
timing.

    python3 dev/torch_fr3_determinism.py [--laps 2] [--in-process 2]
        [--processes 2] [--endurance] [--out FILE]
    python dev/torch_fr3_determinism.py --device cpu --laps 1 \\
        --lap-frames 60 --processes 1

Runs on the card unless `--device cpu` is given; without a card it
raises. The port only: no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _module(*parts):
    """A module of this repository loaded from its file (dev/ and tests/
    are not packages; a `tests` package installed elsewhere would shadow
    the repository's)."""
    path = os.path.join(ROOT, *parts)
    name = "_det_" + os.path.splitext(parts[-1])[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _module("dev", "torch_run_fr3_scale.py")


def one_run(seq, laps: int, chunk: int, device) -> dict:
    """One `run_scale` on a new System: its record (the ATE, the event
    log) and its chunk rows."""
    from eao_fusion_tpu_torch.mapping.map_state import MapState
    from eao_fusion_tpu_torch.pipeline.system import System
    s = System(R.scale_cfg(), device=device)
    rows = R.ChunkLog(s, MapState._fields)

    def hook(ci, st, diag):
        rows(ci, st, diag)
        extra = rows.rows[-1]["map"]
        if s.loop_closer is not None:
            extra["bow"] = R.digest(s.loop_closer.bow)
        extra["objects"] = R.digest(*st.objs)
        extra["track"] = R.digest(*(x for x in st.ts if hasattr(x, "shape")))
    t0 = time.perf_counter()
    out = R.run_scale(s, seq, laps, chunk, on_chunk=hook)
    keep = ("ate_cm", "ate_corrected_cm", "lap_ate_cm", "events",
            "kf_gt_err_cm")
    return dict({k: out[k] for k in keep}, wall_s=time.perf_counter() - t0,
                first_gba_launch=rows.first_gba_launch(), rows=rows.rows)


def compare(a: dict, b: dict) -> dict:
    """Where run `b` first parts from run `a`: the chunk, the fields that
    differ there (`pose` for the raw poses, `counters` for the event
    counts), and the GBA state up to it."""
    first, fields = None, []
    for ra, rb in zip(a["rows"], b["rows"]):
        diff = [k for k in ra["map"] if ra["map"][k] != rb["map"].get(k)]
        if ra["pose"] != rb["pose"]:
            diff.insert(0, "pose")
        if ra["counters"] != rb["counters"]:
            diff.append("counters")
        if diff:
            first, fields = ra["chunk"], diff
            break
    out = dict(first_parting_chunk=first, fields=fields,
               first_gba_launch=(a["first_gba_launch"],
                                 b["first_gba_launch"]),
               ate_cm=(a["ate_cm"], b["ate_cm"]))
    if first is not None:
        ra, rb = a["rows"][first], b["rows"][first]
        prev = [r for r in a["rows"][:first + 1] if r["gba_launches"]]
        out.update(
            gba_launched_before=[r["chunk"] for r in prev],
            gba_inflight_at=(ra["gba_inflight"], rb["gba_inflight"]),
            gba_inflight_before=(
                a["rows"][first - 1]["gba_inflight"] if first else False,
                b["rows"][first - 1]["gba_inflight"] if first else False),
            counters_at=(ra["counters"], rb["counters"]),
            counter_names=list(R.ChunkLog.COUNTERS))
    return out


def endurance_twice(tour, device) -> dict:
    """The endurance contract's input twice through `process_frame`: the
    first frame at which the two runs' poses or map digests part."""
    from eao_fusion_tpu_torch.io import tum
    from eao_fusion_tpu_torch.pipeline.system import System
    C = _module("tests", "torch_contracts.py")
    seq = C.endurance_sequence(tour)
    runs = []
    for _ in range(2):
        s = System(C.endurance_cfg(), device=device)
        frames, t0 = [], time.perf_counter()
        for f in seq.frames:
            pose = s.process_frame(f.gray, f.depth, f.timestamp)
            m = s.map
            frames.append((R.digest(pose),
                           R.digest(m.kf_pose, m.kf_valid, m.pt_xyz,
                                    m.pt_valid)))
        err = tum.evaluate_ate_rpe(s.trajectory_tcw(corrected=True),
                                   C._gt(seq))
        runs.append(dict(frames=frames, wall_s=time.perf_counter() - t0,
                         ate_corrected_cm=float(err.ate_rmse) * 100,
                         loops=int(s.n_loops_closed),
                         gba_merges=int(s.n_gba_merges)))
    part = next((i for i, (x, y) in enumerate(zip(runs[0]["frames"],
                                                   runs[1]["frames"]))
                 if x != y), None)
    return dict(frames=len(seq.frames), first_parting_frame=part,
                parting_in=(None if part is None else
                            [n for n, x, y in zip(("pose", "map"),
                                                  runs[0]["frames"][part],
                                                  runs[1]["frames"][part])
                             if x != y]),
                **{f"run{i}": {k: v for k, v in r.items() if k != "frames"}
                   for i, r in enumerate(runs)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--laps", type=int, default=2)
    ap.add_argument("--lap-frames", type=int, default=625)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--in-process", type=int, default=2)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--endurance", action="store_true")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir",
                    default=os.path.join(ROOT, "build", "synth_cache"))
    ap.add_argument("--out", default=None,
                    help="write every run's chunk rows here (JSON)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, ROOT)
    import torch
    if args.deterministic:
        import warnings
        warnings.simplefilter("default")
        torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain PyTorch path on the CPU")
    t0 = time.perf_counter()
    seq = R.render_tour(args.lap_frames, args.cache_dir)
    if args.child:
        with open(args.child, "w") as fh:
            json.dump(one_run(seq, args.laps, args.chunk, dev), fh)
        return 0

    smi_line = None
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        smi_line = smi[0] if smi else "nvidia-smi: no output"
        log(smi_line)
    log(f"[{time.perf_counter() - t0:.1f}s] tour ready")
    summary = dict(nvidia_smi=smi_line, laps=args.laps,
                   lap_frames=args.lap_frames,
                   deterministic=args.deterministic)
    if args.endurance:
        summary["endurance"] = endurance_twice(seq, dev)
        log(f"[{time.perf_counter() - t0:.1f}s] endurance: "
            + json.dumps(summary["endurance"]))

    runs = []
    for i in range(args.in_process):
        runs.append(dict(one_run(seq, args.laps, args.chunk, dev),
                         where=f"in-process {i}"))
        log(f"[{time.perf_counter() - t0:.1f}s] {runs[-1]['where']}: ATE "
            f"{runs[-1]['ate_cm']:.3f} cm, events {runs[-1]['events']}")
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.processes):
            path = os.path.join(tmp, f"run{i}.json")
            cmd = [sys.executable, os.path.abspath(__file__), "--child",
                   path, "--laps", str(args.laps), "--lap-frames",
                   str(args.lap_frames), "--chunk", str(args.chunk),
                   "--device", args.device, "--cache-dir", args.cache_dir]
            if args.deterministic:
                cmd.append("--deterministic")
            subprocess.run(cmd, check=True)
            with open(path) as fh:
                runs.append(dict(json.load(fh), where=f"process {i}"))
            log(f"[{time.perf_counter() - t0:.1f}s] {runs[-1]['where']}: "
                f"ATE {runs[-1]['ate_cm']:.3f} cm, events "
                f"{runs[-1]['events']}")
    summary["runs"] = [{k: v for k, v in r.items() if k != "rows"}
                       for r in runs]
    summary["against_first"] = [dict(compare(runs[0], r), run=r["where"])
                                for r in runs[1:]]
    for c in summary["against_first"]:
        log(f"{c['run']} against {runs[0]['where']}: " + json.dumps(c))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(summary, rows=[r["rows"] for r in runs]), fh)
    summary["wall_s"] = time.perf_counter() - t0
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
