"""Readings for the limits of `correct` (PERF.md, "How correct is
decided"): runs a cell once for each seed, in this one process, and
prints for each a JSON line with the numbers the run compares
(`program`) and the control's (`control`): the same numbers, worked out
by the harness's own `check.numbers` once every captured answer of the
program has been replaced by the control's, the plain reference computed
in bfloat16 (its solves in float32), which each kind's module gives
(`benchmark/checks/<kind>.py` `control`). With `--harness-sees control` the
run itself is judged on the control's numbers, and `correct` is what
the harness then printed. With `--fault`, a fault is planted in the
program first (see FAULTS), and the numbers are the faulty program's.

    python3 benchmark/tools/readings.py --workload fr3_office.chunked \
        --seconds 10 --seeds 11 12 13 [--fault half]

Not run by the benchmark's own runs."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import check  # noqa: E402


def plant(fault: str, setattr_=setattr) -> None:
    """Break the timed path underneath, as FAULTS describes (`setattr_`
    replaces the program's function; a test passes its monkeypatch's)."""
    from eao_fusion_tpu_torch.frontend import extractor
    from eao_fusion_tpu_torch.ops import planes
    from eao_fusion_tpu_torch.pipeline import steady
    from eao_fusion_tpu_torch.solvers import ba, pose_opt
    if fault == "unchanged":
        def slam_chunk(st, grays, depths, boxes, timestamps, *, cfg, **kw):
            T = grays.shape[0]
            z = torch.zeros(T, dtype=torch.int32, device=grays.device)
            return st._replace(frame_id=st.frame_id + T), dict(
                n_inliers=z, kf_inserted=torch.zeros(T, dtype=torch.bool),
                kf_trigger=z, pose=st.ts.pose[None].expand(T, 7).clone())
        setattr_(steady, "slam_chunk", slam_chunk)
    elif fault == "half":
        step = steady.slam_step
        last = {}

        def slam_step(st, gray, depth, boxes, timestamp, *, cfg, **kw):
            if st.frame_id % 2 and "diag" in last:
                return st._replace(frame_id=st.frame_id + 1), last["diag"]
            st, diag = step(st, gray, depth, boxes, timestamp, cfg=cfg, **kw)
            last["diag"] = diag
            return st, diag
        setattr_(steady, "slam_step", slam_step)
    elif fault == "pose_altered":
        solve = pose_opt.optimize_pose

        def optimize_pose(*a, **kw):
            r = solve(*a, **kw)
            pose = r.pose.clone()
            pose[4] += 1e-3
            return r._replace(pose=pose)
        setattr_(pose_opt, "optimize_pose", optimize_pose)
    elif fault == "ba_altered":
        solve = ba.bundle_adjust_coo

        def bundle_adjust_coo(*a, **kw):
            r = solve(*a, **kw)
            cams = r.cam_pose.clone()
            cams[:, 4] += 1e-3
            return r._replace(cam_pose=cams)
        setattr_(ba, "bundle_adjust_coo", bundle_adjust_coo)
    elif fault == "descriptors_altered":
        extract = extractor.extract_features

        def extract_features(*a, **kw):
            f = extract(*a, **kw)
            return f._replace(desc_packed=f.desc_packed ^ 1)
        setattr_(extractor, "extract_features", extract_features)
    elif fault == "planes_altered":
        segment = planes.segment_planes

        def segment_planes(*a, **kw):
            fp = segment(*a, **kw)
            coeffs = fp.coeffs.clone()
            coeffs[:, 3] += 1e-3
            return fp._replace(coeffs=coeffs)
        setattr_(planes, "segment_planes", segment_planes)
    else:
        raise ValueError(fault)


FAULTS = {
    "unchanged": "slam_chunk returns its carry unchanged (no frame runs)",
    "half": "slam_step leaves out every other frame, reporting the last "
            "frame's pose for it",
    "pose_altered": "every pose solve's answer moved 1 mm",
    "ba_altered": "every local BA's cameras moved 1 mm",
    "descriptors_altered": "every descriptor's first bit flipped",
    "planes_altered": "every plane's offset moved 1 mm",
}


def read(workload: str, seed: int, seconds: float, rehearse: bool = False,
         with_control: bool = True, harness_sees: str = "program") -> dict:
    """One run of the cell: its compared numbers (`program`), the
    control's beside them unless `with_control` is off, and the `correct`
    that the harness printed, judged on the numbers `harness_sees`."""
    numbers, rec = check.numbers, {}

    def both(cap, run, truth, est, names):
        prog = numbers(cap, run, truth, est, names)
        rec.update(program=prog, frames=run["frames"],
                   fps=run["frames"] / run["window_s"],
                   samples={k: len(v) for k, v in cap.items.items()})
        if not with_control:
            return prog
        for kind, items in cap.items.items():
            for it in items:
                it["out"] = cap.kinds[kind].control(it)
        rec["control"] = numbers(cap, run, truth, est, names)
        return rec["control"] if harness_sees == "control" else prog
    check.numbers = both
    out = io.StringIO()
    try:
        argv = ["--workload", workload, "--seed", str(seed),
                "--seconds", str(seconds)] + (["--rehearse"] if rehearse
                                              else [])
        with contextlib.redirect_stdout(out):
            rec["rc"] = bench_run.main(argv)
    finally:
        check.numbers = numbers
    lines = out.getvalue().strip().splitlines()
    if lines:
        rec["correct"] = json.loads(lines[-1])["correct"]
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--harness-sees", choices=("program", "control"),
                    default="program")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    if args.fault:
        plant(args.fault)
    for seed in args.seeds:
        rec = read(args.workload, seed, args.seconds, args.rehearse,
                   with_control=not args.fault,
                   harness_sees=args.harness_sees)
        print(json.dumps(dict(seed=seed, fault=args.fault, **rec),
                         default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
