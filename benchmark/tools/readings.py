"""Readings for the limits of `correct` (PERF.md, "How correct is
decided"): runs a cell once for each seed, in this one process, and
prints for each a JSON line with the numbers the run compares
(`program`) and the control's (`control`): the same numbers, worked out
by the harness's own `check.numbers` once every captured answer of the
program has been replaced by the control's, the plain reference computed
in bfloat16 (its solves in float32). With `--harness-sees control` the
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import check  # noqa: E402
from benchmark.reference import features as rfeat  # noqa: E402
from benchmark.reference import local_ba, objects as robj  # noqa: E402
from benchmark.reference import planes as rplanes  # noqa: E402
from benchmark.reference import pose as rpose  # noqa: E402

BF16 = torch.bfloat16


def bf16(a: np.ndarray) -> np.ndarray:
    """`a` rounded to bfloat16, in its own dtype."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(BF16).float().numpy().astype(a.dtype)


def _features(it) -> dict:
    ref = rfeat.extract(it["img"].cpu().numpy(), it["p"], quant=bf16)
    out = {k: v.clone() for k, v in it["out"].items()}
    n = out["uv"].shape[0]
    sc = float(it["p"]["scale_factor"])
    uv = np.zeros((n, 2), np.float32)
    level = np.zeros(n, np.int32)
    packed = np.zeros((n, 8), np.int64)
    for i, ((l, y, x), (_, bits)) in enumerate(list(ref.items())[:n]):
        uv[i] = (x * sc ** l, y * sc ** l)
        level[i] = l
        packed[i] = (bits.reshape(8, 32).astype(np.int64)
                     << np.arange(32)).sum(1)
    packed = np.where(packed >= 2 ** 31, packed - 2 ** 32, packed)
    valid = np.arange(n) < len(ref)
    return dict(uv=torch.as_tensor(uv), level=torch.as_tensor(level),
                valid=torch.as_tensor(valid),
                desc_packed=torch.as_tensor(packed.astype(np.int32)))


def _planes(it) -> dict:
    ref = rplanes.segment(it["depth"].cpu().numpy(), it["cam"], it["p"],
                          quant=bf16)
    P = it["out"]["coeffs"].shape[0]
    B = int(it["p"]["max_boundary_points"])
    k = min(len(ref["n_inliers"]), P)
    coeffs = np.zeros((P, 4), np.float32)
    coeffs[:k] = ref["coeffs"][:k]
    n_in = np.zeros(P, np.int32)
    n_in[:k] = ref["n_inliers"][:k]
    bnd = np.zeros((P, B), bool)
    for j in range(k):
        bnd[j, :ref["n_boundary"][j]] = True
    return dict(coeffs=torch.as_tensor(coeffs), n_inliers=torch.as_tensor(
        n_in), valid=torch.as_tensor(np.arange(P) < k),
        boundary_valid=torch.as_tensor(bnd))


def _pose(it):
    o = it["obs"]
    return rpose.solve(it["pose0"], o[0], o[1], o[2], o[3], o[4],
                       it["planes"], it["cam"], it["p"], BF16).float()


def _local_ba(it):
    cams, _ = local_ba.solve(it["prob"], it["planes"], it["cam"], it["p"],
                             dtype=BF16, **it["kw"])
    return cams.float()


def _object(it) -> dict:
    ref = robj.update(*check.object_args(it), quant=bf16)
    return {k: torch.as_tensor(np.asarray(v)) for k, v in ref.items()}


# the control's answer to a captured call, in the program's form
CONTROL = dict(features=_features, planes=_planes, pose=_pose,
               local_ba=_local_ba, object=_object)


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
                it["out"] = CONTROL[kind](it)
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
