"""Where two runs of the port's main path part: the default RGBD
configuration with planes on (objects and loop closing off, as
`chip_smoke.py` phase 7) on the 20-frame seed-0 arc, on the card.

    python3 dev/torch_determinism.py               # two runs in one process
    python3 dev/torch_determinism.py --processes 2 # one run in each of two

In one process, each per-frame stage is first called twice on the same
input (feature extraction, plane segmentation) and its outputs compared bit
for bit; then two Systems run the frames in lockstep, and after every frame
the pose and every map tensor of one are compared with the other's. With
`--processes N`, N fresh interpreters each run one System and report, for
every frame, a digest of the pose and of each map tensor, the kernel
launch counts and the ATE; the digests are compared. Either way the script
prints one JSON line: where the runs part (the first frame and the map
fields), or null, and whether the launch counts and the ATE bits agree.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def _same(a, b):
    """Names of the tensor fields of two NamedTuples (or tensors) that
    differ in any bit."""
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else ["tensor"]
    return [k for k, v in a._asdict().items()
            if isinstance(v, torch.Tensor) and not torch.equal(v, getattr(b, k))]


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().cpu().numpy()
                        .tobytes()).hexdigest()


def _setup():
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.io import synthetic
    cfg = tum_fr3_config(use_objects=False, use_loop_closing=False)
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      camera=cfg.camera)
    return cfg, seq


def in_process() -> dict:
    from eao_fusion_tpu_torch.frontend import extractor
    from eao_fusion_tpu_torch.ops import planes as plane_ops
    from eao_fusion_tpu_torch.pipeline.system import System

    dev = torch.device("cuda")
    cfg, seq = _setup()
    stages = {}
    for f in seq.frames[:4]:
        g = torch.as_tensor(f.gray, dtype=torch.float32, device=dev)
        d = torch.as_tensor(f.depth, dtype=torch.float32, device=dev)
        for name, fn in (
                ("extract_features", lambda: extractor.extract_features(
                    g, d, orb_cfg=cfg.orb, cam_cfg=cfg.camera)),
                ("segment_planes", lambda: plane_ops.segment_planes(
                    d, cam=cfg.camera, cfg=cfg.planes))):
            diff = _same(fn(), fn())
            if diff:
                stages.setdefault(name, sorted(set(diff)))

    a, b = System(cfg), System(cfg)
    first = None
    for i, f in enumerate(seq.frames):
        pa = a.process_frame(f.gray, f.depth, f.timestamp)
        pb = b.process_frame(f.gray, f.depth, f.timestamp)
        fields = _same(a.map, b.map)
        if first is None and (fields or (pa != pb).any()):
            first = {"frame": i, "pose_differs": bool((pa != pb).any()),
                     "map_fields": fields,
                     "keyframes": [a.n_keyframes, b.n_keyframes]}
    return {"stages_differing_on_repeat": stages, "first_parting": first,
            "ate_bits_equal": bool(
                (a.trajectory_tcw() == b.trajectory_tcw()).all())}


def one_run() -> dict:
    """One System over the arc: per-frame digests of the pose and of every
    map tensor, the launch counts of the run and its ATE."""
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.io import tum
    from eao_fusion_tpu_torch.pipeline.system import System

    cfg, seq = _setup()
    s = System(cfg)
    kernels.reset_launches()
    frames = []
    for f in seq.frames:
        pose = s.process_frame(f.gray, f.depth, f.timestamp)
        frames.append({"pose": hashlib.sha1(pose.tobytes()).hexdigest(),
                       "map": {k: _digest(v) for k, v in s.map._asdict().items()
                               if isinstance(v, torch.Tensor)}})
    traj = s.trajectory_tcw()
    err = tum.evaluate_ate_rpe(traj, seq.gt_tcw())
    return {"frames": frames, "launches": dict(kernels.launches),
            "keyframes": s.n_keyframes, "ate_cm": err.ate_rmse * 100.0,
            "trajectory": hashlib.sha1(traj.tobytes()).hexdigest()}


def across_processes(n: int) -> dict:
    runs = []
    for _ in range(n):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one-run"], check=True, capture_output=True,
                             text=True).stdout
        runs.append(json.loads(out.strip().splitlines()[-1]))
    a = runs[0]
    first = None
    for r in runs[1:]:
        for i, (fa, fr) in enumerate(zip(a["frames"], r["frames"])):
            fields = sorted(k for k in fa["map"] if fa["map"][k] != fr["map"][k])
            if fields or fa["pose"] != fr["pose"]:
                if first is None or i < first["frame"]:
                    first = {"frame": i, "pose_differs": fa["pose"] != fr["pose"],
                             "map_fields": fields}
                break
    return {"processes": n, "first_parting": first,
            "launches": [r["launches"] for r in runs],
            "launches_equal": all(r["launches"] == a["launches"] for r in runs),
            "keyframes": [r["keyframes"] for r in runs],
            "ate_cm": [r["ate_cm"] for r in runs],
            "ate_bits_equal": all(r["trajectory"] == a["trajectory"]
                                  for r in runs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=0,
                    help="compare one run in each of this many processes")
    ap.add_argument("--one-run", action="store_true",
                    help="run once and print the digests (used by "
                         "--processes)")
    args = ap.parse_args()
    if args.one_run:
        print(json.dumps(one_run()))
        return 0
    out = across_processes(args.processes) if args.processes else in_process()
    print(json.dumps({"device": torch.cuda.get_device_name(0), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
