"""How long a stream takes to make, by part: the scene and its textures
on the host, the ray cast on the card, the boxes projected on the host,
as `harness/stream.py` makes them in a run's set-up.

    python3 benchmark/tools/stream_time.py --scene corridor \
        --trajectory corridor --frames 2000 \
        --camera 640 480 615.45 615.55 324.69 238.91 --seed 5

Prints one JSON line with the seconds of each part, the frames' bytes on
the device and the card's name and power limit. Not run by the
benchmark's own runs."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run as bench_run  # noqa: E402
from benchmark.gen import render_torch, synthetic as syn  # noqa: E402
from benchmark.harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", required=True)
    ap.add_argument("--trajectory", required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--camera", type=float, nargs=6, required=True,
                    metavar=("W", "H", "FX", "FY", "CX", "CY"))
    ap.add_argument("--layout-seed", type=int, default=0)
    ap.add_argument("--n-objects", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    w, h, fx, fy, cx, cy = args.camera
    cam = syn.Camera(int(w), int(h), fx, fy, cx, cy)
    torch.zeros(1, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t = [time.perf_counter()]
    mod = core.find_module("benchmark.gen.scenes", args.scene)
    scene = mod.make(args.layout_seed, args.n_objects, args.frames)
    perm = np.random.default_rng(args.seed).permutation(len(scene.textures))
    scene.textures = [scene.textures[j] for j in perm]
    tcw = mod.TRAJECTORIES[args.trajectory](args.frames)
    t.append(time.perf_counter())
    textures = render_torch.scene_textures(scene, dev)
    gray, depth = render_torch.render(scene, textures, cam, tcw)
    sync()
    t.append(time.perf_counter())
    boxes = [syn.project_boxes(scene, cam, p) for p in tcw]
    t.append(time.perf_counter())
    out = dict(scene=args.scene, trajectory=args.trajectory,
               frames=args.frames, camera=[cam.width, cam.height],
               rects=len(scene.rects), boxes=len(scene.boxes),
               textures=len(scene.textures),
               scene_s=t[1] - t[0], render_s=t[2] - t[1],
               boxes_s=t[3] - t[2], total_s=t[3] - t[0],
               frame_bytes=gray.nbytes + depth.nbytes,
               frames_with_boxes=sum(1 for b in boxes if len(b)),
               device=(bench_run.smi_line() if dev.type == "cuda"
                       else "cpu"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
