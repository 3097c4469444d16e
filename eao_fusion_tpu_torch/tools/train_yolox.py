"""Train the synthetic-scene YOLOX weights with the port (port of
`tools/train_yolox.py`, the same scenes and defaults).

    python -m eao_fusion_tpu_torch.tools.train_yolox [--steps 3000]
        [--width 0.25] [--batch 8] [--frames 24] [--out PATH]
        [--seed 0] [--device cuda] [--cache-dir DIR]

Renders the 12 training scenes and the held-out one (in parallel worker
processes, on the host), trains the width-0.25 variant
(frontend/yolox_train.py) on the device, evaluates box recall and class
accuracy on the held-out scene, and saves float16 weights in the npz
layout the online detector lane loads (`semantic_online=True`). Prints one
JSON line with the run's times and metrics last.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time

import numpy as np
import torch

# class_textures=True: objects carry their class's canonical texture, so
# class identity is learnable (random per-scene textures make the class
# labels noise)
TRAIN_SPECS = [  # (style, seed, n_objects, texture)
    ("arc", 0, 4, "blocky"), ("arc", 1, 6, "blocky"),
    ("arc", 2, 8, "blocky"), ("loop", 3, 6, "blocky"),
    ("loop", 4, 8, "aperiodic"), ("spin", 5, 6, "aperiodic"),
    ("arc", 6, 6, "aperiodic"), ("spin", 7, 8, "blocky"),
    ("loop", 8, 4, "blocky"), ("spin", 10, 4, "aperiodic"),
    ("arc", 11, 8, "aperiodic"), ("loop", 12, 6, "aperiodic"),
]
VAL_SPEC = ("arc", 9, 5, "blocky")


def render(spec, n_frames: int, cache_dir=None):
    """The class-textured sequence of one (style, seed, n_objects,
    texture) spec."""
    from eao_fusion_tpu_torch.io import synthetic
    style, seed, nobj, tex = spec
    return synthetic.generate_sequence(
        n_frames=n_frames, seed=seed, style=style, n_objects=nobj,
        texture=tex, class_textures=True, cache_dir=cache_dir)


def _render_job(job):
    return render(*job)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default="data/yolox_synth.npz")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights (the batch draws take "
                         "seed + 1)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir", default=None,
                    help="render cache of io/synthetic.generate_sequence")
    args = ap.parse_args(argv)

    from eao_fusion_tpu_torch import resolve_device
    from eao_fusion_tpu_torch.frontend import yolox, yolox_train

    device = resolve_device(None if args.device == "cuda" else args.device)
    specs = TRAIN_SPECS + [VAL_SPEC]
    t0 = time.perf_counter()
    jobs = [(spec, args.frames, args.cache_dir) for spec in specs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
        seqs = pool.map(_render_job, jobs)
    render_s = time.perf_counter() - t0
    print(f"rendered {len(seqs)} sequences of {args.frames} frames in "
          f"{render_s:.1f} s (host)", flush=True)

    params, metrics = yolox_train.train(
        seqs[:-1], seqs[-1], n_classes=8, width_mult=args.width,
        batch=args.batch, n_steps=args.steps, seed=args.seed, device=device,
        log=lambda m: print(m, flush=True))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    yolox.save_params(args.out, params, dtype=np.float16)
    result = {"device": str(device),
              "device_name": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
              "steps": args.steps, "batch": args.batch, "width": args.width,
              "seed": args.seed,
              "render_s": render_s, **metrics, "out": args.out,
              "out_mb": os.path.getsize(args.out) / 1e6}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
