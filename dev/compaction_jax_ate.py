"""The JAX reference's corrected ATE on the keyframe-compaction cell of
`chip_smoke.py` (phase 8), written to `dev/compaction_jax_ate.json`.

    JAX_PLATFORMS=cpu python dev/compaction_jax_ate.py

The configuration is the phase's: `tum_fr3_config(use_objects=False,
use_loop_closing=False)` at full width (640x480, 1024 keypoint slots,
16384 points), a 12-slot keyframe table with a 12-keyframe local-BA
window, and a keyframe allowed every frame; the frames are the 24-frame
seed-0 arc (the renderer's cache is used where present). The drift of
this cell is the reference's own (ROADMAP queue 3), so `chip_smoke.py`
holds the port to this ATE plus a margin rather than to a fixed bound.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

N_FRAMES = 24
SEED = 0


def main() -> int:
    from eao_fusion_tpu.config import tum_fr3_config
    from eao_fusion_tpu.io import synthetic, tum
    from eao_fusion_tpu.pipeline.system import System

    base = tum_fr3_config(use_objects=False, use_loop_closing=False)
    cfg = dataclasses.replace(
        base,
        capacity=dataclasses.replace(base.capacity, max_keyframes=12,
                                     max_local_ba_kfs=12),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kf=1))
    seq = synthetic.generate_sequence(n_frames=N_FRAMES, seed=SEED,
                                      style="arc", camera=cfg.camera,
                                      cache_dir=synthetic.DEFAULT_CACHE)
    s = System(cfg)
    t0 = time.time()
    for f in seq.frames:
        s.process_frame(f.gray, f.depth, f.timestamp)
    corr = tum.evaluate_ate_rpe(s.trajectory_tcw(corrected=True),
                                seq.gt_tcw())
    raw = tum.evaluate_ate_rpe(s.trajectory_tcw(), seq.gt_tcw())
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=HERE,
                                capture_output=True, text=True,
                                check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    out = {
        "what": "JAX System, chip_smoke.py phase 8 (keyframe compaction)",
        "corrected_ate_cm": corr.ate_rmse * 100.0,
        "raw_ate_cm": raw.ate_rmse * 100.0,
        "keyframes": s.n_keyframes,
        "kf_compactions": s.n_kf_compactions,
        "resets": s.n_resets,
        "frames": N_FRAMES, "seed": SEED, "style": "arc",
        "config": {"preset": "tum_fr3_config(use_objects=False, "
                             "use_loop_closing=False)",
                   "max_keyframes": 12, "max_local_ba_kfs": 12,
                   "max_frames_between_kf": 1,
                   "max_keypoints": cfg.orb.max_keypoints,
                   "max_points": cfg.capacity.max_points,
                   "use_planes": cfg.use_planes},
        "backend": "jax cpu",
        "commit": commit,
        "seconds": round(time.time() - t0, 1),
    }
    path = os.path.join(HERE, "compaction_jax_ate.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
