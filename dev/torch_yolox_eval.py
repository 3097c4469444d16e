"""Box recall and class accuracy of YOLOX weight files with the port
(`eao_fusion_tpu_torch.frontend.yolox_train.evaluate`) on two sets:

  * held-out: all 24 frames of the trainer's validation scene
    (`tools/train_yolox.py` VAL_SPEC, arc seed 9, 5 objects), the numbers
    `train_yolox` prints at its end;
  * training world: frames 0, 4, ..., 20 of the class-textured seed-0 arc,
    the set of tests/test_yolox_train.py:80-109 (bounds >= 0.6, >= 0.8).

    python dev/torch_yolox_eval.py WEIGHTS.npz [...] [--device cpu]

Recall and class accuracy are the same on the card and the CPU
(`chip_smoke.py` phase 18 holds them equal), so the CPU serves here.
Prints one JSON line per weight file.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from eao_fusion_tpu_torch.frontend import yolox, yolox_train  # noqa: E402
from eao_fusion_tpu_torch.tools.train_yolox import VAL_SPEC, render  # noqa

TEST_FRAMES = (0, 4, 8, 12, 16, 20)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("weights", nargs="+")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir", default=None)
    args = ap.parse_args()
    val = render(VAL_SPEC, 24, args.cache_dir)
    world = render(("arc", 0, 4, "blocky"), 24, args.cache_dir)
    sets = {"held_out": val.frames,
            "training_world": [world.frames[i] for i in TEST_FRAMES]}
    for path in args.weights:
        params = yolox.load_params(path, args.device)
        dm, nc = yolox.infer_arch(params)
        out = {"weights": path}
        for name, frames in sets.items():
            out[name] = yolox_train.evaluate(params, dm, nc,
                                             [f.gray for f in frames],
                                             [f.boxes for f in frames])
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
