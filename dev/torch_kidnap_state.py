"""The state of the kidnap contract's full-width run (`chip_smoke.py`
phase 31b) at the end of the kidnap, for a replay of the return from it.

Runs 31b (`tests/torch_contracts.py`: `kidnap_cfg()`, the 640x480 seed-5
corridor with the renderer's boxes, 8 `process_frame` frames, then chunks
of 8 through `slam_chunk` and `chunk_epilogue`) up to the epilogue of the
kidnap's last chunk, and writes the System there with
`io/checkpoint.save_state` (a pending loop detection stays out of it:
the file holds the map, the track and object state, the trajectory) and
its generator's state beside it. Then it replays the return from that
file on a new System and prints each return frame's inliers and its
error from the truth after the pass alignment, as one JSON line.
`tests/test_torch_kidnap.py::test_kidnap_return_from_one_state` replays
the same file on the port's CPU and on the JAX System.

    python3 dev/torch_kidnap_state.py --out build/kidnap_state.npz
    python dev/torch_kidnap_state.py --device cpu --out build/k.npz

Runs on the card unless `--device cpu` is given. The port only: no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _contracts():
    spec = importlib.util.spec_from_file_location(
        "torch_contracts", os.path.join(ROOT, "tests", "torch_contracts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def kidnap_scale_sequence(C, cache_dir):
    """31b's workload: the full-width corridor, rendered in a pool."""
    from eao_fusion_tpu_torch.io import synthetic
    corridor = synthetic.render_sequences([C.CORRIDOR_SPEC],
                                          cache_dir=cache_dir)[0]
    return len(corridor.frames), C.kidnap_sequence(corridor,
                                                   back=C.BACK_SCALE)


def save_kidnap_state(C, seq, n_pass: int, path: str, device) -> None:
    """31b on `device` up to the epilogue of the kidnap's last chunk; the
    System there to `path` (and its generator's state to `path`'s
    `_gen.npy`)."""
    import numpy as np

    from eao_fusion_tpu_torch.io import checkpoint
    from eao_fusion_tpu_torch.pipeline.system import System
    s = System(C.kidnap_cfg(), device=device)
    for f in seq.frames[:C.CHUNK_WARM]:
        s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
    last = (n_pass + C.KIDNAP_FRAMES - C.CHUNK_WARM) // C.CHUNK - 1

    def on_chunk(ci, st):
        if ci == last:
            raise _Stop

    try:
        C.run_kidnap_chunks(s, seq, C.CHUNK_WARM, boxes=True,
                            on_chunk=on_chunk)
    except _Stop:
        pass
    poll = s._poll_gba
    s._poll_gba = lambda blocking=False: False   # keep the pending state
    try:
        checkpoint.save_state(path, s)
    finally:
        s._poll_gba = poll
        s.loop_closer.abort_gba()       # this run ends here
    np.save(path[:-4] + "_gen.npy", s.generator.get_state().numpy())


def replay_return(C, seq, n_pass: int, path: str, device) -> dict:
    """A new System on `device` restored from `save_kidnap_state`'s files
    drives the return in chunks: each return frame's inliers, error from
    the truth (cm, rad, after the pass alignment of the restored
    trajectory) and status; the chunks whose epilogue relocalized; whether
    the generator's state was carried (not from another device's)."""
    import numpy as np
    import torch

    from eao_fusion_tpu_torch.io import checkpoint
    from eao_fusion_tpu_torch.pipeline.system import System
    s = System(C.kidnap_cfg(), device=device)
    checkpoint.load_state(path, s)
    gen = torch.from_numpy(np.load(path[:-4] + "_gen.npy"))
    # a generator's state is of its device's kind: one saved on another
    # device is not carried, and the RANSAC draws differ
    carried = gen.numel() == s.generator.get_state().numel()
    if carried:
        s.generator.set_state(gen)
    lo = n_pass + C.KIDNAP_FRAMES
    align = C.pass_alignment(s, seq, n_pass)
    try:
        recs = C.run_kidnap_chunks(s, seq, lo, boxes=True)
    finally:
        s.loop_closer.abort_gba()
    gt = np.stack([f.tcw for f in seq.frames])
    rows = [dict(frame=f, n_inliers=int(n), lost=bool(lost),
                 error=[e * s_ for e, s_ in zip(
                     C.aligned_error(p, gt[f], align), (100.0, 1.0))])
            for r in recs for f, n, lost, p in zip(
                r["frames"], r["n_inliers"], r["lost"], r["poses"])]
    return {"frames": rows,
            "relocalized_chunks": [r["chunk"] for r in recs
                                   if r["relocalized"]],
            "generator_carried": carried, "device": str(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir",
                    default=os.path.join(ROOT, "build", "synth_cache"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    C = _contracts()
    n_pass, seq = kidnap_scale_sequence(C, args.cache_dir)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_kidnap_state(C, seq, n_pass, args.out, dev)
    out = replay_return(C, seq, n_pass, args.out, dev)
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
