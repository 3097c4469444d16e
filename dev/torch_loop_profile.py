"""Where the time of loop closing goes on the card: the loop cell of
`chip_smoke.py` (phase 12: `tum_fr3_config(use_objects=False)`, th_depth
70, the 144-frame seed-11 spin15 sequence), then, on the final map, one
essential-graph optimization and one GBA stage of a single LM iteration,
each timed on the host clock (synchronized) and traced by the profiler.

    python3 dev/torch_loop_profile.py

Prints one JSON line per step: host ms, device ms (the sum of the traced
device events), the number of device events, and the ten kernels with the
most device time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def traced(name, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()                                   # warm (handles, workspaces)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per = {}
    for e in ev:
        per[e.name] = per.get(e.name, 0.0) + e.device_time_total
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "step": name, "host_ms": host_ms,
        "device_ms": sum(e.device_time_total for e in ev) / 1e3,
        "device_events": len(ev),
        "top_kernels_us": [[k[:80], round(v, 1)] for k, v in top]}),
        flush=True)


def main() -> int:
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.io import synthetic
    from eao_fusion_tpu_torch.pipeline.system import System

    base = tum_fr3_config(use_objects=False)
    cfg = base.replace(camera=dataclasses.replace(base.camera,
                                                  th_depth=70.0))
    seq = synthetic.generate_sequence(n_frames=144, seed=11, style="spin15",
                                      texture="aperiodic", camera=cfg.camera)
    s = System(cfg)
    for f in seq.frames:
        s.process_frame(f.gray, f.depth, f.timestamp)
    s._poll_gba(blocking=True)
    lc, m = s.loop_closer, s.map
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "keyframes": int(m.kf_valid.sum()),
                      "points": int(m.pt_valid.sum()),
                      "loops_closed": s.n_loops_closed,
                      "loop_edges": lc.loop_edges}), flush=True)
    cand, cur = lc.loop_edges[0] if lc.loop_edges else (0, int(m.next_kf) - 1)
    traced("essential_graph", lambda: lc._essential_graph(
        m, cur, cand, m.kf_pose, []))
    prob, plane_free = lc._build_gba_problem(m)
    traced("gba_one_lm_iteration", lambda: lc._gba_stage(prob, plane_free,
                                                          1, 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
