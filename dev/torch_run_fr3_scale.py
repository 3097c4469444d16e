"""The fr3_long_office-scale production run (the JAX package's
`dev/run_fr3_scale.py`) on the PyTorch / CUDA port: 2-4 replayed laps of
the closed 625-frame seed-0 `tour` (one full 360-degree lap; frame 624 is
frame 0's pose), planes, objects (the renderer's boxes as offline boxes)
and loop closing on, production tables (256 keyframe and 16384 point
slots, 1024 keypoint slots, 640x480), in the steady chunked mode:
`process_frame` on 12 frames, then `steady.slam_chunk` and
`System.chunk_epilogue` over chunks of 8, the last partial chunk dropped.

Prints one JSON line with the JAX script's keys, computed as it computes
them (sustained fps over every chunk but the first, per-frame ms
percentiles, peak table occupancy, lifetime keyframe insertions, loops,
GBA merges and aborts, compactions, evictions, relocalizations, the ATE of
the raw per-chunk poses), but `prewarm_s`: the port compiles no program
ahead of its first frame (its kernels build at first use), so it has no
prewarm and no `--no-prewarm`. Added: the ATE of the corrected
trajectory and of each lap's raw poses on their own, how far the live
keyframes lie from their ground truth and how many corrected frames lie
over 50 cm from their raw pose, the resets, the chunk index of every
loop closure, GBA merge and abort, compaction, eviction, relocalization,
chunk that ended LOST and chunk after which more keyframes lay over 50
cm from their ground truth, the kernel launches of the chunked part, the
peak device memory and the card's `nvidia-smi` name and power limit.
A keyframe compaction drops no pending loop detection here:
`chunk_epilogue` harvests it before it compacts.

    python3 dev/torch_run_fr3_scale.py [--laps 4] [--chunk 8]
    python dev/torch_run_fr3_scale.py --device cpu --laps 1 --lap-frames 120

Runs on the card unless `--device cpu` is given; without a card it
raises. The lap renders in a pool of 8 processes into `--cache-dir`
(about a minute on 8 cores; the CPU needs minutes a lap to track it).
`run_scale` is the loop alone, for callers that bring their own System
and sequence (`chip_smoke.py` phase 30, tests/test_torch_fr3_scale.py).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

N_WARM = 12
# the System counters whose increments the event log records, by chunk
EVENT_COUNTERS = {"loop": "n_loops_closed", "gba_merge": "n_gba_merges",
                  "kf_compaction": "n_kf_compactions",
                  "pt_compaction": "n_pt_compactions",
                  "kf_eviction": "n_kf_evictions",
                  "relocalization": "n_relocalizations"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def scale_cfg(use_planes: bool = True, use_objects: bool = True):
    """The JAX script's configuration: the default SystemConfig (the TUM
    fr3 camera, production tables, loop closing on)."""
    from eao_fusion_tpu_torch.config import SystemConfig
    return SystemConfig(use_planes=use_planes, use_objects=use_objects)


def render_tour(lap_frames: int = 625, cache_dir=None, workers: int = 8):
    """The seed-0 tour, one lap, rendered in a pool of spawned processes
    (frame i bit for bit `generate_sequence`'s)."""
    from eao_fusion_tpu_torch.io import synthetic
    return synthetic.render_sequences(
        [dict(n_frames=lap_frames, seed=0, style="tour")], workers=workers,
        cache_dir=cache_dir)[0]


def _pad_boxes(b, n: int) -> np.ndarray:
    out = np.zeros((n, 6), np.float32)
    if b is not None and len(b):
        out[:min(len(b), n)] = b[:n]
    return out


def digest(*arrays) -> str:
    """A short hash of the arrays' bytes (tensors are read to the host)."""
    import hashlib
    h = hashlib.sha1()
    for a in arrays:
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


class ChunkLog:
    """A `run_scale` `on_chunk` hook that keeps, for every chunk, a digest
    of its raw poses and of the map fields `fields` after the epilogue,
    the System's event counters, the GBA launches of the epilogue and
    whether a GBA is in flight after it. Wraps System `s`'s loop closer
    to count the launches."""

    COUNTERS = ("n_loops_closed", "n_gba_merges", "n_kf_compactions",
                "n_pt_compactions", "n_kf_evictions", "n_relocalizations")

    def __init__(self, s, fields=()):
        self.s, self.fields, self.rows = s, tuple(fields), []
        self._launched = 0
        lc = s.loop_closer
        if lc is not None:
            launch = lc.launch_gba_async

            def counted(m):
                self._launched += 1
                return launch(m)
            lc.launch_gba_async = counted

    def __call__(self, ci: int, st, diag: dict) -> None:
        lc = self.s.loop_closer
        self.rows.append(dict(
            chunk=ci, pose=digest(diag["pose"]),
            map={f: digest(getattr(st.m, f)) for f in self.fields},
            counters=[int(getattr(self.s, c)) for c in self.COUNTERS],
            gba_launches=self._launched,
            gba_inflight=bool(lc is not None and lc.gba_inflight())))
        self._launched = 0

    def first_gba_launch(self):
        """The chunk whose epilogue launched the first GBA, or None."""
        return next((r["chunk"] for r in self.rows if r["gba_launches"]),
                    None)

    def pose_digest(self, last=None) -> str:
        """One digest of the raw pose digests of chunks 0..`last` (all
        chunks if None)."""
        import hashlib
        return hashlib.sha1("".join(
            r["pose"] for r in self.rows
            if last is None or r["chunk"] <= last).encode()).hexdigest()[:16]


def run_scale(s, seq, laps: int, chunk: int, progress=None,
              on_chunk=None) -> dict:
    """Drive System `s` (new) over `laps` replays of `seq`'s frames as the
    JAX script does: `process_frame` on the first 12 at timestamps k / 30,
    then chunks of `chunk` frames at (lo + j) / 30 through `slam_chunk`,
    `record_chunk` and `chunk_epilogue`, the last partial chunk dropped.
    Each unique frame goes to the device once; a chunk is a stack of the
    staged frames. The launch counts are set to 0 just before the first
    chunk. `progress(msg)` gets a line every 40 chunks; `on_chunk(index,
    carry, diagnostics)` is called after every chunk's epilogue (a
    `ChunkLog`, for instance). Returns the JAX
    script's record (but `prewarm_s`) and the readings named in the
    module's docstring."""
    import torch

    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.io import tum
    from eao_fusion_tpu_torch.ops import lie
    from eao_fusion_tpu_torch.pipeline import steady, tracking
    cfg, dev = s.cfg, s.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    lap_frames = len(seq.frames)
    order = list(range(lap_frames)) * laps
    n_total = len(order)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for k in range(N_WARM):
        f = seq.frames[order[k]]
        s.process_frame(f.gray, f.depth, timestamp=k / 30.0, boxes=f.boxes)

    n_box = cfg.objects.max_objects_2d
    staged = {}

    def stage(idxs):
        for i in idxs:
            if i not in staged:
                f = seq.frames[i]
                staged[i] = tuple(torch.as_tensor(a, device=dev) for a in (
                    f.gray, f.depth, _pad_boxes(f.boxes, n_box)))
        return tuple(torch.stack([staged[i][j] for i in idxs])
                     for j in range(3))

    lc = s.loop_closer

    def counters():
        c = {k: getattr(s, v) for k, v in EVENT_COUNTERS.items()}
        c["gba_abort"] = lc.stats.get("n_gba_aborts", 0) if lc else 0
        return c

    def centres(tcw):
        return lie.se3_inverse(torch.as_tensor(tcw).cpu())[:, 4:].numpy()

    def kf_gt_err(m):
        """Each live keyframe's centre against its frame's ground truth
        (cm, unaligned)."""
        kv = m.kf_valid
        gt = np.stack([seq.frames[order[f]].tcw
                       for f in m.kf_frame_id[kv].tolist()])
        return np.linalg.norm(centres(m.kf_pose[kv]) - centres(gt),
                              axis=1) * 100

    # "kf_far": the chunks after which more live keyframes lie over 50 cm
    # from their ground truth than before
    events = {k: [] for k in list(EVENT_COUNTERS) + ["gba_abort",
                                                      "lost_chunk", "kf_far"]}
    n_far = 0
    st = steady.init_steady_state(s)
    lifetime_kf = s.n_keyframes
    reloc0 = s.reloc_stats.get("pose_solves", 0)
    chunk_times, chunk_ms, epilogue_ms, poses_all = [], [], [], []
    t_first_chunk = None
    peak_kf_live = peak_pts = 0
    kf_hint = None
    sync()
    kernels.reset_launches()
    t_run0 = time.perf_counter()
    n_chunks = 0
    for ci, lo in enumerate(range(N_WARM, n_total, chunk)):
        idxs = order[lo:lo + chunk]
        if len(idxs) < chunk:
            break
        before = counters()
        tc0 = time.perf_counter()
        grays, depths, bxs = stage(idxs)
        tss = torch.tensor([(lo + j) / 30.0 for j in range(len(idxs))],
                           dtype=torch.float32)
        kf_before = kf_hint if kf_hint is not None else int(st.m.next_kf)
        st, diag = steady.slam_chunk(st, grays, depths, bxs, tss, cfg=cfg)
        s.record_chunk(st, diag, tss)
        poses_all.append(diag["pose"].cpu().numpy())
        t_ep = time.perf_counter()
        chunk_ms.append((t_ep - tc0) * 1e3)
        lost = int(st.ts.status) == tracking.STATUS_LOST
        st = s.chunk_epilogue(st, kf_before)
        lifetime_kf += s.n_keyframes - kf_before
        kf_hint = s.next_kf_hint
        sync()
        t_end = time.perf_counter()
        epilogue_ms.append((t_end - t_ep) * 1e3)
        if t_first_chunk is None:
            t_first_chunk = t_end - tc0
        else:
            chunk_times.append(t_end - tc0)
        n_chunks += 1
        after = counters()
        for k in after:
            if after[k] > before[k]:
                events[k].append(ci)
        if lost:
            events["lost_chunk"].append(ci)
        far = int((kf_gt_err(st.m) > 50).sum())
        if far > n_far:
            events["kf_far"].append(ci)
        n_far = far
        if on_chunk is not None:
            on_chunk(ci, st, diag)
        peak_kf_live = max(peak_kf_live, int(st.m.kf_valid.sum()))
        peak_pts = max(peak_pts, int(st.m.pt_valid.sum()))
        if progress is not None and ci % 40 == 0:
            done = lo + chunk - N_WARM
            el = time.perf_counter() - t_run0
            progress(f"frame {lo + chunk}/{n_total} kf_next={kf_hint} "
                     f"live={peak_kf_live} pts={peak_pts} "
                     f"loops={s.n_loops_closed} ({done / el:.1f} fps avg)")
    n_chunked = n_chunks * chunk
    launches = dict(kernels.launches)
    reloc_solves = s.reloc_stats.get("pose_solves", 0) - reloc0

    # the end: a pending detection harvested, the GBA joined and merged
    before = counters()
    s._poll_gba(blocking=True)
    sync()
    after = counters()
    for k in after:
        if after[k] > before[k]:
            events[k].append("end")
    peak_mem = torch.cuda.max_memory_allocated(dev) if cuda else None

    kf_err = kf_gt_err(s.map)

    ct = np.array(chunk_times)
    n_timed = len(ct) * chunk
    fps = n_timed / ct.sum()
    per_frame_ms = ct / chunk * 1000.0
    est = np.concatenate(poses_all)
    gt = np.stack([seq.frames[i].tcw
                   for i in order[N_WARM:N_WARM + len(est)]])
    err = tum.evaluate_ate_rpe(est, gt)
    corrected = s.trajectory_tcw(corrected=True)[N_WARM:N_WARM + len(est)]
    err_c = tum.evaluate_ate_rpe(corrected, gt)
    moved = np.linalg.norm(centres(corrected) - centres(est), axis=1) * 100
    # each lap's raw poses aligned on their own: the whole run's ATE above
    # also holds the offset between laps (the drift a closure corrected)
    lap_idx = (np.arange(len(est)) + N_WARM) // lap_frames
    lap_ate = [float(tum.evaluate_ate_rpe(est[lap_idx == k],
                                          gt[lap_idx == k]).ate_rmse) * 100
               for k in range(int(lap_idx.max()) + 1)
               if (lap_idx == k).sum() >= 3]
    return {
        "metric": "fr3scale_fps", "value": float(fps), "unit": "fps",
        "vs_baseline": float(fps) / 30.0, "frames": int(n_timed),
        "ate_cm": float(err.ate_rmse) * 100,
        "loops_closed": int(s.n_loops_closed),
        "gba_merges": int(s.n_gba_merges),
        "gba_aborts": int(lc.stats.get("n_gba_aborts", 0)) if lc else 0,
        "evicted_kfs": int(s.n_kf_evictions),
        "kf_compactions": int(s.n_kf_compactions),
        "pt_compactions": int(s.n_pt_compactions),
        "relocs": int(s.n_relocalizations),
        "lifetime_kf_insertions": int(lifetime_kf),
        "peak_kf_live": int(peak_kf_live),
        "peak_points": int(peak_pts),
        "p50_frame_ms": float(np.percentile(per_frame_ms, 50)),
        "p99_frame_ms": float(np.percentile(per_frame_ms, 99)),
        "max_frame_ms": float(per_frame_ms.max()),
        # readings the JAX script does not print
        "ate_corrected_cm": float(err_c.ate_rmse) * 100,
        "lap_ate_cm": lap_ate,
        "kf_gt_err_cm": {"median": float(np.median(kf_err)),
                         "max": float(kf_err.max()),
                         "over_50": int((kf_err > 50).sum())},
        "corrected_moved_over_50cm": int((moved > 50).sum()),
        "n_resets": int(s.n_resets),
        "chunked_frames": int(n_chunked),
        "events": events,
        "launches": launches,
        "reloc_pose_solves": int(reloc_solves),
        "first_chunk_ms": t_first_chunk * 1e3,
        "median_chunk_ms": float(np.median(chunk_ms)),
        "median_epilogue_ms": float(np.median(epilogue_ms)),
        "peak_memory_mb": None if peak_mem is None else peak_mem / 2 ** 20,
        "device": (torch.cuda.get_device_name(dev) if cuda else str(dev)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--laps", type=int, default=4)
    ap.add_argument("--lap-frames", type=int, default=625)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--no-planes", action="store_true")
    ap.add_argument("--no-objects", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir",
                    default=os.path.join(ROOT, "build", "synth_cache"))
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from eao_fusion_tpu_torch.pipeline.system import System
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain PyTorch path on the CPU")
    smi_line = None
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        smi_line = smi[0] if smi else "nvidia-smi: no output"
        log(smi_line)

    t0 = time.perf_counter()
    seq = render_tour(args.lap_frames, args.cache_dir)
    log(f"[{time.perf_counter() - t0:.1f}s] sequence ready: "
        f"{args.laps * args.lap_frames} frames ({args.laps} laps x "
        f"{args.lap_frames})")
    s = System(scale_cfg(not args.no_planes, not args.no_objects),
               device=dev)
    out = run_scale(s, seq, args.laps, args.chunk,
                    progress=lambda m: log(
                        f"[{time.perf_counter() - t0:.1f}s] {m}"))
    if s.loop_closer is not None:
        log("loop stats: " + json.dumps(s.loop_closer.stats, default=float))
    out["nvidia_smi"] = smi_line
    out["wall_s"] = time.perf_counter() - t0
    log(f"[{time.perf_counter() - t0:.1f}s] done")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
