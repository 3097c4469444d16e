"""The chunked steady path, the production pipelining mode: a few frames
through `System.process_frame` (with the boxes), untimed warm chunks, then,
inside the window, `steady.slam_chunk` over chunks of the traffic's
length, each recorded (`System.record_chunk`) and followed by
`System.chunk_epilogue`, at the tracker's own keyframe cadence
(`kf_every` 0).

In a traced run (`hooks.tracing`), the window's first `trace_chunks`
chunks run under the profiler as in an untraced run; every later chunk
is synchronised before and after its epilogue, so that the epilogue's
share of the window can be read by the host's clock."""

from __future__ import annotations

import time

import torch


COUNTERS = ("n_loops_closed", "n_gba_merges", "n_kf_evictions",
            "n_kf_compactions", "n_pt_compactions", "n_relocalizations")


def run(s, stream, traffic: dict, conf: dict, seconds: float, hooks
        ) -> dict:
    from eao_fusion_tpu_torch.pipeline import steady

    cfg, dev = s.cfg, s.device
    fps_cam = float(traffic["camera_fps"])
    C = int(traffic["chunk"])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    for k in range(int(traffic["warm_frames"])):
        gray, depth, boxes = stream.host_frame(k)
        s.process_frame(gray, depth, timestamp=k / fps_cam, boxes=boxes)
    state = dict(st=steady.init_steady_state(s), hint=None,
                 k=int(traffic["warm_frames"]))

    def chunk(timed_epilogue: bool = False):
        """One chunk and its epilogue; returns (chunk s, epilogue s) by
        the host's clock if `timed_epilogue`, else None."""
        k0 = state["k"]
        grays, depths, boxes = stream.chunk(k0, C)
        tss = torch.tensor([(k0 + j) / fps_cam for j in range(C)],
                           dtype=torch.float32)
        st = state["st"]
        kf_before = (state["hint"] if state["hint"] is not None
                     else int(st.m.next_kf))
        t0 = time.perf_counter()
        st, diag = steady.slam_chunk(st, grays, depths, boxes, tss, cfg=cfg,
                                     kf_every=int(traffic["kf_every"]))
        s.record_chunk(st, diag, tss)
        if timed_epilogue:
            sync()
        t1 = time.perf_counter()
        st = s.chunk_epilogue(st, kf_before)
        if timed_epilogue:
            sync()
        state.update(st=st, hint=s.next_kf_hint, k=k0 + C)
        if timed_epilogue:
            return t1 - t0, time.perf_counter() - t1
        return None

    for _ in range(int(traffic["warm_chunks"])):
        chunk()
    sync()

    counters0 = {c: getattr(s, c) for c in COUNTERS}
    traj0, diag0 = len(s.trajectory), len(s.diags)
    n_chunks, ep_s, ch_s, untraced = 0, 0.0, 0.0, 0
    n_trace = int(traffic["trace_chunks"]) if hooks.tracing else 0
    hooks.window_begin()
    t_start = time.perf_counter()
    while True:
        i = n_chunks
        n_chunks += 1
        if i < n_trace:
            if i == 0:
                hooks.trace_begin()
            chunk()
            if i == n_trace - 1:
                hooks.trace_end(frames=n_trace * C)
        elif hooks.tracing:
            c_s, e_s = chunk(timed_epilogue=True)
            ch_s += c_s
            ep_s += e_s
            untraced += 1
        else:
            chunk()
        if time.perf_counter() - t_start >= seconds and i + 1 >= n_trace:
            break
    sync()
    t_end = time.perf_counter()
    hooks.window_end()
    frames = n_chunks * C
    window = s.diags[diag0:diag0 + frames]
    return dict(
        t_start=t_start, window_s=t_end - t_start, frames=frames,
        traj0=traj0,
        kf_inserted=int(sum(bool(d["kf_inserted"]) for d in window)),
        n_inliers=[int(d["n_inliers"]) for d in window],
        epilogue_s=ep_s if untraced else None,
        untraced_s=ch_s + ep_s if untraced else None,
        events={c: getattr(s, c) - counters0[c] for c in COUNTERS})
