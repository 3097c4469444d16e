"""The idle-share, event-count and roofline arithmetic on a synthetic
trace, and its idle gaps named by the host's spans."""

import pytest

from benchmark.costs import ba_edge_full, chol_solve, pose_opt
from benchmark.harness import peaks, spans, trace
from benchmark.metrics import (ba_roofline_pct, device_events_per_frame,
                               device_idle_pct, epilogue_pct,
                               kf_per_100_frames, pose_opt_roofline_pct)

US = 1000  # ns


def _events():
    # (name, start ns, duration ns): two overlapping kernels, a copy, a
    # gap of 50 µs, K1 twice, K2, K4
    return [("kernA", 0, 10 * US), ("kernB", 5 * US, 10 * US),
            ("Memcpy HtoD", 20 * US, 5 * US),
            ("pose_opt_kernel", 75 * US, 20 * US),
            ("pose_opt_kernel", 100 * US, 22 * US),
            ("ba_edge_full_kernel", 130 * US, 8 * US),
            ("chol_solve_kernel", 140 * US, 40 * US)]


def test_summary():
    s = trace.summarize(_events(), window_s=400e-6)
    # busy: [0, 15) + [20, 25) + [75, 95) + [100, 122) + [130, 138)
    # + [140, 180) µs
    assert s["busy_s"] == pytest.approx(110e-6)
    assert s["n_events"] == 7
    assert s["by_name"]["pose_opt_kernel"] == pytest.approx(42e-6)
    assert s["device_ops"][0] == ["pose_opt_kernel", pytest.approx(42e-6)]
    assert s["idle_gaps"][0] == ["outside_spans | before pose_opt_kernel",
                                 pytest.approx(50e-6)]
    assert len(s["idle_gaps"]) == 5


def test_idle_gaps_named_by_the_innermost_span():
    # gaps: [15, 20) before the copy, [25, 75) before K1, [95, 100) and
    # [122, 130) and [138, 140) µs; the host was in `track` over [0, 60),
    # in its child `pose` over [30, 60), in `gate` over [60, 70)
    segs = spans.innermost_segments([(0, 60 * US, "track"),
                                     (30 * US, 60 * US, "pose"),
                                     (60 * US, 70 * US, "gate")])
    s = trace.summarize(_events(), window_s=400e-6, segs=segs)
    names = [n for n, _ in s["idle_gaps"]]
    # [25, 75): 30 in pose, 10 in gate, 5 in track, 5 outside
    assert names[0] == "pose | before pose_opt_kernel"
    # gaps of equal length in time order
    assert names[1:] == ["outside_spans | before ba_edge_full_kernel",
                         "track | before Memcpy HtoD",
                         "outside_spans | before pose_opt_kernel",
                         "outside_spans | before chol_solve_kernel"]
    assert [g for _, g in s["idle_gaps"]] == pytest.approx(
        [50e-6, 8e-6, 5e-6, 5e-6, 2e-6])
    for name, _ in s["idle_gaps"]:
        span, kernel = name.split(" | before ")
        assert span in {"track", "pose", "gate", spans.OUTSIDE} and kernel


def _run():
    k1 = dict(M=1024, Q=8, rounds=4)
    k2 = dict(C=32, Pw=2048, E=8192)
    return dict(frames=40, kf_inserted=7, epilogue_s=0.5, untraced_s=10.0,
                trace=trace.summarize(_events(), window_s=400e-6),
                trace_frames=2,
                launches=[("pose_opt", k1), ("pose_opt", k1),
                          ("ba_edge_full", k2), ("chol_solve", dict(D=192))])


def test_readers():
    run = _run()
    assert device_idle_pct.read(run) == pytest.approx(100 * (1 - 110 / 400))
    assert device_events_per_frame.read(run) == pytest.approx(3.5)
    assert epilogue_pct.read(run) == pytest.approx(5.0)
    assert kf_per_100_frames.read(run) == pytest.approx(17.5)
    b1 = 2 * peaks.bound_s(*pose_opt.cost(dict(M=1024, Q=8, rounds=4)))
    assert pose_opt_roofline_pct.read(run) == pytest.approx(
        100 * b1 / 42e-6)
    b2 = (peaks.bound_s(*ba_edge_full.cost(dict(C=32, Pw=2048, E=8192)))
          + peaks.bound_s(*chol_solve.cost(dict(D=192))))
    assert ba_roofline_pct.read(run) == pytest.approx(100 * b2 / 48e-6)


def test_readers_find_nothing():
    run = dict(frames=40, kf_inserted=7, epilogue_s=None, untraced_s=None)
    for mod in (device_idle_pct, device_events_per_frame, epilogue_pct,
                pose_opt_roofline_pct, ba_roofline_pct):
        assert mod.read(run) is None
    run = _run()
    run["launches"] = [("ba_edge_full", None)]
    assert ba_roofline_pct.read(run) is None
    run["launches"] = []
    assert pose_opt_roofline_pct.read(run) is None
