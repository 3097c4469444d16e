"""The reader of `local_graph_pct` on synthetic span records: keyframes
whose `mapping.local` replays graphs without a capture, over the
keyframes of the chunks after the traced span; nothing where no graph
was counted."""

import pytest

from benchmark.harness import spans
from benchmark.metrics import local_graph_pct
from eao_fusion_tpu_torch.utils.profiling import Span

MS = 1_000_000


class _Rec:
    def __init__(self):
        self.spans, self.counts, self.next = [], {}, 1

    def add(self, name, t0, t1, parent=0, **counts):
        sid = self.next
        self.next += 1
        self.spans.append(Span(sid, parent, name, t0 * MS, t1 * MS,
                               t0 * MS, t1 * MS, 1, None, None))
        if counts:
            self.counts[sid] = counts
        return sid

    def chunk(self, t0, kf_counts):
        """A chunk of one frame per entry; a keyframe where the entry is a
        dict of counts, put on a stage span inside `mapping.local`."""
        c = self.add("steady.slam_chunk", t0, t0 + 10 * len(kf_counts))
        for i, n in enumerate(kf_counts):
            st = self.add("steady.step", t0 + 10 * i, t0 + 10 * i + 9,
                          parent=c)
            if n is None:
                continue
            br = self.add("mapping.kf_branch", t0 + 10 * i, t0 + 10 * i + 8,
                          parent=st)
            loc = self.add("mapping.local", t0 + 10 * i, t0 + 10 * i + 7,
                           parent=br)
            self.add("mapping.fuse", t0 + 10 * i, t0 + 10 * i + 1,
                     parent=loc, **n)
        return c

    def record(self):
        return dict(spans=self.spans, counts=self.counts, anchor=(0, 0),
                    threads={1: "main"}, main_thread=1)


@pytest.fixture
def recorded():
    saved = list(spans._record)

    def put(rec):
        spans._record[:] = [rec]
    yield put
    spans._record[:] = saved


def test_share_of_keyframes_replayed_without_capture(recorded):
    r = _Rec()
    r.chunk(0, [dict(graph_capture=9), None])          # traced: not read
    r.chunk(100, [dict(graph_replay=50), None, dict(graph_replay=50)])
    r.chunk(200, [dict(graph_replay=50, graph_capture=1), None])
    recorded(r.record())
    assert local_graph_pct.read(dict(trace_frames=2)) == pytest.approx(
        100.0 * 2 / 3)
    assert local_graph_pct.read(dict(trace_frames=5)) == 0.0


def test_nothing_without_graph_counters(recorded):
    r = _Rec()
    r.chunk(0, [None])
    r.chunk(100, [dict(host_sync=3), None])             # the parent's port
    recorded(r.record())
    assert local_graph_pct.read(dict(trace_frames=1)) is None
    assert local_graph_pct.read(dict(trace_frames=0)) is None
    recorded(None)
    assert local_graph_pct.read(dict(trace_frames=1)) is None
