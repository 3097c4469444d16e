"""The stream (`benchmark/harness/stream.py`): fr3_office's frames at the
configuration's rehearsal size are those of the generator before scenes
became modules, bit for bit (digests of its frames 0, 97, 311 and 600:
gray, depth, pose and boxes, and of the whole stream, taken from that
generator for the seed below); a stream with `replay` false ends with an
error at the first frame past its end, and the room keeps replaying.
The first test renders 625 frames of 320x240 on the CPU (about 20 s)."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import core
from benchmark.harness.stream import Stream

SEED = 4000000007
DIGESTS = {0: "b1ba998a6e9a5080", 97: "11684eff22da77cb",
           311: "fcd4667ddf4b96fb", 600: "d7e4d768e56b66a4",
           "all": "b6863ba49783f970"}
TINY = dict(width=40, height=30, fx=535.4 / 16, fy=539.2 / 16,
            cx=320.1 / 16, cy=247.6 / 16)
CPU = torch.device("cpu")


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def test_fr3_office_stream_is_unchanged():
    conf = bench_run.rehearsal_config(
        core.load_cell("fr3_office.chunked")["config"])
    cfg = core.system_config(conf)
    s = Stream(conf["stream"], conf["system"]["camera"], SEED, CPU,
               cfg.objects.max_objects_2d)
    got = {i: _digest(s.gray[i].numpy(), s.depth[i].numpy(), s.tcw[i],
                      s.boxes[i].numpy()) for i in (0, 97, 311, 600)}
    got["all"] = _digest(s.gray.numpy(), s.depth.numpy(), s.tcw,
                         s.boxes.numpy())
    assert got == DIGESTS


def _stream(scene, trajectory, frames, **extra):
    return Stream(dict(scene=scene, layout_seed=0, trajectory=trajectory,
                       frames=frames, n_objects=4, **extra), TINY, 7, CPU, 8)


def test_stream_that_ends_raises_past_its_end():
    s = _stream("corridor", "corridor", 12, replay=False)
    assert s.index(11) == 11
    g, d, b = s.chunk(4, 8)
    assert g.shape == (8, 30, 40) and torch.equal(g, s.gray[4:12])
    for past in (lambda: s.index(12), lambda: s.chunk(8, 8),
                 lambda: s.host_frame(12)):
        with pytest.raises(core.BenchError, match="frame 12 .* 12 frames"):
            past()


def test_room_keeps_replaying():
    s = _stream("room", "tour", 10)
    assert [s.index(k) for k in (9, 10, 25)] == [9, 0, 5]
    g, _, _ = s.chunk(6, 8)
    assert torch.equal(g, s.gray[[6, 7, 8, 9, 0, 1, 2, 3]])
    assert _stream("room", "tour", 10, replay=True).index(10) == 0


def test_a_scene_without_the_trajectory_is_refused():
    with pytest.raises(core.BenchError, match="no trajectory 'tour'"):
        _stream("corridor", "tour", 4)
    with pytest.raises(core.BenchError, match="no module"):
        _stream("no_such_scene", "tour", 4)
