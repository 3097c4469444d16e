"""The port's pooled renderer (`synthetic.render_sequences`: frames of
several sequences in one pool of spawned processes) gives
`generate_sequence`'s frames bit for bit: 3 frames of the seed-0 tour at
640x480 and 2 of the seed-5 corridor at 320x240, the sequences
`chip_smoke.py` phase 25 renders at 506 and 240 frames; a frame subset,
a second call read back from the cache directory, where a whole
sequence is `generate_sequence`'s own cache file."""

import numpy as np

from eao_fusion_tpu_torch.config import CameraConfig
from eao_fusion_tpu_torch.io import synthetic

SMALL_CAM = CameraConfig(width=320, height=240, fx=267.7, fy=269.6,
                         cx=160.0, cy=120.0, bf=40.0, th_depth=40.0)


def _same(a, b):
    assert len(a.frames) == len(b.frames)
    for x, y in zip(a.frames, b.frames):
        for k in ("gray", "depth", "tcw", "boxes"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k),
                                          err_msg=k)
            assert getattr(x, k).dtype == getattr(y, k).dtype, k
        assert x.timestamp == y.timestamp


def test_pooled_frames_equal_generate_sequence(tmp_path):
    tour = synthetic.generate_sequence(n_frames=3, seed=0, style="tour")
    corr = synthetic.generate_sequence(n_frames=2, seed=5, style="corridor",
                                       camera=SMALL_CAM)
    specs = [dict(n_frames=3, seed=0, style="tour"),
             dict(n_frames=2, seed=5, style="corridor", camera=SMALL_CAM),
             dict(n_frames=3, seed=0, style="tour", frames=[2, 0])]
    for _ in range(2):              # rendered, then read from the cache
        got = synthetic.render_sequences(specs, workers=2,
                                         cache_dir=str(tmp_path))
        _same(got[0], tour)
        _same(got[1], corr)
        sub = synthetic.SyntheticSequence(
            frames=[tour.frames[2], tour.frames[0]], camera=tour.camera,
            scene=tour.scene)
        _same(got[2], sub)
    # a whole sequence lies in generate_sequence's own file: it reads it
    # back and writes nothing; only the subset has a file of its own
    _same(synthetic.generate_sequence(n_frames=3, seed=0, style="tour",
                                      cache_dir=str(tmp_path)), tour)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 3
    assert sum("_sel" in n for n in names) == 1
