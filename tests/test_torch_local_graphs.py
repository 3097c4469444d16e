"""Local mapping on the card as CUDA graphs (`utils/graphs`): each keyframe
of a System on the cached seed-0 arc, `process_frame` and then the steady
chunked loop, runs `local_mapping_step` twice on the same map: once with
the graphs off (the same body, eagerly on the card) and once through the
graphs. Every map field and local BA's answer must be the same bits, and
the graphs are captured at the first keyframe only. Torch only: this file
runs on the card (`-m gpu`)."""

import pytest
import torch

from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.io import synthetic
from eao_fusion_tpu_torch.mapping.map_state import MapState
from eao_fusion_tpu_torch.pipeline import local_mapping as LM
from eao_fusion_tpu_torch.pipeline import steady
from eao_fusion_tpu_torch.pipeline.system import System
from eao_fusion_tpu_torch.utils import graphs, profiling
from torch_contracts import chunk_tensors

WARM, CHUNK = 8, 6


@pytest.mark.gpu
def test_local_mapping_graphs_match_eager_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = TC.tum_fr3_config(use_loop_closing=False)
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      cache_dir="build/synth_cache")
    step, bundle_adjust = LM.local_mapping_step, LM.ba.bundle_adjust_coo
    answers, captures, steps, phase = [], [], [], ["process_frame"]
    count = profiling.count

    def counted(name, n=1):
        if name == profiling.CAPTURE_COUNTER:
            captures[-1] += n
        count(name, n)

    def spy(prob, plane_block=None, **kw):
        res = bundle_adjust(prob, plane_block, **kw)
        answers.append(res)
        return res

    def compared(m, slot, *, cfg):
        with monkeypatch.context() as mp:
            mp.setattr(graphs, "enabled", lambda device: False)
            eager = step(m, slot, cfg=cfg)
        captures.append(0)
        out = step(m, slot, cfg=cfg)
        res_g, res_e = answers.pop(), answers.pop()
        same = [f for f in MapState._fields
                if torch.equal(getattr(out, f), getattr(eager, f))]
        steps.append(dict(phase=phase[0], slot=slot, captures=captures[-1],
                          differ=sorted(set(MapState._fields) - set(same)),
                          ba_same=all(torch.equal(a, b) for a, b in
                                      zip(res_g[:4], res_e[:4]))))
        print(steps[-1], flush=True)
        return out

    monkeypatch.setattr(graphs.profiling, "count", counted)
    monkeypatch.setattr(LM.ba, "bundle_adjust_coo", spy)
    monkeypatch.setattr(LM, "local_mapping_step", compared)
    s = System(cfg, device=dev)
    for f in seq.frames[:WARM]:
        s.process_frame(f.gray, f.depth, f.timestamp, boxes=f.boxes)
    phase[0] = "steady"
    st = steady.init_steady_state(s)
    kf_before = int(st.m.next_kf)
    for lo in range(WARM, len(seq.frames), CHUNK):
        g, d, b, ts = chunk_tensors(cfg, seq.frames[lo:lo + CHUNK], True,
                                    dev)
        st, diag = steady.slam_chunk(st, g, d, b, ts, cfg=cfg)
        s.record_chunk(st, diag, ts)
        st = s.chunk_epilogue(st, kf_before)
        kf_before = s.next_kf_hint
    assert sum(x["phase"] == "steady" for x in steps) >= 3, steps
    assert all(not x["differ"] and x["ba_same"] for x in steps), steps
    assert all(x["captures"] == 0 for x in steps[1:]), steps
    assert steps[0]["captures"] > 0, steps
