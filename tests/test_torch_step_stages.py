"""One tracking step of the fr3-scale run taken apart stage by stage: the
tour's frame 70 at the JAX script's configuration (production tables,
planes, objects and loop closing on), the JAX steady loop run to it from
the 12 warm-up frames (on the CPU) and the port's `slam_step` run once
from the JAX state, the object table carried across. Spies record each
stage of the port's step: the features, the frame's planes, the
motion-model and local-map searches, both pose solves (K1) and the
tracker's counts. On the card the step runs on the CPU and on the card,
and every card stage is also run again on the CPU stage's own inputs, so
that the first stage to part is found on equal inputs; on the CPU the
port's stages are held against the JAX package's own on the same inputs.
Each stage is held to the bound of its own CPU parity test."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu import config as JC
from eao_fusion_tpu import types as JT
from eao_fusion_tpu.frontend import extractor as JE
from eao_fusion_tpu.frontend import matcher as JM
from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu.ops import planes as JP
from eao_fusion_tpu.solvers import pose_opt as JPO
from eao_fusion_tpu_torch.frontend import extractor as TE
from eao_fusion_tpu_torch.frontend import matcher as TM
from eao_fusion_tpu_torch.ops import planes as TP
from eao_fusion_tpu_torch.solvers import pose_opt as TPO

from test_torch_fr3_scale import _jax_steady, port_step

FRAME = 70
STAGES = ("features", "planes", "mm_search", "k1_first", "lm_search",
          "k1_second", "track")


@pytest.fixture(scope="module")
def card():
    """Skips before `frame70` is built where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def frame70():
    """The tour's frames 0-70 (rendered in a pool into build/synth_cache),
    the JAX steady state before frame 70's step and after it, and the
    step's diagnostics."""
    import os

    from eao_fusion_tpu_torch.io import synthetic
    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "synth_cache")
    seq = synthetic.render_sequences(
        [dict(n_frames=625, seed=0, style="tour",
              frames=list(range(FRAME + 1)))], cache_dir=cache)[0]
    for fi, before, after, diag in _jax_steady(seq, FRAME + 1):
        pass
    assert fi == FRAME
    return seq, before, after, diag


def _host(x):
    """Tensors (in tuples, NamedTuples and dicts) copied to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_host(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _to(x, dev):
    """`_host`'s inverse: tensors moved to `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, tuple):
        vals = [_to(v, dev) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def record_step(jst, seq, dev, monkeypatch, given=None) -> dict:
    """The port's step from JAX state `jst` at FRAME on `dev`, each stage's
    inputs and outputs kept on the host: `features`, `planes`,
    `mm_search` / `lm_search` (the last call of each; the motion-model
    search checks rotation, the local-map one does not), `k1_first` /
    `k1_second` ((args, kwargs) and the result), `track` (the step's
    state and diagnostics). `given` may hold a `features` or `planes`
    output that the step takes in place of computing its own."""
    given = given or {}
    rec = {"searches": [], "k1": []}
    extract, segment = TE.extract_features, TP.segment_planes
    match, optimize = TM.match_points_to_frame, TPO.optimize_pose

    def spy_extract(*a, **kw):
        out = (_to(given["features"], dev) if "features" in given
               else extract(*a, **kw))
        rec["features"] = _host(out)
        return out

    def spy_segment(*a, **kw):
        out = (_to(given["planes"], dev) if "planes" in given
               else segment(*a, **kw))
        rec["planes"] = _host(out)
        return out

    def spy_match(*a, **kw):
        out = match(*a, **kw)
        rec["searches"].append(((_host(a), _host(kw)), _host(out)))
        return out

    def spy_optimize(*a, **kw):
        out = optimize(*a, **kw)
        rec["k1"].append(((_host(a), _host(kw)), _host(out)))
        return out
    with monkeypatch.context() as mp:
        mp.setattr(TE, "extract_features", spy_extract)
        mp.setattr(TP, "segment_planes", spy_segment)
        mp.setattr(TM, "match_points_to_frame", spy_match)
        mp.setattr(TPO, "optimize_pose", spy_optimize)
        st, diag = port_step(jst, seq, FRAME, dev)
    mm = [s for s in rec["searches"] if s[0][1].get("check_rotation", True)]
    lm = [s for s in rec["searches"]
          if not s[0][1].get("check_rotation", True)]
    assert len(rec["k1"]) == 2 and mm and len(lm) == 1
    return dict(features=rec["features"], planes=rec["planes"],
                mm_search=mm[-1], lm_search=lm[0], k1_first=rec["k1"][0],
                k1_second=rec["k1"][1],
                track=(_host(st.ts), _host({k: v for k, v in diag.items()
                                            if isinstance(v, torch.Tensor)})))


# ------------------------------------------------------------ comparisons

def _centre(pose) -> np.ndarray:
    return np.asarray(JL.se3_inverse(np.asarray(pose, np.float32)))[4:]


def _pose_err(a, b) -> float:
    """The norm of the SE3 log of a⁻¹ b (tests/test_pose_opt.py)."""
    d = JL.se3_compose(JL.se3_inverse(jnp.asarray(a)), jnp.asarray(b))
    return float(np.linalg.norm(np.asarray(JL.se3_log(d))))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cmp_features(a, b) -> dict:
    va, vb = _np(a.valid), _np(b.valid)
    same = (_np(a.uv) == _np(b.uv)).all(1) & (_np(a.level) == _np(b.level))
    both = same & va & vb
    da, db = _np(a.desc_pm1), _np(b.desc_pm1)
    return dict(
        valid=(int(va.sum()), int(vb.sum())),
        same_uv_level=float(same.mean()),
        slots_uv_level_differ=int((~same & (va | vb)).sum()),
        uv_max_diff=float(np.abs(_np(a.uv) - _np(b.uv))[va & vb].max(
            initial=0.0)),
        slots_angle_differ=int((np.abs(_np(a.angle) - _np(b.angle))
                                > 1e-4)[both].sum()),
        slots_desc_differ=int((da != db).any(1)[both].sum()),
        desc_bits_agree=float((da == db)[both].mean()) if both.any()
        else 1.0)


def features_ok(c) -> bool:
    """tests/test_torch_extractor.py: 99% of the slots at the same pixel
    and level, 99.9% of the descriptor bits."""
    return c["same_uv_level"] >= 0.99 and c["desc_bits_agree"] > 0.999


def cmp_planes(a, b) -> dict:
    va, vb = _np(a.valid), _np(b.valid)
    both = va & vb
    ca, cb = _np(a.coeffs), _np(b.coeffs)
    na, nb = _np(a.n_inliers)[both], _np(b.n_inliers)[both]
    return dict(n=(int(va.sum()), int(vb.sum())),
                same_valid=bool((va == vb).all()),
                support_max_rel_diff=float(
                    (np.abs(na - nb) / np.maximum(na, 1)).max(initial=0.0)),
                normal_min_dot=float(np.abs(np.sum(
                    ca[both, :3] * cb[both, :3], axis=1)).min(initial=1.0)),
                offset_max_diff=float(np.abs(ca[both, 3] - cb[both, 3])
                                      .max(initial=0.0)))


def planes_ok(c) -> bool:
    """tests/test_torch_planes.py: the same planes, the supports within 1%,
    |n·n'| > 1 - 1e-6 and offsets within 1 mm."""
    return (c["same_valid"] and c["support_max_rel_diff"] <= 0.01
            and c["normal_min_dot"] > 1 - 1e-6
            and c["offset_max_diff"] < 1e-3)


def planes_same_support(c) -> bool:
    """The same planes from the same pixels: validity equal, supports
    within 1%. The port's planes against the JAX package's: a component
    refit from summed moments cancels (z² ≈ 20 m² against the spread of a
    small, far, not quite flat component), and the JAX package sums in
    float32, where the order of the sum moves such a plane by centimetres
    (the port sums in float64); the coefficients are printed, not held."""
    return c["same_valid"] and c["support_max_rel_diff"] <= 0.01


def cmp_search(a, b) -> dict:
    ta, tb = _np(a.target_idx), _np(b.target_idx)
    return dict(matched=(int((ta >= 0).sum()), int((tb >= 0).sum())),
                agree=float((ta == tb).mean()),
                slots_differ=int((ta != tb).sum()))


def search_ok(c) -> bool:
    """tests/test_torch_tracking.py: 99% of the slots matched alike."""
    return c["agree"] >= 0.99


def cmp_k1(a, b) -> dict:
    """K1 calls `a`, `b` as recorded ((args, kwargs), result)."""
    (aa, _), ra = a
    (ba_, _), rb = b
    oa, ob = aa[1], ba_[1]
    pa = aa[2] if len(aa) > 2 else None
    pb = ba_[2] if len(ba_) > 2 else None
    ia, ib = _np(ra.inliers), _np(rb.inliers)
    return dict(
        obs_valid=(int(_np(oa.valid).sum()), int(_np(ob.valid).sum())),
        obs_valid_differ=int((_np(oa.valid) != _np(ob.valid)).sum()),
        planes=(None if pa is None else int(_np(pa.valid).sum()),
                None if pb is None else int(_np(pb.valid).sum())),
        pose0_err=_pose_err(_np(aa[0]), _np(ba_[0])),
        pose_err=_pose_err(_np(ra.pose), _np(rb.pose)),
        centre_diff_cm=float(np.linalg.norm(_centre(_np(ra.pose))
                                            - _centre(_np(rb.pose))) * 100),
        inliers_agree=float((ia == ib).mean()),
        n_inliers=(int(ra.n_inliers), int(rb.n_inliers)),
        chi2=(float(ra.chi2), float(rb.chi2)))


def k1_ok(c) -> bool:
    """tests/test_pose_opt.py:110-120: pose within 1e-3 (SE3 log), 99.5% of
    the inlier flags, the inlier count within 5."""
    return (c["pose_err"] < 1e-3 and c["inliers_agree"] > 0.995
            and abs(c["n_inliers"][0] - c["n_inliers"][1]) <= 5)


def cmp_track(a, b) -> dict:
    (ta, da), (tb, db) = a, b
    ka, kb = _np(ta.kp_pt), _np(tb.kp_pt)
    return dict(
        kp_pt_agree=float((ka == kb).mean()),
        centre_diff_cm=float(np.linalg.norm(_centre(_np(ta.pose))
                                            - _centre(_np(tb.pose))) * 100),
        **{k: (int(da[k]), int(db[k])) for k in (
            "n_inliers", "n_ref", "tracked_close", "untracked_close",
            "kf_trigger")})


def track_ok(c) -> bool:
    """tests/test_torch_tracking.py: 99% of `kp_pt` alike, the inlier count
    within 5."""
    return (c["kp_pt_agree"] >= 0.99
            and abs(c["n_inliers"][0] - c["n_inliers"][1]) <= 5)


COMPARE = dict(features=(cmp_features, features_ok),
               planes=(cmp_planes, planes_ok),
               mm_search=(lambda a, b: cmp_search(a[1], b[1]), search_ok),
               k1_first=(cmp_k1, k1_ok),
               lm_search=(lambda a, b: cmp_search(a[1], b[1]), search_ok),
               k1_second=(cmp_k1, k1_ok), track=(cmp_track, track_ok))

# what "beyond float noise" means for each stage
NOISE = dict(
    features=lambda c: c["slots_uv_level_differ"] or c["slots_desc_differ"],
    planes=lambda c: not c["same_valid"] or c["offset_max_diff"] > 1e-5,
    mm_search=lambda c: c["slots_differ"],
    k1_first=lambda c: c["centre_diff_cm"] > 1e-3 or c["inliers_agree"] < 1,
    lm_search=lambda c: c["slots_differ"],
    k1_second=lambda c: c["centre_diff_cm"] > 1e-3 or c["inliers_agree"] < 1,
    track=lambda c: c["centre_diff_cm"] > 1e-3 or c["kp_pt_agree"] < 1)


def compare_stages(a: dict, b: dict, label: str) -> dict:
    """Every stage of records `a` and `b`; prints each and the first stage
    that parts beyond float noise."""
    out = {k: COMPARE[k][0](a[k], b[k]) for k in STAGES}
    for k in STAGES:
        print(f"{label} {k}: {out[k]}", flush=True)
    first = next((k for k in STAGES if NOISE[k](out[k])), None)
    print(f"{label}: the first stage to part beyond float noise: {first}",
          flush=True)
    return out


def _failed(out: dict, planes=planes_ok) -> list:
    ok = dict({k: v[1] for k, v in COMPARE.items()}, planes=planes)
    return [k for k in STAGES if not ok[k](out[k])]


# ---------------------------------------------------------- replays

def replay_on(rec: dict, dev) -> dict:
    """The searches and the pose solves of CPU record `rec` run once more
    on `dev` from the record's own inputs; the other stages as recorded. A
    stage of the result can part from `rec` only where `dev` computes
    differently."""
    out = dict(rec)
    for name, fn in (("mm_search", TM.match_points_to_frame),
                     ("lm_search", TM.match_points_to_frame),
                     ("k1_first", TPO.optimize_pose),
                     ("k1_second", TPO.optimize_pose)):
        (a, kw), _ = rec[name]
        out[name] = ((a, kw), _host(fn(*_to(a, dev), **_to(kw, dev))))
    return out


def _to_jax(x, jcfg):
    """The port's recorded arguments as the JAX package's: tensors as
    arrays (the packed descriptor words as uint32), the NamedTuples as
    their JAX namesakes, the solver configuration as `jcfg.solver`."""
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    if isinstance(x, dict):
        return {k: (jcfg.solver if k == "cfg" else _to_jax(v, jcfg))
                for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        cls = {"PoseObs": JPO.PoseObs, "PlaneObs": JPO.PlaneObs,
               "FrameFeatures": JT.FrameFeatures}[type(x).__name__]
        return cls(**{k: (jnp.asarray(v.numpy().view(np.uint32))
                          if k == "desc_packed" else _to_jax(v, jcfg))
                      for k, v in x._asdict().items()})
    if isinstance(x, tuple):
        return tuple(_to_jax(v, jcfg) for v in x)
    return x


def jax_record(rec: dict, seq, after, diag) -> dict:
    """The JAX package's own stages on the inputs of the port's record
    `rec`: `extract_features` and `segment_planes` on the frame, the
    searches and `optimize_pose` on the recorded arguments; the track
    stage from the JAX step itself (`after`, `diag`)."""
    jcfg = JC.SystemConfig()
    f = seq.frames[FRAME]
    out = dict(
        features=JE.extract_features(jnp.asarray(f.gray),
                                     jnp.asarray(f.depth),
                                     orb_cfg=jcfg.orb, cam_cfg=jcfg.camera),
        planes=JP.segment_planes(jnp.asarray(f.depth), cam=jcfg.camera,
                                 cfg=jcfg.planes),
        track=(after.ts, {k: np.asarray(v) for k, v in diag.items()}))
    for name, fn in (("mm_search", JM.match_points_to_frame),
                     ("lm_search", JM.match_points_to_frame),
                     ("k1_first", JPO.optimize_pose),
                     ("k1_second", JPO.optimize_pose)):
        (a, kw), _ = rec[name]
        out[name] = ((a, kw), fn(*_to_jax(a, jcfg), **_to_jax(kw, jcfg)))
    return out


def _print_truth(label, pose, seq):
    err = np.linalg.norm(_centre(_np(pose)) - _centre(seq.frames[FRAME].tcw))
    print(f"{label}: {err * 100:.4f} cm from the ground truth", flush=True)


@pytest.mark.gpu
def test_step_stages_match_on_the_card(card, frame70, monkeypatch):
    """The port's step at frame 70 from the JAX state, on the CPU (the
    plain versions) and on the card: every stage within its parity
    test's bound, card against CPU, end to end and with each card stage
    fed the CPU stage's inputs; each K1 call also against
    `optimize_pose_plain` on the card on its very inputs (phase 3's
    tolerances). Prints every stage and the first one to part."""
    seq, before, after, _ = frame70
    _print_truth("JAX", after.ts.pose, seq)
    cpu = record_step(before, seq, "cpu", monkeypatch)
    card = record_step(before, seq, "cuda", monkeypatch)
    _print_truth("port, CPU", cpu["track"][0].pose, seq)
    _print_truth("port, card", card["track"][0].pose, seq)
    e2e = compare_stages(cpu, card, "card against CPU")
    same_in = compare_stages(cpu, replay_on(cpu, "cuda"),
                             "card on the CPU's inputs")
    for name in ("features", "planes"):
        # the CPU step given the card's output of this stage alone
        mixed = record_step(before, seq, "cpu", monkeypatch,
                            given={name: card[name]})
        print(f"the CPU step given the card's {name}: "
              f"{cmp_track(mixed['track'], card['track'])} against the "
              f"card, {cmp_track(mixed['track'], cpu['track'])} against "
              f"the CPU", flush=True)
    plain = {}
    for name in ("k1_first", "k1_second"):
        (a, kw), _ = card[name]
        res = TPO.optimize_pose_plain(*_to(a, "cuda"), **_to(kw, "cuda"))
        plain[name] = cmp_k1(((a, kw), _host(res)), card[name])
        print(f"K1 against its plain version on the card, {name}: "
              f"{plain[name]}", flush=True)
    assert not _failed(e2e), _failed(e2e)
    assert not _failed(same_in), _failed(same_in)
    assert all(k1_ok(c) for c in plain.values()), plain


@pytest.mark.slow
def test_step_stages_match_jax_on_the_cpu(frame70, monkeypatch):
    """The port's stages of the frame-70 step on the CPU against the JAX
    package's own on the same inputs (its `extract_features`,
    `segment_planes`, searches and `optimize_pose`; the JAX step for the
    tracker's counts), each within its parity test's bound; the planes by
    their pixels (`planes_same_support`)."""
    seq, before, after, diag = frame70
    cpu = record_step(before, seq, "cpu", monkeypatch)
    out = compare_stages(jax_record(cpu, seq, after, diag), cpu,
                         "port CPU against JAX")
    assert not _failed(out, planes_same_support), _failed(
        out, planes_same_support)
