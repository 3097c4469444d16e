"""The object lane of the port against the JAX package, module by module:
frame objects (build and frame-to-frame merge), rect helpers, member
projection and statistics, ensemble association in every mode, the
isolation forest and its cull, the object-table update and the keyframe
merge. Inputs are made from seeds with numpy: a scene of point clusters
(objects) in front of a wall, seen by a slightly rotated camera, and table
states written directly. The randoms of the isolation forest are drawn
with `jax.random` exactly as the JAX package draws them and handed to both
packages."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu.config import ObjectConfig, SystemConfig
from eao_fusion_tpu.objects import association as JA
from eao_fusion_tpu.objects import iforest as JI
from eao_fusion_tpu.objects import merge as JM
from eao_fusion_tpu.objects import object_map as JO
from eao_fusion_tpu.objects import update as JU
from eao_fusion_tpu.types import FrameFeatures as JFeatures
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.objects import association as TA
from eao_fusion_tpu_torch.objects import iforest as TI
from eao_fusion_tpu_torch.objects import merge as TM
from eao_fusion_tpu_torch.objects import object_map as TO
from eao_fusion_tpu_torch.objects import ttable as TT
from eao_fusion_tpu_torch.objects import update as TU
from eao_fusion_tpu_torch.ops import lie as TL
from eao_fusion_tpu_torch.types import FrameFeatures, tree_from_numpy

# F = 12 frame-object slots (10 boxes: padding is exercised), O = 8 map
# objects (creation overflows the table)
OBJ = dict(max_objects_2d=12, max_map_objects=8)


def _cfgs(**kw):
    j = SystemConfig(objects=dataclasses.replace(ObjectConfig(), **OBJ, **kw))
    t = TC.SystemConfig(objects=dataclasses.replace(TC.ObjectConfig(), **OBJ,
                                                    **kw))
    return j, t


JCFG, TCFG = _cfgs()
FID = 20                                    # the current frame id
CAM = (535.4, 539.2, 320.1, 247.6)


def _np(tree):
    return {k: np.array(v) for k, v in tree._asdict().items()}


def _jt(tree_np, cls):
    return cls(**{k: jnp.asarray(v) for k, v in tree_np.items()})


def _tt(tree_np, cls):
    return tree_from_numpy(cls, tree_np, "cpu")


# ------------------------------------------------------------------ scene

# clusters in the camera frame: centre, half size, count, class
CLUSTERS = {
    "A": ((0.3, 0.1, 2.0), 0.25, 150, 0),    # > 64 members in its box
    "B": ((-0.6, 0.25, 2.4), 0.2, 90, 1),
    "C": ((0.9, -0.4, 3.0), 0.2, 40, 2),
    "D": ((-0.25, -0.5, 2.2), 0.15, 40, 3),
    "E": ((-1.3, 0.3, 2.3), 0.15, 40, 4),    # on the image border
    "G": ((0.05, 0.5, 1.8), 0.12, 40, 5),
    "H": ((0.75, 0.6, 2.6), 0.15, 40, 6),
}


@functools.lru_cache(maxsize=None)
def scene():
    """World points (clusters, then a wall at z = 4.5 m behind them), the
    camera pose, keypoints with their point ids, and the boxes."""
    r = np.random.default_rng(0)
    pc, ids = [], {}
    for name, (c, h, n, _) in CLUSTERS.items():
        start = sum(len(p) for p in pc)
        ids[name] = np.arange(start, start + n)
        pc.append(np.asarray(c) + r.uniform(-h, h, (n, 3)))
    wall = np.stack([r.uniform(-2.5, 2.5, 400), r.uniform(-1.8, 1.8, 400),
                     np.full(400, 4.5)], 1)
    pc.append(wall)
    pc = np.concatenate(pc).astype(np.float32)
    P = len(pc)
    tcw = TL.se3_exp(torch.tensor([0.01, -0.02, 0.005, 0.05, -0.03, 0.02]))
    pw = TL.se3_apply(TL.se3_inverse(tcw), torch.from_numpy(pc)).numpy()
    uv = np.stack([CAM[0] * pc[:, 0] / pc[:, 2] + CAM[2],
                   CAM[1] * pc[:, 1] / pc[:, 2] + CAM[3]], 1)
    N = 1024
    kp_uv = np.zeros((N, 2), np.float32)
    kp_uv[:P] = uv + r.normal(0, 0.3, uv.shape)
    kp_pt = np.full(N, -1, np.int32)
    kp_pt[:P] = np.arange(P)
    kp_pt[:P:13] = -1                         # keypoints with no map point
    kvalid = np.zeros(N, bool)
    kvalid[:P] = True
    kvalid[5:P:17] = False
    pt_valid = np.ones(4096, bool)
    pt_valid[3::19] = False
    pt_xyz = np.zeros((4096, 3), np.float32)
    pt_xyz[:P] = pw
    pt_valid[P:] = False

    boxes = []
    for name, (_, _, _, cls) in CLUSTERS.items():
        u = uv[ids[name]]
        lo, hi = u.min(0) - 8, u.max(0) + 8
        boxes.append([cls, lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1], 0.9])
    a = boxes[0]
    boxes.insert(1, [0, a[1] + 12, a[2] + 10, a[3] - 30, a[4] - 24, 0.8])
    boxes.append([1] + boxes[2][1:5] + [0.3])             # low score
    boxes.append([2, 300.0, 200.0, 3.0, 40.0, 0.9])       # too narrow
    return dict(pw=pw, tcw=tcw.numpy(), kp_uv=kp_uv, kp_pt=kp_pt,
                kvalid=kvalid, pt_xyz=pt_xyz, pt_valid=pt_valid,
                boxes=np.asarray(boxes, np.float32), ids=ids, uv=uv)


def _feats_np(s):
    N = len(s["kp_pt"])
    return dict(uv=s["kp_uv"], response=np.zeros(N, np.float32),
                level=np.zeros(N, np.int32), angle=np.zeros(N, np.float32),
                desc_packed=np.zeros((N, 8), np.uint32),
                desc_pm1=np.zeros((N, 256), np.int8), valid=s["kvalid"],
                depth=np.zeros(N, np.float32),
                uright=np.full(N, -1, np.float32))


def _build_both(boxes=None):
    s = scene()
    boxes = s["boxes"] if boxes is None else boxes
    fj = JO.build_frame_objects(
        jnp.asarray(boxes), _jt(_feats_np(s), JFeatures),
        jnp.asarray(s["kp_pt"]), jnp.asarray(s["pt_xyz"]),
        jnp.asarray(s["pt_valid"]), jnp.asarray(s["tcw"]), cfg=JCFG)
    ft = TO.build_frame_objects(
        torch.from_numpy(boxes), _tt(_feats_np(s), FrameFeatures),
        torch.from_numpy(s["kp_pt"]), torch.from_numpy(s["pt_xyz"]),
        torch.from_numpy(s["pt_valid"]), torch.from_numpy(s["tcw"]),
        cfg=TCFG)
    return fj, ft


EXACT_FO = ("cls", "score", "box", "valid", "kp_mask", "pt_ids", "pt_w",
            "pt_valid", "n_pts", "on_edge", "feat_rect")


# Statistics are float32 sums in another order than XLA's: the centre
# within 1e-5 m. The std is sqrt(E[x²] - E[x]²) with E[x²] ≈ 4-9 m²: the
# sums' rounding (≈ 1e-5 m² here) divided by 2·std (≈ 0.2-0.3 m) moves it
# by up to ≈ 5e-5 m, so it is held to 1e-4 m.
CENTRE_TOL, STD_TOL = 1e-5, 1e-4


def _assert_fo(fj, ft):
    """Masks, ids, member positions and rects equal; centre and std within
    their tolerances."""
    a, b = _np(fj), TO.FrameObjects(*ft)
    for k in EXACT_FO:
        np.testing.assert_array_equal(getattr(b, k).numpy(), a[k], err_msg=k)
    for k, tol in (("center", CENTRE_TOL), ("std", STD_TOL)):
        np.testing.assert_allclose(getattr(b, k).numpy(), a[k], rtol=0,
                                   atol=tol, err_msg=k)


# -------------------------------------------------------------- the table

def _table(s, next_obj=6):
    """Rows that each association gate decides for one frame object:
    0 IoU (box A seen last frame; its slots nearly full, so the frame's
    new members overflow them), 1 NP (B, not seen for 4 frames), 2
    projected box (15 of C's points, 3 observations), 3 t-test (15 of D's
    points, 12 observations), 4 a second class-0 object over A (a
    potential), 5 invalid."""
    O, M = 8, TO.MEMBERS
    ids = {k: v[s["pt_valid"][v]] for k, v in s["ids"].items()}
    t = _np(JO.empty_table(JCFG))
    box = {n: s["boxes"][i] for i, n in enumerate(["A", "A2", "B", "C", "D",
                                                   "E", "G", "H"])}

    def rect(b, dx=0.0, dy=0.0):
        return np.array([b[1] + dx, b[2] + dy, b[1] + b[3] + dx,
                         b[2] + b[4] + dy], np.float32)

    def row(o, cls, members, n_frames, last):
        t["cls"][o], t["valid"][o] = cls, True
        t["pt_idx"][o, :len(members)] = members
        t["pt_ok"][o, :len(members)] = True
        t["pt_addcnt"][o, :len(members)] = 1 + np.arange(len(members)) % 12
        t["n_frames"][o] = n_frames
        t["last_frame"][o], t["lastlast_frame"][o] = last, last - 1

    row(0, 0, np.resize(ids["A"][70:], 250), 5, FID - 1)
    t["last_rect"][0] = rect(box["A"], 3, 2)
    t["lastlast_rect"][0] = rect(box["A"], 6, 4)
    row(1, 1, ids["B"][10:70], 6, FID - 4)
    t["last_rect"][1] = rect(box["B"], 30, 0)
    row(2, 2, ids["C"][:15], 3, FID - 3)
    row(3, 3, ids["D"][:15], 12, FID - 5)
    row(4, 0, ids["A"][60:75], 2, FID - 6)
    row(5, 1, ids["B"][:40], 4, FID - 2)
    t["valid"][5] = False
    t["next_obj"] = np.int32(next_obj)
    tab = JO.member_stats(_jt(t, JO.ObjectTable), jnp.asarray(s["pt_xyz"]))
    t = _np(tab)
    # the frame-centre history: the member centre, spread 5 cm
    df = t["n_frames"][:, None].astype(np.float32)
    t["cen_sum"] = df * t["center"]
    t["cen_sq"] = df * (t["center"] ** 2 + 0.05 ** 2)
    t["sametime"][0, 2] = t["sametime"][2, 0] = 1
    t["reobj"][3, 1] = 2
    return t


def _assert_tables(tj, tt):
    """Every field equal, the statistics within their tolerances (the
    cuboid and rmax as the centre)."""
    a = _np(tj)
    for k, v in tt._asdict().items():
        if k in ("center", "std", "cub_min", "cub_max", "rmax"):
            np.testing.assert_allclose(
                v.numpy(), a[k], rtol=0,
                atol=STD_TOL if k == "std" else CENTRE_TOL, err_msg=k)
        elif k in ("cen_sum", "cen_sq"):
            # sums of frame-object centres (and their squares): a float32
            # ulp of the sum on top of the centre's tolerance
            np.testing.assert_allclose(v.numpy(), a[k], rtol=2.5e-7,
                                       atol=CENTRE_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), a[k], err_msg=k)


# ---------------------------------------------------------------- helpers

def test_ttable_crit_clamps_df():
    df = torch.tensor([-3, 0, 1, 5, 121, 400])
    for col in (TT.COL_ALPHA_05, TT.COL_ALPHA_001):
        np.testing.assert_array_equal(TT.crit(df, col).numpy(),
                                      TT.T_TABLE[[1, 1, 1, 5, 121, 121], col])
    assert abs(TT.crit(torch.tensor(10), TT.COL_ALPHA_05) - 2.228) < 1e-3


def test_rect_helpers_match_jax():
    r = np.random.default_rng(1)
    a = r.uniform(0, 600, (64, 4)).astype(np.float32)
    a[:, 2:] = a[:, :2] + r.uniform(-20, 120, (64, 2))   # some inverted
    b = np.roll(a, 7, axis=0) + r.normal(0, 30, a.shape).astype(np.float32)
    for jf, tf in ((JO.rect_iou, TO.rect_iou),
                   (JO.rect_overlap_former, TO.rect_overlap_former)):
        want = np.asarray(jf(jnp.asarray(a)[:, None], jnp.asarray(b)[None]))
        got = tf(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # the oracle of tests/test_objects.py
    x, y = torch.tensor([0., 0, 10, 10]), torch.tensor([5., 5, 15, 15])
    assert abs(float(TO.rect_iou(x, y)) - 25 / 175) < 1e-6
    assert abs(float(TO.rect_overlap_former(x, y)) - 0.25) < 1e-6


# --------------------------------------------------------- frame objects

def test_build_frame_objects_matches_jax():
    """The scene's ten boxes: A has > 64 members (the sample's tie order),
    the wall behind every box (the IQR and anchor gates), E on the border,
    a low-score and a too-narrow box; two padding slots."""
    fj, ft = _build_both()
    _assert_fo(fj, ft)
    assert int(ft.n_pts[0]) > TO.SAMPLE
    assert bool(ft.on_edge[5]) and not bool(ft.on_edge[0])
    assert not ft.valid[8:].any() and ft.valid[:8].all()
    # the wall behind A is cut, by the IQR or the anchor gate
    s = scene()
    wall = torch.arange(len(s["kp_pt"])) >= sum(
        len(v) for v in s["ids"].values())
    assert not (ft.kp_mask[0] & wall).any()


def test_build_frame_objects_with_more_boxes_than_slots():
    s = scene()
    boxes = np.concatenate([s["boxes"], s["boxes"]])           # 20 > F
    _assert_fo(*_build_both(boxes))


def test_merge_frame_objects_matches_jax():
    """The current frame's objects absorb last frame's members: last frame
    is the same scene with the boxes moved 4 px and its samples' ids
    shifted, so that most absorbed ids are new; some are no longer valid
    points."""
    s = scene()
    fj, ft = _build_both()
    moved = s["boxes"].copy()
    moved[:, 1:3] += 4.0
    lj, lt = _build_both(moved)
    l_np = _np(lj)
    l_np["pt_ids"] = np.where(l_np["pt_ids"] >= 0, l_np["pt_ids"] + 3, -1)
    pv = s["pt_valid"].copy()
    pv[::23] = False
    mj = JO.merge_frame_objects(fj, _jt(l_np, JO.FrameObjects),
                                jnp.asarray(pv), cfg=JCFG)
    mt = TO.merge_frame_objects(ft, _tt(l_np, TO.FrameObjects),
                                torch.from_numpy(pv), cfg=TCFG)
    _assert_fo(mj, mt)
    assert (mt.n_pts > ft.n_pts).any()
    assert (mt.pt_valid.sum(1) > ft.pt_valid.sum(1)).any()


def test_project_members_and_member_stats_match_jax():
    s = scene()
    t = _table(s)
    tj, tt = _jt(t, JO.ObjectTable), _tt(t, TO.ObjectTable)
    xyz = s["pt_xyz"]
    uj, okj, rj = JO.project_members(tj, jnp.asarray(xyz),
                                     jnp.asarray(s["tcw"]), CAM, 640, 480)
    ut, okt, rt = TO.project_members(tt, torch.from_numpy(xyz),
                                     torch.from_numpy(s["tcw"]), CAM, 640,
                                     480)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    np.testing.assert_allclose(ut.numpy()[ok], np.asarray(uj)[ok], atol=1e-3)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)
    # member statistics after some members dropped out
    t["pt_ok"][:, ::3] = False
    _assert_tables(JO.member_stats(_jt(t, JO.ObjectTable), jnp.asarray(xyz)),
                   TO.member_stats(_tt(t, TO.ObjectTable),
                                   torch.from_numpy(xyz)))


# ----------------------------------------------------------- association

def _jax_rank_counts(fo, tab, pt_xyz):
    """w12 / w21 as `eao_fusion_tpu/objects/association.py:82-90` computes
    them."""
    ow = pt_xyz[jnp.clip(tab.pt_idx, 0, None)]
    fw = fo.pt_w
    pair_ok = fo.pt_valid[:, None, :, None] & tab.pt_ok[None, :, None, :]
    gt = fw[:, None, :, None, :] > ow[None, :, None, :, :]
    lt = fw[:, None, :, None, :] < ow[None, :, None, :, :]
    return (np.asarray(jnp.sum(gt & pair_ok[..., None], axis=(2, 3))),
            np.asarray(jnp.sum(lt & pair_ok[..., None], axis=(2, 3))))


@pytest.mark.parametrize("mode", ["Full", "NA", "IoU", "NP"])
def test_ensemble_associate_matches_jax(mode):
    """Target, method and potential equal in every mode, and the rank-sum
    counts equal as integers. In "Full" each gate decides at least one
    frame object."""
    s = scene()
    jc, tc = _cfgs(mode=mode)
    fj, ft = _build_both()
    t = _table(s)
    xyz, tcw = s["pt_xyz"], s["tcw"]
    aj = JA.ensemble_associate(_jt(t, JO.ObjectTable), fj, jnp.asarray(xyz),
                               jnp.asarray(tcw), jnp.int32(FID), cfg=jc)
    at = TA.ensemble_associate(_tt(t, TO.ObjectTable), ft,
                               torch.from_numpy(xyz), torch.from_numpy(tcw),
                               FID, cfg=tc)
    for k in ("target", "method", "potential"):
        np.testing.assert_array_equal(getattr(at, k).numpy(),
                                      np.asarray(getattr(aj, k)), err_msg=k)
    w12j, w21j = _jax_rank_counts(fj, _jt(t, JO.ObjectTable),
                                  jnp.asarray(xyz))
    w12t, w21t = TA.rank_counts(ft.pt_w, ft.pt_valid,
                                torch.from_numpy(xyz)[
                                    torch.from_numpy(t["pt_idx"]).clamp(min=0)
                                    .long()], torch.from_numpy(t["pt_ok"]))
    np.testing.assert_array_equal(w12t.numpy(), w12j)
    np.testing.assert_array_equal(w21t.numpy(), w21j)
    if mode == "Full":
        assert {1, 2, 3, 4} <= set(at.method.tolist())
        assert at.potential.any()
        assert (at.target >= 0).sum() >= 5


# -------------------------------------------------------- isolation forest

@functools.partial(jax.jit, static_argnames=("n_trees", "depth", "sample"))
def _jax_draws(keys, valid, n_trees=50, depth=8, sample=64):
    """The draws of `iforest.anomaly_scores` for each (key, valid row), made
    as it makes them: split(key, 3); choice over valid points; per tree
    split(kd, depth) / split(ks, depth) and per level randint(0, 3) and
    uniform, in heap order."""
    M = valid.shape[-1]

    def one(key, v):
        k_samp, k_dim, k_split = jax.random.split(key, 3)
        w = v.astype(jnp.float32)
        p = w / jnp.maximum(w.sum(), 1.0)
        samp = jax.random.choice(k_samp, M, shape=(n_trees, sample),
                                 replace=True, p=p)

        def tree(kd, ks):
            kds = jax.random.split(kd, depth)
            kss = jax.random.split(ks, depth)
            dims = [jax.random.randint(kds[lv], (1 << lv,), 0, 3)
                    for lv in range(depth)]
            frac = [jax.random.uniform(kss[lv], (1 << lv,))
                    for lv in range(depth)]
            return jnp.concatenate(dims), jnp.concatenate(frac)

        dims, frac = jax.vmap(tree)(jax.random.split(k_dim, n_trees),
                                    jax.random.split(k_split, n_trees))
        return samp, dims, frac

    return jax.vmap(one)(keys, valid)


def _draws(keys, valid_np):
    samp, dims, frac = _jax_draws(keys, jnp.asarray(valid_np))
    return TI.ForestDraws(torch.from_numpy(np.array(samp)).long(),
                          torch.from_numpy(np.array(dims)).long(),
                          torch.from_numpy(np.array(frac)))


def _point_sets(seed, K=6, M=96):
    """K sets of M points: a cluster, a few far outliers, some invalid;
    one set too small to cull (< 30 valid)."""
    r = np.random.default_rng(seed)
    pts = r.normal(0, 0.1, (K, M, 3)).astype(np.float32)
    pts[:, :4] += r.uniform(0.8, 1.5, (K, 4, 3)).astype(np.float32)
    valid = r.uniform(size=(K, M)) > 0.1
    valid[-1, 25:] = False
    return pts, valid


def test_anomaly_scores_and_cull_mask_match_jax():
    """Scores within 1e-5 on the JAX draws; cull masks equal except where a
    score lies within 1e-5 of the threshold."""
    pts, valid = _point_sets(3)
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, len(pts))
    draws = _draws(keys, valid)
    sj = np.stack([np.asarray(JI.anomaly_scores(jnp.asarray(p), jnp.asarray(v),
                                                k, n_trees=50))
                   for p, v, k in zip(pts, valid, keys)])
    st = TI.anomaly_scores(torch.from_numpy(pts), torch.from_numpy(valid),
                           draws).numpy()
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5)
    assert (st[~valid] == 0).all()
    for thr in (0.6, 0.65):
        mj = np.stack([np.asarray(JI.cull_mask(jnp.asarray(p), jnp.asarray(v),
                                               k, thr, n_trees=50))
                       for p, v, k in zip(pts, valid, keys)])
        mt = TI.cull_mask(torch.from_numpy(pts), torch.from_numpy(valid),
                          draws, thr).numpy()
        near = np.abs(sj - thr) < 1e-5
        np.testing.assert_array_equal(mt[~near], mj[~near])
        assert mt[:, :4].sum() >= 8               # the outliers go
        assert not mt[-1].any()                   # < 30 points: no-op


def test_draw_forest_shapes_and_support():
    g = torch.Generator().manual_seed(0)
    valid = torch.zeros((3, 40), dtype=torch.bool)
    valid[0, 5:9] = True
    valid[1] = True                                # row 2: none valid
    d = TI.draw_forest(g, valid, n_trees=7)
    assert d.samp_idx.shape == (3, 7, 64) and d.dims.shape == (3, 7, 255)
    assert ((d.samp_idx[0] >= 5) & (d.samp_idx[0] < 9)).all()
    assert d.dims.min() >= 0 and d.dims.max() <= 2
    assert ((d.frac >= 0) & (d.frac < 1)).all()


def _cull_table(s):
    """The association table with outliers among three rows' members and
    a skipped class on one row."""
    t = _table(s)
    wall = np.arange(sum(len(v) for v in s["ids"].values()),
                     sum(len(v) for v in s["ids"].values()) + 400)
    for o in (1, 2, 3):
        n = int(t["pt_ok"][o].sum())
        t["pt_idx"][o, n:n + 30] = s["ids"]["A" if o != 1 else "B"][:30]
        t["pt_idx"][o, n + 30:n + 34] = wall[4 * o:4 * o + 4]
        t["pt_ok"][o, n:n + 34] = True
    t["cls"][4] = 64                                # never culled
    t["cls"][2] = 62                                # threshold 0.65
    return t


@pytest.mark.parametrize("compact", [0, 4])
def test_iforest_cull_matches_jax(compact):
    """The full table (compact 0) and the 4 most recently seen gated rows
    (compact 4), with the JAX draws for the rows culled."""
    s = scene()
    t = _cull_table(s)
    key = jax.random.PRNGKey(5)
    xyz = s["pt_xyz"]
    touched = np.array([1, 1, 1, 1, 1, 0, 1, 0], bool)
    tj = JU.iforest_cull(_jt(t, JO.ObjectTable), jnp.asarray(xyz), key,
                         jnp.asarray(touched), cfg=JCFG, compact=compact)
    gate = t["valid"] & touched & ~np.isin(t["cls"], JU.IFOREST_SKIP_CLASSES)
    if compact:
        score = np.where(gate, t["last_frame"], -1)
        rows = np.argsort(-score, kind="stable")[:compact]
    else:
        rows = np.arange(len(gate))
    draws = _draws(jax.random.split(key, len(rows)), t["pt_ok"][rows])
    tt = TU.iforest_cull(_tt(t, TO.ObjectTable), torch.from_numpy(xyz),
                         draws, torch.from_numpy(touched), cfg=TCFG,
                         compact=compact)
    _assert_tables(tj, tt)
    assert (tt.pt_ok.sum() < torch.from_numpy(t["pt_ok"]).sum())


# ---------------------------------------------------------- object update

@pytest.mark.parametrize("kf_rate", [True, False])
def test_object_update_matches_jax(kf_rate):
    """One update from the association of the scene: two frame objects on
    row 0 (the smaller loses), row 0's free slots overflow, projection
    culling, three objects to create with one row left (next_obj 7), and
    the co-occurrence and potential counters. With `iforest_keyframe_rate`
    False the forest culls every touched row on the JAX draws."""
    s = scene()
    jc, tc = _cfgs(iforest_keyframe_rate=kf_rate)
    t = _table(s, next_obj=7)
    fj, ft = _build_both()
    xyz, tcw = s["pt_xyz"], s["tcw"]
    aj = JA.ensemble_associate(_jt(t, JO.ObjectTable), fj, jnp.asarray(xyz),
                               jnp.asarray(tcw), jnp.int32(FID), cfg=jc)
    key = jax.random.PRNGKey(3)
    uj = JU.object_update(_jt(t, JO.ObjectTable), fj, aj, jnp.asarray(xyz),
                          jnp.asarray(tcw), jnp.int32(FID), key, cfg=jc)
    a_np = _np(aj)
    if kf_rate:
        rand = torch.Generator().manual_seed(0)          # not used
    else:
        # the forest's rows are the table as it stands before the cull
        pre = JU.object_update(_jt(t, JO.ObjectTable), fj, aj,
                               jnp.asarray(xyz), jnp.asarray(tcw),
                               jnp.int32(FID), key, cfg=JCFG)
        rand = _draws(jax.random.split(key, 8), np.asarray(pre.pt_ok))
    ut = TU.object_update(_tt(t, TO.ObjectTable), ft,
                          _tt(a_np, TA.AssocResult), torch.from_numpy(xyz),
                          torch.from_numpy(tcw), FID, rand, cfg=tc)
    _assert_tables(uj, ut)
    assert int(ut.next_obj) == 8
    assert int((torch.from_numpy(a_np["target"]) == 0).sum()) == 2
    assert int(ut.pt_ok[0].sum()) == TO.MEMBERS or not kf_rate


# ----------------------------------------------------------------- merge

def _merge_table():
    """Rows where each case of merge_and_overlap fires: 0/1 a potential
    merge (reobj 4, never together), 2/3 an overlap merge (same class,
    cuboid IoU >= 0.3), 4/5 a false detection (5 inside 4, a ninth of its
    size or less, seen less), 6 a lone object with outliers."""
    r = np.random.default_rng(9)
    pts, rows = [], []
    for centre, half, n in (((0, 0, 2), 0.2, 40), ((0.1, 0, 2.1), 0.15, 35),
                            ((1, 0, 3), 0.2, 40), ((1.05, 0.02, 3), 0.2, 40),
                            ((-1, 0, 3), 0.3, 50), ((-1, 0.05, 3), 0.1, 32),
                            ((0, 1, 3), 0.1, 60)):
        start = sum(len(p) for p in pts)
        pts.append(np.asarray(centre) + r.uniform(-half, half, (n, 3)))
        rows.append(np.arange(start, start + n))
    pts[-1][:4] += 1.2                                 # outliers of row 6
    xyz = np.zeros((1024, 3), np.float32)
    allp = np.concatenate(pts).astype(np.float32)
    xyz[:len(allp)] = allp
    t = _np(JO.empty_table(JCFG))
    for o, (ids, cls, nf) in enumerate(zip(rows, (0, 0, 1, 1, 2, 2, 3),
                                           (10, 4, 6, 5, 8, 3, 7))):
        t["cls"][o], t["valid"][o] = cls, True
        t["pt_idx"][o, :len(ids)] = ids
        t["pt_ok"][o, :len(ids)] = True
        t["n_frames"][o] = nf
        t["last_frame"][o] = 30 - o
        t["cen_sum"][o] = nf * allp[ids].mean(0)
        t["cen_sq"][o] = nf * (allp[ids].mean(0) ** 2)
    t["reobj"][0, 1] = t["reobj"][1, 0] = 4
    t["sametime"][2, 3] = t["sametime"][3, 2] = 2
    t["sametime"][4, 6] = t["sametime"][6, 4] = 5
    t["next_obj"] = np.int32(7)
    tab = JO.member_stats(_jt(t, JO.ObjectTable), jnp.asarray(xyz))
    return _np(tab), xyz


def test_merge_and_overlap_matches_jax():
    """Three rounds, member statistics, and the keyframe-rate forest on
    the JAX draws. Each case fires: 0 absorbs 1, 2 absorbs 3,
    5 is erased, and row 6 loses its outliers."""
    t, xyz = _merge_table()
    key = jax.random.PRNGKey(8)
    mj = JM.merge_and_overlap(_jt(t, JO.ObjectTable), jnp.asarray(xyz), key,
                              cfg=JCFG)
    # the forest's rows are the table as the three rounds leave it
    jna, _ = _cfgs(mode="NA")
    pre = JM.merge_and_overlap(_jt(t, JO.ObjectTable), jnp.asarray(xyz), key,
                               cfg=jna)
    draws = _draws(jax.random.split(key, 8), np.asarray(pre.pt_ok))
    mt = TM.merge_and_overlap(_tt(t, TO.ObjectTable), torch.from_numpy(xyz),
                              draws, cfg=TCFG)
    _assert_tables(mj, mt)
    assert mt.valid.tolist() == [True, False, True, False, True, False,
                                 True, False]
    assert int(mt.n_frames[0]) == 14 and int(mt.n_frames[2]) == 11
    assert int(mt.pt_ok[6].sum()) < 60
