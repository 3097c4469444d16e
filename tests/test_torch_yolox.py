"""The port's YOLOX serving lane against the JAX package: weights carried
across (`params_from_numpy`), the forward pass, decode and class-agnostic
NMS, the letterbox, the detector's submit/result protocol and `infer_arch`;
and, on the card only (`gpu`), the detector and the object lane on `cuda`
tensors against the CPU."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu.frontend import yolox as JY
from eao_fusion_tpu.frontend import yolox_train
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu_torch.frontend import yolox as TY

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "data",
                       "yolox_synth.npz")


def _tree_np(params):
    return jax.tree.map(np.asarray, params)


def _rel(a, b):
    """max |a - b| over max |b|."""
    return float(np.abs(a - b).max() / np.abs(b).max())


def _ct_frames(idx):
    seq = synthetic.generate_sequence(
        n_frames=24, seed=0, style="arc", n_objects=4, class_textures=True,
        cache_dir=synthetic.DEFAULT_CACHE)
    return [seq.frames[i] for i in idx]


def _rgb(gray):
    return np.repeat(np.asarray(gray, np.float32)[..., None], 3, axis=-1)


def test_params_from_numpy_and_forward_match_jax():
    """A random width-0.125, 8-class tree carried across: OIHW shapes, and
    the raw head outputs at 640x640 within 1e-4 of their largest value
    (float32 convolutions summed in another order)."""
    jp = JY.init_params(jax.random.PRNGKey(0), width_mult=0.125, n_classes=8)
    tp = TY.params_from_numpy(_tree_np(jp), "cpu")
    w = np.asarray(jp["dark2_down"]["w"])
    assert tp["dark2_down"]["w"].shape == (w.shape[3], w.shape[2], 3, 3)
    assert TY.infer_arch(tp) == JY.infer_arch(jp) == (1, 8)
    img = np.random.default_rng(0).uniform(0, 1, (1, 640, 640, 3)) \
        .astype(np.float32)
    rj = np.asarray(JY.yolox_forward(jp, jnp.asarray(img)))
    rt = TY.yolox_forward(tp, torch.from_numpy(img.transpose(0, 3, 1, 2)))
    assert rt.shape == rj.shape == (8400, 13)
    assert _rel(rt.numpy(), rj) < 1e-4


def _det_match(dt, dj, box_px=0.5):
    """Same kept rows and classes, boxes within `box_px`, scores within
    1e-4."""
    assert dt.shape == dj.shape
    np.testing.assert_array_equal(dt[:, 5] > 0, dj[:, 5] > 0)
    np.testing.assert_array_equal(dt[:, 0], dj[:, 0])
    np.testing.assert_allclose(dt[:, 1:5], dj[:, 1:5], rtol=0, atol=box_px)
    np.testing.assert_allclose(dt[:, 5], dj[:, 5], rtol=0, atol=1e-4)


def test_shipped_weights_give_the_same_detections():
    """`data/yolox_synth.npz` through `load_params` in both packages on two
    frames of the class-textured arc: the raw outputs within 1e-4 of their
    largest value, and the same detections."""
    jp = JY.load_params(WEIGHTS)
    tp = TY.load_params(WEIGHTS, "cpu")
    depth_mult, n_classes = TY.infer_arch(tp)
    assert (depth_mult, n_classes) == JY.infer_arch(jp)
    n_det = 0
    for f in _ct_frames([4, 16]):
        xj, sj = JY.letterbox(jnp.asarray(_rgb(f.gray)))
        xt, st = TY.letterbox(torch.from_numpy(_rgb(f.gray)))
        rj = JY.yolox_forward(jp, xj, depth_mult)
        rt = TY.yolox_forward(tp, xt, depth_mult)
        assert _rel(rt.numpy(), np.asarray(rj)) < 1e-4
        dj = np.asarray(JY.decode_and_nms(rj, sj, n_classes=n_classes))
        dt = TY.decode_and_nms(rt, st, n_classes=n_classes).numpy()
        _det_match(dt, dj)
        n_det += int((dt[:, 5] > 0).sum())
    assert n_det >= 4


def _decode_both(raw, scale=1.0, n_classes=8):
    dj = np.asarray(JY.decode_and_nms(jnp.asarray(raw), jnp.float32(scale),
                                      n_classes=n_classes))
    dt = TY.decode_and_nms(torch.from_numpy(raw), scale,
                           n_classes=n_classes).numpy()
    return dt, dj


def test_decode_and_nms_matches_jax():
    """The raw outputs of tests/test_yolox_train.py's round trip (perfect
    predictions at the assigned cells of a frame's boxes), at scale 1 and
    0.5: the same detections as the JAX package, which decode back to the
    boxes."""
    seq = synthetic.generate_sequence(n_frames=8, seed=0, style="arc",
                                      cache_dir=synthetic.DEFAULT_CACHE)
    f = seq.frames[2]
    pos, cls, reg = yolox_train.build_targets(f.boxes, 8)
    A = pos.shape[0]
    raw = np.full((A, 13), -20.0, np.float32)
    raw[:, :4] = 0.0
    raw[pos, 0:4] = reg[pos]
    raw[pos, 4] = 20.0
    raw[np.arange(A)[pos], 5 + cls[pos]] = 20.0
    for scale in (1.0, 0.5):
        dt, dj = _decode_both(raw, scale)
        _det_match(dt, dj, box_px=1e-3)
    dt = dt[dt[:, 5] > 0]
    assert len(dt) >= len(f.boxes) >= 3


def test_decode_and_nms_tied_scores():
    """Candidates with equal scores: the top-128 and the kept-first order
    break ties toward the lower anchor, as `lax.top_k` and the stable
    `jnp.argsort` do, and of two tied boxes that overlap the later anchor
    is suppressed. 100 pairs of equal-score boxes (200 > the 128
    candidates): each stride-8 anchor's box is repeated by the next
    anchor, shifted back onto it by one cell."""
    r = np.random.default_rng(4)
    A = TY._GRID.shape[0]
    raw = np.full((A, 13), -20.0, np.float32)
    raw[:, :4] = 0.0
    # stride-8 cells in even columns, so that no pair's second anchor is
    # another pair's first
    cells = np.arange(6400).reshape(80, 80)[:, 0:78:2].ravel()
    base = r.choice(cells, 100, replace=False)
    size = np.log(r.uniform(2.0, 4.0, (100, 2)))          # 16-32 px boxes
    for a, dx in ((base, 0.0), (base + 1, -1.0)):
        raw[a, 0] = dx
        raw[a, 2:4] = size
        raw[a, 4] = 2.0
        raw[a, 5 + base % 8] = 2.0
    dt, dj = _decode_both(raw)
    _det_match(dt, dj, box_px=1e-3)
    kept_t = TY.decode_and_nms(torch.from_numpy(raw), 1.0, n_classes=8)
    assert (kept_t[:, 5] > 0).all()            # 32 rows kept of the ties
    # every kept row is a lower anchor of its pair: the duplicate went
    x0 = kept_t[:, 1].numpy()
    assert len(np.unique(np.round(x0, 3))) == len(x0)


def test_letterbox_matches_jax():
    """A shape that shrinks (antialiased bilinear, as `jax.image.resize`)
    and one that grows: within 1e-5 of the JAX letterbox, and the same
    scale. 640x480 is the identity with a gray band below."""
    r = np.random.default_rng(2)
    for shape in ((960, 1280, 3), (240, 320, 3), (480, 640, 3)):
        img = r.uniform(0, 1, shape).astype(np.float32)
        xj, sj = JY.letterbox(jnp.asarray(img))
        xt, st = TY.letterbox(torch.from_numpy(img))
        assert xt.shape == (1, 3, 640, 640)
        assert abs(st - float(sj)) < 1e-7
        np.testing.assert_allclose(xt.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(xj), rtol=0, atol=1e-5)


def test_detector_protocol():
    """submit/result: nothing pending gives None; a result is consumed once;
    of two submits the latest wins."""
    jp = JY.init_params(jax.random.PRNGKey(1), width_mult=0.125, n_classes=8)
    det = TY.Detector(TY.params_from_numpy(_tree_np(jp), "cpu"),
                      n_classes=8)
    assert det.result() is None
    imgs = [np.random.default_rng(i).uniform(0, 1, (480, 640, 3))
            .astype(np.float32) for i in range(2)]
    det.submit(imgs[0])
    r0 = det.result()
    assert r0 is not None and r0.ndim == 2 and r0.shape[1] == 6
    assert (r0[:, 5] > 0).all()
    assert det.result() is None
    det.submit(imgs[0])
    det.submit(imgs[1])
    r1 = det.result()
    x, s = TY.letterbox(torch.from_numpy(imgs[1]))
    want = TY.decode_and_nms(TY.yolox_forward(det.params, x), s,
                             n_classes=8).numpy()
    np.testing.assert_array_equal(r1, want[want[:, 5] > 0])
    assert det.result() is None


def test_infer_arch():
    for depth_mult, n_classes in ((1, 8), (2, 80)):
        jp = JY.init_params(jax.random.PRNGKey(0), depth_mult=depth_mult,
                            width_mult=0.125, n_classes=n_classes)
        tp = TY.params_from_numpy(_tree_np(jp), "cpu")
        assert TY.infer_arch(tp) == (depth_mult, n_classes)


def test_weights_default_to_the_card(monkeypatch):
    """With no device named the weights go to `cuda`, and with no card
    that raises (no silent CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TY.load_params(WEIGHTS)


def test_forward_flops_counts_the_convolutions():
    """The forward's multiply-adds x 2 from the layer shapes: at width 0.5
    and depth 1 (YOLOX-s widths, 80 classes) 26.6 G at 640x640, beside
    the 26.8 G published for YOLOX-s (whose count includes the pools and
    activations left out here)."""
    jp = JY.init_params(jax.random.PRNGKey(0))
    tp = TY.params_from_numpy(_tree_np(jp), "cpu")
    assert 26.0e9 < TY.forward_flops(tp) < 26.8e9


# ----------------------------------------------------------- on the card

@pytest.mark.gpu
def test_cuda_detector_matches_cpu():
    """The shipped weights on the card against the same module on the CPU
    (TF32 off): raw outputs within 1e-4 of their largest value, the same
    detections, and the side-stream detector returns them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tc = TY.load_params(WEIGHTS, "cpu")
    tg = TY.load_params(WEIGHTS, "cuda")
    _, n_classes = TY.infer_arch(tc)
    f = _ct_frames([8])[0]
    xc, s = TY.letterbox(torch.from_numpy(_rgb(f.gray)))
    rc = TY.yolox_forward(tc, xc)
    rg = TY.yolox_forward(tg, xc.cuda())
    assert _rel(rg.cpu().numpy(), rc.numpy()) < 1e-4
    dc = TY.decode_and_nms(rc, s, n_classes=n_classes).numpy()
    dg = TY.decode_and_nms(rg, s, n_classes=n_classes).cpu().numpy()
    _det_match(dg, dc)
    det = TY.Detector(tg, n_classes=n_classes)
    det.submit(_rgb(f.gray))
    np.testing.assert_allclose(det.result(), dg[dg[:, 5] > 0], atol=1e-6)


@pytest.mark.gpu
def test_cuda_object_lane_matches_cpu():
    """The object lane on `cuda` tensors against the CPU on the module
    tests' scene: frame objects, association, the update (keyframe-rate
    forest) and the keyframe merge with the same draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import test_torch_objects as T
    from eao_fusion_tpu_torch.objects import association as TA
    from eao_fusion_tpu_torch.objects import merge as TM
    from eao_fusion_tpu_torch.objects import object_map as TO
    from eao_fusion_tpu_torch.objects import update as TU
    from eao_fusion_tpu_torch.objects.iforest import ForestDraws, draw_forest
    from eao_fusion_tpu_torch.types import FrameFeatures, tree_from_numpy

    s = T.scene()
    t = T._table(s, next_obj=7)

    def lane(dev):
        g = lambda a: torch.as_tensor(a, device=dev)        # noqa: E731
        fo = TO.build_frame_objects(
            g(s["boxes"]), tree_from_numpy(FrameFeatures, T._feats_np(s),
                                           dev),
            g(s["kp_pt"]), g(s["pt_xyz"]), g(s["pt_valid"]), g(s["tcw"]),
            cfg=T.TCFG)
        tab = tree_from_numpy(TO.ObjectTable, t, dev)
        a = TA.ensemble_associate(tab, fo, g(s["pt_xyz"]), g(s["tcw"]),
                                  T.FID, cfg=T.TCFG)
        u = TU.object_update(tab, fo, a, g(s["pt_xyz"]), g(s["tcw"]), T.FID,
                             draws(dev), cfg=T.TCFG)
        m = TM.merge_and_overlap(u, g(s["pt_xyz"]), draws(dev), cfg=T.TCFG)
        return fo, a, m

    d0 = draw_forest(torch.Generator().manual_seed(0),
                     torch.ones((8, TO.MEMBERS), dtype=torch.bool))

    def draws(dev):
        return ForestDraws(*[x.to(dev) for x in d0])

    for x, y in zip(lane("cpu"), lane("cuda")):
        for k, a in x._asdict().items():
            b = getattr(y, k).cpu()
            if a.dtype.is_floating_point:
                torch.testing.assert_close(b, a, rtol=0, atol=1e-4, msg=k)
            else:
                assert torch.equal(b, a), k
