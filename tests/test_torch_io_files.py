"""The port's dataset I/O against the JAX package on files the tests write:
the TUM readers and writers, timestamp association, the IMU alignment and
sync, the PNG encoder of the dataset writer with the native decoder and
prefetcher, and the corridor scene and nuisance model of the renderer."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu.io import imu as JI
from eao_fusion_tpu.io import synthetic as JS
from eao_fusion_tpu.io import tum as JT
from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu_torch.io import imu as TI
from eao_fusion_tpu_torch.io import native_loader
from eao_fusion_tpu_torch.io import synthetic as TS
from eao_fusion_tpu_torch.io import tum as TT
from eao_fusion_tpu_torch.ops import lie as TL
from eao_fusion_tpu_torch.tools.make_tum_dataset import encode_png

# the renders of tests/test_torch_io.py: a small camera with the fr3 field
# of view, and its tolerances
SMALL = dict(width=80, height=60, fx=535.4 / 8, fy=539.2 / 8, cx=320.1 / 8,
             cy=247.6 / 8)


def test_image_list_and_groundtruth_readers_match(tmp_path):
    p = tmp_path / "rgb.txt"
    p.write_text("# color images\n# timestamp filename\n\n"
                 "1305031102.175304 rgb/1305031102.175304.png\n"
                 "  1305031102.211214 rgb/1305031102.211214.png extra\n")
    assert TT.read_image_list(str(p)) == JT.read_image_list(str(p))
    g = tmp_path / "groundtruth.txt"
    g.write_text("# ground truth trajectory\n# timestamp tx ty tz qx qy qz "
                 "qw\n1.0 0.1 0.2 0.3 0.0 0.0 0.0 1.0\n"
                 "1.5 0.1 0.2\n"                         # short: skipped
                 "2.0 -1.25 0.5 2.0 0.1 -0.2 0.3 0.927 9.9\n")
    for a, b in zip(TT.read_groundtruth(str(g)), JT.read_groundtruth(str(g))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_accelerometer_and_box_readers_match(tmp_path):
    p = tmp_path / "accelerometer.txt"
    p.write_text("# t ax ay az\n0.00 1.0 8.5 3.0\n0.05 1.0\n"
                 "0.10 1.0 8.9 3.2 7.0\n")
    a, b = TT.read_accelerometer(str(p)), JT.read_accelerometer(str(p))
    assert len(a) == len(b) == 2
    for sa, sb in zip(a, b):
        assert sa.timestamp == sb.timestamp
        np.testing.assert_array_equal(sa.accel, sb.accel)
        np.testing.assert_array_equal(sa.gyro, sb.gyro)
    bx = tmp_path / "0.033333.txt"
    bx.write_text("3 10.5 20 30 40 0.9\n1 2 3\n\n5 1 2 3 4 0.5 extra\n")
    for path in (str(bx), str(tmp_path / "missing.txt")):
        ta, ja = TT.read_yolo_boxes(path), JT.read_yolo_boxes(path)
        assert ta.dtype == ja.dtype and ta.shape == ja.shape
        np.testing.assert_array_equal(ta, ja)


def test_associate_timestamps_matches():
    r = np.random.default_rng(0)
    a = np.sort(r.uniform(0, 2, 60))
    b = np.sort(np.concatenate([a[::2] + r.normal(0, 0.008, 30),
                                r.uniform(0, 2, 10)]))
    for max_dt in (0.005, 0.02, 0.1):
        assert (TT.associate_timestamps(a, b, max_dt)
                == JT.associate_timestamps(a, b, max_dt))


def test_written_trajectories_parse_the_same(tmp_path):
    r = np.random.default_rng(1)
    tcw = np.asarray(JL.se3_exp(jnp.asarray(
        r.normal(0, 0.3, (12, 6)).astype(np.float32))))
    ts = np.arange(12) / 30.0 + 1305031102.0
    TT.write_trajectory_tum(str(tmp_path / "t.txt"), ts, tcw)
    JT.write_trajectory_tum(str(tmp_path / "j.txt"), ts, tcw)
    for a, b in zip(TT.read_groundtruth(str(tmp_path / "t.txt")),
                    JT.read_groundtruth(str(tmp_path / "j.txt"))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # and the rows are Twc of the input
    _, twc = TT.read_groundtruth(str(tmp_path / "t.txt"))
    back = TL.se3_inverse(torch.from_numpy(twc)).numpy()
    np.testing.assert_allclose(back[:, 4:], tcw[:, 4:], atol=1e-5)
    TT.write_trajectory_kitti(str(tmp_path / "t.kitti"), tcw)
    JT.write_trajectory_kitti(str(tmp_path / "j.kitti"), tcw)
    kt = np.loadtxt(tmp_path / "t.kitti")
    kj = np.loadtxt(tmp_path / "j.kitti")
    assert kt.shape == kj.shape == (12, 12)
    np.testing.assert_allclose(kt, kj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("axis,accel", [(3, [0.3, -9.5, 1.2]),
                                        (2, [0.1, 9.8, 0.2]),
                                        (3, [1.0, 8.7, 3.1]),
                                        (2, [-4.0, -0.3, 8.8])])
def test_gravity_init_pose_matches(axis, accel):
    a = np.array(accel)
    t = TI.gravity_init_pose(a, gravity_axis=axis)
    j = JI.gravity_init_pose(a, gravity_axis=axis)
    assert t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    # the gravity direction lies on the chosen world axis (with either
    # sign: a left-handed Gram-Schmidt frame is negated whole, as in
    # InitIMU)
    R = TL.quat_to_rotmat(torch.from_numpy(t[:4])).numpy()
    e = np.eye(3)[axis - 1]
    np.testing.assert_allclose(np.abs(R.T @ (a / np.linalg.norm(a))), e,
                               atol=1e-6)


@pytest.mark.parametrize("t_img", [0.15, 0.1, -0.01, -0.2, 0.22, 0.5,
                                   0.95])
def test_sync_imu_matches(t_img):
    """Interpolated, exactly on a sample, before the first (inside and
    outside the window), after the last (inside and outside) and across a
    gap wider than both windows."""
    def samples(mod):
        return [mod.ImuSample(t, np.array([t, 2 * t, 0.5]),
                              np.array([0.0, t, -t]))
                for t in (0.0, 0.1, 0.2, 0.7, 0.71)]
    a = TI.sync_imu(samples(TI), t_img)
    b = JI.sync_imu(samples(JI), t_img)
    assert (a is None) == (b is None)
    if a is not None:
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.accel, b.accel)
        np.testing.assert_array_equal(a.gyro, b.gyro)
    assert TI.sync_imu([], 0.0) is None


def _images():
    r = np.random.default_rng(2)
    return {"rgb8": r.integers(0, 256, (48, 64, 3), dtype=np.uint8),
            "gray8": r.integers(0, 256, (48, 64), dtype=np.uint8),
            "gray16": r.integers(0, 65536, (48, 64), dtype=np.uint16)}


@pytest.mark.parametrize("kind", ["rgb8", "gray8", "gray16"])
def test_png_encoder_decodes_with_pil_and_native(kind):
    from PIL import Image
    a = _images()[kind]
    data = encode_png(a)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil.astype(a.dtype), a)
    nat, c, bd = native_loader.decode_png(data)
    assert (c, bd) == {"rgb8": (3, 8), "gray8": (1, 8),
                       "gray16": (1, 16)}[kind]
    assert nat.dtype == a.dtype
    np.testing.assert_array_equal(nat, a)


def test_png_encoder_refuses_other_types():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 4), np.uint8))


def _write_frames(tmp_path, n=4, w=64, h=48):
    r = np.random.default_rng(3)
    rgbs, deps, imgs, dimgs = [], [], [], []
    for i in range(n):
        img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        dep = (r.uniform(0.5, 5.0, (h, w)) * 5000).astype(np.uint16)
        rgbs.append(str(tmp_path / f"rgb{i}.png"))
        deps.append(str(tmp_path / f"dep{i}.png"))
        (tmp_path / f"rgb{i}.png").write_bytes(encode_png(img))
        (tmp_path / f"dep{i}.png").write_bytes(encode_png(dep))
        imgs.append(img)
        dimgs.append(dep)
    return rgbs, deps, [i / 30.0 for i in range(n)], imgs, dimgs


def test_prefetcher_fifo(tmp_path):
    """Every frame in order (FIFO, capacity 2 < frames), grey by the
    prefetcher's weights, depth in metres."""
    rgbs, deps, ts, imgs, dimgs = _write_frames(tmp_path, n=5)
    with native_loader.FramePrefetcher(rgbs, deps, ts, width=64, height=48,
                                       capacity=2) as pf:
        frames = list(pf)
    assert [f[0] for f in frames] == [0, 1, 2, 3, 4]
    for (idx, t, gray, depth), img, dep in zip(frames, imgs, dimgs):
        assert t == ts[idx]
        f = img.astype(np.float32)
        expect = (0.299 * f[..., 0] + 0.587 * f[..., 1]
                  + 0.114 * f[..., 2]) / 255.0
        np.testing.assert_allclose(gray, expect, rtol=0, atol=1e-6)
        np.testing.assert_allclose(depth, dep / np.float32(5000.0),
                                   rtol=1e-6)
    with native_loader.FramePrefetcher(rgbs, None, ts, width=64,
                                       height=48) as pf:
        assert all(d is None for *_, d in pf)


def test_prefetcher_raises_on_a_bad_frame(tmp_path):
    """A frame that does not decode stops the iteration with an error (the
    JAX loader passes over it)."""
    rgbs, deps, ts, _, _ = _write_frames(tmp_path, n=3)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    rgbs[1] = str(tmp_path / "bad.png")
    seen = []
    with pytest.raises(ValueError, match="decode"):
        with native_loader.FramePrefetcher(rgbs, deps, ts, width=64,
                                           height=48) as pf:
            for f in pf:
                seen.append(f[0])
    assert seen == [0]


def test_library_is_built_beside_the_package():
    path = native_loader.build()
    assert path.parent == native_loader.BUILD_DIR
    assert path.name.startswith("libeao_host_") and path.exists()
    assert native_loader.library() is native_loader.library()


def test_corridor_scene_and_trajectory_match():
    js, ts = JS.make_corridor_scene(seed=4), TS.make_corridor_scene(seed=4)
    np.testing.assert_array_equal(ts.textures, js.textures)
    assert len(ts.rects) == len(js.rects) and len(ts.boxes) == len(js.boxes)
    for a, b in zip(ts.boxes, js.boxes):
        np.testing.assert_array_equal(a.lo, b.lo)
        np.testing.assert_array_equal(a.hi, b.hi)
        assert (a.tex_id, a.class_id) == (b.tex_id, b.class_id)
    np.testing.assert_allclose(TS.make_trajectory(12, "corridor"),
                               JS.make_trajectory(12, "corridor"),
                               atol=1e-6)
    from eao_fusion_tpu.config import CameraConfig
    from eao_fusion_tpu_torch import config as TC
    a = JS.generate_sequence(n_frames=3, seed=4, style="corridor",
                             camera=CameraConfig(**SMALL))
    b = TS.generate_sequence(n_frames=3, seed=4, style="corridor",
                             camera=TC.CameraConfig(**SMALL))
    np.testing.assert_allclose(b.gt_tcw(), a.gt_tcw(), atol=1e-6)
    for fa, fb in zip(a.frames, b.frames):
        assert (fa.gray == fb.gray).mean() > 0.999
        np.testing.assert_allclose(fb.depth, fa.depth, atol=1e-5)
        np.testing.assert_allclose(fb.boxes, fa.boxes, atol=1e-3)


@pytest.mark.parametrize("profile", sorted(JS.NUISANCE_PROFILES))
def test_nuisance_profiles_match(profile):
    """Each profile on the same clean frames (the JAX render) gives the
    JAX package's frames: the same blur, gain, noise draws, quantization
    and holes."""
    from eao_fusion_tpu.config import CameraConfig
    a = JS.generate_sequence(n_frames=3, seed=5,
                             camera=CameraConfig(**SMALL))
    assert TS.NUISANCE_PROFILES == JS.NUISANCE_PROFILES
    na = JS.nuisance_sequence(a, profile, seed=6)
    nb = TS.nuisance_sequence(a, profile, seed=6)
    for fa, fb in zip(na.frames, nb.frames):
        np.testing.assert_allclose(fb.gray, fa.gray, rtol=0, atol=1e-6)
        np.testing.assert_allclose(fb.depth, fa.depth, rtol=0, atol=1e-6)
        assert fb.timestamp == fa.timestamp
        np.testing.assert_array_equal(fb.boxes, fa.boxes)
        np.testing.assert_array_equal(fb.tcw, fa.tcw)
    changed_gray = not np.array_equal(nb.frames[1].gray, a.frames[1].gray)
    changed_depth = not np.array_equal(nb.frames[1].depth,
                                       a.frames[1].depth)
    assert changed_gray == (profile != "depth")
    assert changed_depth == (profile in ("depth", "combo"))


@pytest.mark.gpu
def test_cuda_decoded_frames_reach_the_card_exactly(tmp_path):
    """On the card's machine: the native library builds there (g++, zlib),
    and an RGB and a depth PNG of the dataset writer decode to the arrays
    written, the prefetched frame landing on the card unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rgbs, deps, ts, imgs, dimgs = _write_frames(tmp_path, n=2)
    arr, c, bd = native_loader.decode_png(open(rgbs[0], "rb").read())
    np.testing.assert_array_equal(arr, imgs[0])
    arr, c, bd = native_loader.decode_png(open(deps[0], "rb").read())
    np.testing.assert_array_equal(arr, dimgs[0])
    with native_loader.FramePrefetcher(rgbs, deps, ts, width=64,
                                       height=48) as pf:
        for idx, _, gray, depth in pf:
            g = torch.as_tensor(gray, device="cuda")
            d = torch.as_tensor(depth, device="cuda")
            assert torch.equal(g.cpu(), torch.from_numpy(gray))
            np.testing.assert_allclose(d.cpu().numpy(),
                                       dimgs[idx] / np.float32(5000.0),
                                       rtol=1e-6)
