"""Planes of the port against the JAX package: the closed-form 3x3
eigensolver, PEAC-style segmentation on frames of the seed-0 arc, and the
plane landmark map (association, ring-buffer merge, insertion, the
keyframe's plane observations) on a map state carried across from JAX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu.config import SystemConfig
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.mapping import map_state as JMS
from eao_fusion_tpu.mapping import plane_map as JPM
from eao_fusion_tpu.ops import planes as JP
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.mapping import map_state as TMS
from eao_fusion_tpu_torch.mapping import plane_map as TPM
from eao_fusion_tpu_torch.ops import planes as TP
from eao_fusion_tpu_torch.types import FramePlanes, tree_from_numpy

JCFG = SystemConfig()
TCFG = TC.SystemConfig()


def _np(tree):
    return jax.tree.map(np.asarray, tree)._asdict()


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                       cache_dir=synthetic.DEFAULT_CACHE)


def _segment_both(depth):
    a = JP.segment_planes(jnp.asarray(depth), cam=JCFG.camera,
                          cfg=JCFG.planes)
    b = TP.segment_planes(torch.from_numpy(np.asarray(depth, np.float32)),
                          cam=TCFG.camera, cfg=TCFG.planes)
    return a, b


def test_eigh3_smallest_matches_jax():
    """64 random symmetric PSD matrices (seed 0) and the isotropic case
    (the degenerate branch): eigenvalue within 1e-5 of max(1, |λ|),
    eigenvector up to sign within 1e-5."""
    r = np.random.default_rng(0)
    A = r.normal(size=(64, 3, 3)).astype(np.float32)
    A = np.concatenate([A @ A.transpose(0, 2, 1),
                        np.broadcast_to(np.eye(3, dtype=np.float32),
                                        (4, 3, 3))])
    lj, vj = (np.asarray(x) for x in JP.eigh3_smallest(jnp.asarray(A)))
    lt, vt = TP.eigh3_smallest(torch.from_numpy(A))
    scale = np.maximum(np.abs(lj), 1.0)
    assert (np.abs(lt.numpy() - lj) / scale).max() < 1e-5
    dots = np.abs(np.sum(vt.numpy() * vj, axis=-1))
    assert (1.0 - dots).max() < 1e-5
    # the isotropic matrices take the fixed axis
    np.testing.assert_array_equal(vt.numpy()[-4:], np.tile([0, 0, 1.0],
                                                           (4, 1)))


@pytest.mark.parametrize("frame", [0, 10])
def test_segment_planes_matches_jax(seq, frame):
    """Same planes in the same order: |n·n'| > 1 - 1e-6, |d - d'| < 1 mm,
    support within 1%. The window sums run in another order than the JAX
    matmuls, so coefficients differ in float32 noise (measured ≤ 5e-4 m in
    d) and a window on a merge gate may flip (one window = 100 px).
    Boundary slots: the same count per plane within 1%, every valid point
    within 3 cm of both planes, and where a plane has fewer than B
    supporting samples (the sample set is then all of them) the same
    points; a full plane keeps the B nearest of many samples that lie on
    the plane to float32 noise, so which B is not compared."""
    a, b = _segment_both(seq.frames[frame].depth)
    va, vb = np.asarray(a.valid), b.valid.numpy()
    assert va.sum() >= 2
    np.testing.assert_array_equal(vb, va)
    ca, cb = np.asarray(a.coeffs)[va], b.coeffs.numpy()[va]
    assert (np.abs(np.sum(ca[:, :3] * cb[:, :3], axis=1)) > 1 - 1e-6).all()
    assert (np.abs(ca[:, 3] - cb[:, 3]) < 1e-3).all()
    na, nb = np.asarray(a.n_inliers)[va], b.n_inliers.numpy()[va]
    assert (np.abs(na - nb) <= 0.01 * na).all()

    B = JCFG.planes.max_boundary_points
    bva, bvb = np.asarray(a.boundary_valid), b.boundary_valid.numpy()
    bpa, bpb = np.asarray(a.boundary), b.boundary.numpy()
    for i in np.where(va)[0]:
        n_a, n_b = int(bva[i].sum()), int(bvb[i].sum())
        assert abs(n_a - n_b) <= max(1, 0.01 * n_a)
        pts = bpb[i][bvb[i]]
        for c in (np.asarray(a.coeffs)[i], b.coeffs.numpy()[i]):
            assert (np.abs(pts @ c[:3] + c[3]) < 0.03 + 1e-4).all()
        if n_a < B:
            sa = {tuple(p) for p in np.round(bpa[i][bva[i]], 5)}
            sb = {tuple(p) for p in np.round(pts, 5)}
            assert len(sa & sb) >= min(n_a, n_b) - 1


def _jax_planes_map(seq, frames):
    """The JAX plane map after keyframe updates with the planes of
    `frames` at their true poses, as the System makes them."""
    m = JMS.empty_map(JCFG)
    for k, fi in enumerate(frames):
        f = seq.frames[fi]
        fp = JP.segment_planes(jnp.asarray(f.depth), cam=JCFG.camera,
                               cfg=JCFG.planes)
        tcw = jnp.asarray(f.tcw)
        assoc = JPM.associate_planes(m, fp, tcw, cfg=JCFG)
        m, ids = JPM.update_plane_map(m, fp, assoc, tcw, jnp.int32(k),
                                      cfg=JCFG)
        m = JPM.record_kf_plane_obs(m, jnp.int32(k), fp, ids)
    return m


def _check_map(mt, mj, exact=("pl_valid", "pl_boundary_valid",
                              "pl_obs_count", "pl_ref_kf", "kf_pl_idx",
                              "next_pl")):
    for k in exact:
        np.testing.assert_array_equal(getattr(mt, k).numpy(),
                                      np.asarray(getattr(mj, k)), err_msg=k)
    for k in ("pl_coeff", "pl_boundary", "kf_pl_coeff"):
        np.testing.assert_allclose(getattr(mt, k).numpy(),
                                   np.asarray(getattr(mj, k)), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("frames", [(0, 6, 12), (0, 19)])
def test_plane_map_updates_match_jax(seq, frames):
    """Association, merge / insertion and the keyframe record, one
    keyframe after another on the same inputs (the JAX FramePlanes carried
    across): identical association, slots and counts, coefficients and
    boundary points within 1e-5."""
    mj = _jax_planes_map(seq, frames[:1])
    mt = TMS.from_numpy(_np(mj), "cpu")
    for k, fi in enumerate(frames[1:], start=1):
        f = seq.frames[fi]
        fpj = JP.segment_planes(jnp.asarray(f.depth), cam=JCFG.camera,
                                cfg=JCFG.planes)
        fpt = tree_from_numpy(FramePlanes, _np(fpj), "cpu")
        tcw = f.tcw.astype(np.float32)
        aj = JPM.associate_planes(mj, fpj, jnp.asarray(tcw), cfg=JCFG)
        at = TPM.associate_planes(mt, fpt, torch.from_numpy(tcw), cfg=TCFG)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        assert (np.asarray(aj) >= 0).sum() >= 2
        mj, idj = JPM.update_plane_map(mj, fpj, aj, jnp.asarray(tcw),
                                       jnp.int32(k), cfg=JCFG)
        mt, idt = TPM.update_plane_map(mt, fpt, at, torch.from_numpy(tcw), k,
                                       cfg=TCFG)
        np.testing.assert_array_equal(idt.numpy(), np.asarray(idj))
        mj = JPM.record_kf_plane_obs(mj, jnp.int32(k), fpj, idj)
        mt = TPM.record_kf_plane_obs(mt, k, fpt, idt)
        _check_map(mt, mj)


def test_two_frame_planes_on_one_landmark(seq):
    """Two frame planes matched to one landmark (and one unmatched, which
    becomes a new landmark): the later frame plane's boundary points stand
    where both write, as with the JAX scatter."""
    mj = _jax_planes_map(seq, (0,))
    mt = TMS.from_numpy(_np(mj), "cpu")
    f = seq.frames[3]
    fpj = JP.segment_planes(jnp.asarray(f.depth), cam=JCFG.camera,
                            cfg=JCFG.planes)
    fpt = tree_from_numpy(FramePlanes, _np(fpj), "cpu")
    assoc = np.full(JCFG.planes.max_planes_per_frame, -1, np.int32)
    assoc[:2] = 0
    tcw = f.tcw.astype(np.float32)
    mj2, idj = JPM.update_plane_map(mj, fpj, jnp.asarray(assoc),
                                    jnp.asarray(tcw), jnp.int32(1), cfg=JCFG)
    mt2, idt = TPM.update_plane_map(mt, fpt, torch.from_numpy(assoc),
                                    torch.from_numpy(tcw), 1, cfg=TCFG)
    np.testing.assert_array_equal(idt.numpy(), np.asarray(idj))
    assert int(mt2.pl_obs_count[0]) == int(mj.pl_obs_count[0]) + 2
    assert int(mt2.next_pl) > int(mt.next_pl)
    _check_map(mt2, mj2)
