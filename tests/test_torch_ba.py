"""Local BA of the port against the JAX package on the problem of
test_ba.py (`make_ba_problem` + `dense_to_coo`): the plain edge passes
against the Pallas kernels (interpreted), with the segment sums and the
chi2 sum against the JAX reductions that follow them, the bound
`EdgePass` on the CPU, `bundle_adjust_coo` against the JAX one, and the
duplicate (camera, point) edge. The CUDA edge kernels against the plain
versions, and bundle adjustment on the card against the CPU, run under
the `gpu` marker."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eao_fusion_tpu.ops import lie as JL
from eao_fusion_tpu.solvers import ba as JB
from eao_fusion_tpu.solvers import ba_edge_pallas as JEP
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.solvers import ba as TB
from eao_fusion_tpu_torch.solvers import ba_edge as TE
from test_ba import CAM, CFG, cam_rmse, dense_to_coo, make_ba_problem

TCFG = TC.SolverConfig()
CHI2 = dict(chi2_mono=CFG.chi2_mono, chi2_stereo=CFG.chi2_stereo)


def _coo(seed=7):
    r = np.random.default_rng(seed)
    prob, cams_gt, _ = make_ba_problem(r, noise_px=0.4)
    return dense_to_coo(prob), cams_gt


def _to_torch(coo, device="cpu"):
    return TB.BACooProblem(*[torch.as_tensor(np.array(getattr(coo, k)),
                                             device=device)
                             for k in TB.BACooProblem._fields])


def _edge_inputs(coo, active_mask=None, device="cpu"):
    """The same edge problem for both packages: the port's gather inputs
    and the Pallas kernel's channel-planar [20, E] block built from the
    same gathers."""
    C = coo.cam_pose.shape[0]
    cam_pose = np.asarray(coo.cam_pose)
    free = (np.asarray(coo.cam_valid) & ~np.asarray(coo.cam_fixed)).astype(
        np.float32)
    obs_cam = np.asarray(coo.obs_cam)
    obs_pt = np.clip(np.asarray(coo.obs_pt), 0, None).astype(np.int32)
    pts = np.asarray(coo.pt_xyz)
    R = np.asarray(JL.quat_to_rotmat(jnp.asarray(cam_pose[:, :4])))
    ein = np.concatenate([
        R.reshape(C, 9)[obs_cam].T, cam_pose[obs_cam, 4:7].T,
        pts[obs_pt].T, np.asarray(coo.obs_uv).T,
        np.asarray(coo.obs_ur)[None], np.asarray(coo.obs_inv_sigma2)[None],
        free[obs_cam][None]]).astype(np.float32)
    active = (np.asarray(coo.obs_valid) & (np.asarray(coo.obs_pt) >= 0))
    if active_mask is not None:
        active = active & active_mask
    t = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt,
                                           device=device)
    x = TE.EdgeInputs(cam_pose=t(cam_pose), pt_xyz=t(pts),
                      obs_cam=t(obs_cam, torch.int32),
                      obs_pt=t(obs_pt, torch.int32), obs_uv=t(coo.obs_uv),
                      obs_ur=t(coo.obs_ur),
                      obs_inv_sigma2=t(coo.obs_inv_sigma2), free_cam=t(free))
    return x, t(active.astype(np.float32)), jnp.asarray(ein), \
        jnp.asarray(active.astype(np.float32))


def _behind_problem():
    """test_ba's problem with a few points moved behind their cameras and
    a quarter of the edges inactive."""
    coo, _ = _coo(7)
    pts = np.asarray(coo.pt_xyz).copy()
    pts[::25, 2] = -pts[::25, 2]
    coo = coo._replace(pt_xyz=jnp.asarray(pts))
    mask = np.random.default_rng(1).random(coo.obs_cam.shape[0]) > 0.25
    return coo, mask


def test_edge_pass_full_matches_pallas():
    coo, mask = _behind_problem()
    x, act, ein, act_j = _edge_inputs(coo, mask)
    ref = JEP.edge_pass_full(ein, act_j, cam=CAM, interpret=True, **CHI2)
    out = TE.edge_pass_full_plain(x, act, cam=CAM, **CHI2)
    for a, b in zip(ref, out):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)          # channel-major [ch, E]
        scale = np.maximum(np.abs(a).max(axis=1, keepdims=True), 1e-30)
        assert (np.abs(b.numpy() - a) / scale).max() < 1e-4


def test_edge_pass_chi2_matches_pallas():
    coo, mask = _behind_problem()
    x, act, ein, act_j = _edge_inputs(coo, mask)
    ref = JEP.edge_pass_chi2(ein, act_j, cam=CAM, interpret=True, **CHI2)
    out = TE.edge_pass_chi2_plain(x, act, cam=CAM, **CHI2)
    # rtol 1e-4, not 1e-5: the port evaluates the residual one float32 op
    # at a time (numpy float32 reproduces it bit for bit), while XLA's CPU
    # compiler rearranges the interpreted kernel's arithmetic; on ~2% of
    # the edges chi2 then differs by up to 4e-5 relative
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert np.asarray(ref[2]).sum() > 0          # some edges behind


def _tgt0(coo):
    """The point row each edge is summed into (bundle_adjust_coo's tgt0):
    the window point, Pw where the edge takes no part."""
    ok0 = (np.asarray(coo.obs_valid) & (np.asarray(coo.obs_pt) >= 0)
           & np.asarray(coo.cam_valid)[np.asarray(coo.obs_cam)])
    return np.where(ok0, np.asarray(coo.obs_pt),
                    coo.pt_xyz.shape[0]).astype(np.int32)


def _sums_problem(device="cpu"):
    """_behind_problem, with every 40th edge given no point target (tgt0 =
    Pw, as if it were invalid) while it stays active: the camera sums take
    it, the point sums leave it out."""
    coo, mask = _behind_problem()
    x, act, ein, act_j = _edge_inputs(coo, mask, device=device)
    valid = np.asarray(coo.obs_valid).copy()
    valid[::40] = False
    tgt0 = torch.from_numpy(_tgt0(coo._replace(obs_valid=valid))).to(device)
    return coo, x, act, ein, act_j, tgt0


def _channel_close(ref, out, tol=1e-4):
    """Each channel (column of a [rows, ch] sum) within `tol` of its largest
    value."""
    scale = np.maximum(np.abs(ref).max(axis=0, keepdims=True), 1e-30)
    assert (np.abs(out - ref) / scale).max() < tol


def test_edge_sums_match_pallas():
    """K2's function: the plain full pass with its segment sums against
    the interpreted Pallas kernel followed by the one-hot dot_generals of
    the JAX bundle_adjust_coo, built from the same obs_cam and tgt0."""
    import jax
    coo, x, act, ein, act_j, tgt0_t = _sums_problem()
    C, Pw = coo.cam_pose.shape[0], coo.pt_xyz.shape[0]
    tgt0 = tgt0_t.numpy()
    payc, payp, y = JEP.edge_pass_full(ein, act_j, cam=CAM, interpret=True,
                                       **CHI2)
    cam_onehot = (jnp.asarray(coo.obs_cam)[None, :]
                  == jnp.arange(C)[:, None]).astype(jnp.float32)
    pt_onehot = (jnp.asarray(tgt0)[None, :]
                 == jnp.arange(Pw)[:, None]).astype(jnp.float32)
    dims = (((1,), (1,)), ((), ()))
    acc_c = jax.lax.dot_general(cam_onehot, payc, dims,
                                precision=jax.lax.Precision.HIGHEST,
                                preferred_element_type=jnp.float32)
    acc_p = jax.lax.dot_general(pt_onehot, payp, dims,
                                precision=jax.lax.Precision.HIGHEST,
                                preferred_element_type=jnp.float32)
    out = TE.edge_sums_plain(x, act, tgt0_t, cam=CAM, **CHI2)
    assert tuple(out[0].shape) == (C, 42) and tuple(out[1].shape) == (Pw, 12)
    assert (tgt0 == Pw).sum() > 0 and np.abs(np.asarray(acc_c)).max() > 0
    _channel_close(np.asarray(acc_c), out[0].numpy())
    _channel_close(np.asarray(acc_p), out[1].numpy())
    y = np.asarray(y)
    scale = np.maximum(np.abs(y).max(axis=1, keepdims=True), 1e-30)
    assert (np.abs(out[2].numpy() - y) / scale).max() < 1e-4


def test_chi2_sum_matches_pallas():
    """K3's sum: the plain Σ robust masked chi2 against jnp.sum of the
    interpreted Pallas kernel's first output, rtol 1e-4 (the per-edge
    tolerance of test_edge_pass_chi2_matches_pallas)."""
    coo, mask = _behind_problem()
    x, act, ein, act_j = _edge_inputs(coo, mask)
    ref = jnp.sum(JEP.edge_pass_chi2(ein, act_j, cam=CAM, interpret=True,
                                     **CHI2)[0])
    out = TE.chi2_sum_plain(x, act, cam=CAM, **CHI2)
    assert out.shape == () and float(ref) > 0
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-4)


def test_edge_pass_binding_on_cpu_matches_plain():
    """The bound EdgePass on CPU tensors gives the plain functions' tensors
    at new cameras and points, and never touches the kernels."""
    from eao_fusion_tpu_torch import kernels
    _, x, act, _, _, tgt0 = _sums_problem()
    before = dict(kernels.launches)
    bound = TE.EdgePass(x, tgt0, cam=CAM, **CHI2)
    r = np.random.default_rng(3)
    cam_pose = x.cam_pose + torch.from_numpy(
        r.normal(0, 1e-3, tuple(x.cam_pose.shape)).astype(np.float32))
    pt_xyz = x.pt_xyz + torch.from_numpy(
        r.normal(0, 1e-2, tuple(x.pt_xyz.shape)).astype(np.float32))
    x2 = x._replace(cam_pose=cam_pose, pt_xyz=pt_xyz)
    for got, want in (
            (bound.full(cam_pose, pt_xyz, act),
             TE.edge_sums_plain(x2, act, tgt0, cam=CAM, **CHI2)),
            ((bound.chi2_sum(cam_pose, pt_xyz, act),),
             (TE.chi2_sum_plain(x2, act, cam=CAM, **CHI2),)),
            (bound.chi2_edges(cam_pose, pt_xyz, act),
             TE.edge_pass_chi2_plain(x2, act, cam=CAM, **CHI2))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert kernels.launches == before


@pytest.mark.parametrize("order", ["random", "camera"])
def test_segment_layout_sums_match_plain(order):
    """The bind-time layout K2 sums by (`segment_layout`): the edge ids in
    a stable sort by camera and by point target, with the run starts. The
    payloads summed run by run in that order give the plain sums (float32
    sums in another order: 1e-5 of each channel's largest |term| sum), and
    edges without a point target belong to no run."""
    _, x, act, _, _, tgt0 = _sums_problem()
    if order == "camera":
        perm = torch.argsort(x.obs_cam.long(), stable=True)
        x = x._replace(**{k: getattr(x, k)[perm] for k in (
            "obs_cam", "obs_pt", "obs_uv", "obs_ur", "obs_inv_sigma2")})
        act, tgt0 = act[perm], tgt0[perm]
    C, Pw = x.cam_pose.shape[0], x.pt_xyz.shape[0]
    payc, payp, _ = TE.edge_pass_full_plain(x, act, cam=CAM, **CHI2)
    want = TE.edge_sums_plain(x, act, tgt0, cam=CAM, **CHI2)
    for keys, n, pay, ref in ((x.obs_cam, C, payc, want[0]),
                              (tgt0, Pw, payp, want[1])):
        o, start = TE.segment_layout(keys, n)
        k = keys.numpy()
        inside = (k >= 0) & (k < n)
        np.testing.assert_array_equal(
            o.numpy()[:int(start[-1])],
            np.argsort(np.where(inside, k, n), kind="stable")[:inside.sum()])
        assert int(start[0]) == 0 and int(start[-1]) == int(inside.sum())
        got = torch.stack([pay[:, o[start[i]:start[i + 1]].long()].sum(1)
                           for i in range(n)])
        scale = torch.zeros((n + 1, pay.shape[0])).index_add_(
            0, torch.from_numpy(np.where(inside, k, n)), pay.T.abs())[:n]
        assert ((got - ref).abs() <= 1e-5 * scale.amax(0) + 1e-30).all()


@pytest.mark.parametrize("seed", [7, 8])
def test_bundle_adjust_coo_matches_jax(seed):
    coo, cams_gt = _coo(seed)
    rj = JB.bundle_adjust_coo(coo, None, cam=CAM, cfg=CFG, edge_kernel=False)
    rt = TB.bundle_adjust_coo(_to_torch(coo), cam=CAM, cfg=TCFG)
    assert cam_rmse(np.asarray(rj.cam_pose), rt.cam_pose.numpy()) < 1e-4
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-3)
    agree = np.mean(rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier))
    assert agree > 0.995
    assert cam_rmse(rt.cam_pose.numpy(), cams_gt) < \
        cam_rmse(np.asarray(coo.cam_pose), cams_gt) * 0.3


def _plane_block(coo, cams_gt, seed=3):
    """Fixed-plane factors for the cameras of `make_ba_problem`: the floor
    y = 1.2 m, the back wall z = 7.5 m and a tilted side wall, measured in
    every camera under its true pose with noise (seeded numpy), one sign
    flipped, one observation invalid."""
    r = np.random.default_rng(seed)
    C = cams_gt.shape[0]
    n = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [0.8, 0.0, -0.6]])
    planes_w = np.concatenate([n, [[1.2], [7.5], [1.5]]], 1)
    R = np.asarray(JL.quat_to_rotmat(jnp.asarray(cams_gt[:, :4])))
    n_c = np.einsum("cij,fj->cfi", R, n)
    d_c = planes_w[None, :, 3] - np.einsum("cfi,ci->cf", n_c, cams_gt[:, 4:7])
    meas = np.concatenate([n_c + r.normal(0, 0.01, n_c.shape),
                           (d_c + r.normal(0, 0.01, d_c.shape))[..., None]],
                          -1)
    meas[..., :3] /= np.linalg.norm(meas[..., :3], axis=-1, keepdims=True)
    meas[2, 1] = -meas[2, 1]
    valid = np.ones((C, 3), bool)
    valid[4, 2] = False
    plane_w = np.broadcast_to(planes_w, (C, 3, 4))
    return tuple(np.ascontiguousarray(a, dtype=dt) for a, dt in (
        (plane_w, np.float32), (meas, np.float32), (valid, bool)))


def test_plane_terms_match_jax():
    """Hcc, bc and cost of the fixed-plane factors at the perturbed
    cameras, rtol 1e-5 (atol 1e-5 of each output's largest entry)."""
    coo, cams_gt = _coo(7)
    blk = _plane_block(coo, cams_gt)
    cam = np.asarray(coo.cam_pose)
    ref = JB._plane_terms(jnp.asarray(cam), *(jnp.asarray(a) for a in blk),
                          CFG)
    out = TB._plane_terms(torch.from_numpy(cam),
                          *(torch.from_numpy(a) for a in blk), TCFG)
    assert float(np.asarray(ref[2])) > 0
    for a, b in zip(ref, out):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                   atol=1e-5 * np.abs(a).max())


@pytest.mark.parametrize("seed", [7, 8])
def test_bundle_adjust_coo_with_planes_matches_jax(seed):
    """`bundle_adjust_coo` with a `plane_block` against the JAX XLA path,
    with the tolerances of the planes-off parity test."""
    coo, cams_gt = _coo(seed)
    blk = _plane_block(coo, cams_gt, seed=seed)
    rj = JB.bundle_adjust_coo(coo, tuple(jnp.asarray(a) for a in blk),
                              cam=CAM, cfg=CFG, edge_kernel=False)
    rt = TB.bundle_adjust_coo(_to_torch(coo),
                              tuple(torch.from_numpy(a) for a in blk),
                              cam=CAM, cfg=TCFG)
    assert cam_rmse(np.asarray(rj.cam_pose), rt.cam_pose.numpy()) < 1e-4
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-3)
    agree = np.mean(rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier))
    assert agree > 0.995
    assert cam_rmse(rt.cam_pose.numpy(), cams_gt) < \
        cam_rmse(np.asarray(coo.cam_pose), cams_gt) * 0.3


def test_duplicate_edge_resolves_to_one_edge():
    """A duplicated (camera, point) edge enters the Hcp grid once — the
    higher edge index wins, as the JAX scatter's last write does — and the
    solve matches the JAX one."""
    coo, _ = _coo(7)
    obs_pt = np.asarray(coo.obs_pt).copy()
    obs_uv = np.asarray(coo.obs_uv).copy()
    c1 = 128                                # camera 1's first slot
    obs_pt[c1 + 5] = obs_pt[c1 + 3]
    obs_uv[c1 + 5] = obs_uv[c1 + 3] + 3.0
    coo = coo._replace(obs_pt=jnp.asarray(obs_pt), obs_uv=jnp.asarray(obs_uv))
    tp = _to_torch(coo)
    C, Pw = coo.cam_pose.shape[0], coo.pt_xyz.shape[0]
    lut = TB.edge_lut(tp.obs_cam, tp.obs_pt.long(), C, Pw)
    assert int(lut[1, obs_pt[c1 + 3]]) == c1 + 5
    assert int((lut < tp.obs_cam.shape[0]).sum()) == int(
        (tp.obs_pt >= 0).sum()) - 1
    rj = JB.bundle_adjust_coo(coo, None, cam=CAM, cfg=CFG, edge_kernel=False)
    rt = TB.bundle_adjust_coo(tp, cam=CAM, cfg=TCFG)
    assert cam_rmse(np.asarray(rj.cam_pose), rt.cam_pose.numpy()) < 1e-4
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-3)


def test_inv3x3_matches_jax():
    r = np.random.default_rng(0)
    A = r.normal(0, 1, (50, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(TB._inv3x3(torch.from_numpy(A)).numpy(),
                               np.asarray(JB._inv3x3(jnp.asarray(A))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_edge_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, x, act, _, _, tgt0 = _sums_problem("cuda")
    bound = TE.EdgePass(x, tgt0, cam=CAM, **CHI2)
    # K2: Y per channel over the edges, the sums per channel over the rows
    ref = TE.edge_sums_plain(x, act, tgt0, cam=CAM, **CHI2)
    out = bound.full(x.cam_pose, x.pt_xyz, act)
    for a, b, dim in zip(ref, out, (0, 0, 1)):
        scale = a.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        assert ((a - b).abs() / scale).max().item() < 1e-4
    # K3's sum within 1e-5 of Σ|terms|, the same bits on every call
    terms = TE.edge_pass_chi2_plain(x, act, cam=CAM, **CHI2)[0]
    sums = torch.stack([bound.chi2_sum(x.cam_pose, x.pt_xyz, act).clone()
                        for _ in range(10)])
    assert abs(sums[0].item() - terms.sum().item()) <= \
        1e-5 * terms.abs().sum().item()
    assert torch.equal(sums, sums[:1].expand(10))
    ref3 = TE.edge_pass_chi2_plain(x, act, cam=CAM, **CHI2)
    out3 = bound.chi2_edges(x.cam_pose, x.pt_xyz, act)
    for a, b in zip(ref3[:2], out3[:2]):
        # float32 pixel residuals: the kernel's fused multiply-adds move a
        # residual by ~1e-4 px, chi2 by ~1e-3 of max(chi2, 1)
        assert ((a - b).abs() / a.abs().clamp(min=1.0)).max().item() < 1e-3
    assert torch.equal(ref3[2], out3[2])


@pytest.mark.gpu
def test_cuda_bundle_adjust_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    coo, _ = _coo(7)
    rc = TB.bundle_adjust_coo(_to_torch(coo), cam=CAM, cfg=TCFG)
    rg = TB.bundle_adjust_coo(_to_torch(coo, "cuda"), cam=CAM, cfg=TCFG)
    assert cam_rmse(rc.cam_pose.numpy(), rg.cam_pose.cpu().numpy()) < 1e-4
    agree = (rc.obs_inlier == rg.obs_inlier.cpu()).float().mean().item()
    assert agree > 0.995


@pytest.mark.gpu
def test_cuda_bundle_adjust_with_planes_matches_cpu():
    """The twin of test_cuda_bundle_adjust_matches_cpu with the fixed-plane
    factors of test_bundle_adjust_coo_with_planes_matches_jax."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    coo, cams_gt = _coo(7)
    blk = _plane_block(coo, cams_gt, seed=7)
    rc = TB.bundle_adjust_coo(_to_torch(coo),
                              tuple(torch.from_numpy(a) for a in blk),
                              cam=CAM, cfg=TCFG)
    rg = TB.bundle_adjust_coo(_to_torch(coo, "cuda"),
                              tuple(torch.from_numpy(a).cuda() for a in blk),
                              cam=CAM, cfg=TCFG)
    assert cam_rmse(rc.cam_pose.numpy(), rg.cam_pose.cpu().numpy()) < 1e-4
    np.testing.assert_allclose(float(rg.chi2), float(rc.chi2), rtol=1e-3)
    agree = (rc.obs_inlier == rg.obs_inlier.cpu()).float().mean().item()
    assert agree > 0.995
