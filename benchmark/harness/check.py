"""What decides `correct`: the answers of the timed path, captured in the
window, against the plain reference (`benchmark/reference/`), worked out
once the window has closed.

Captured, for calls drawn from the seed among the window's first calls
of each kind (the program's own inputs and outputs, copied on the device
when the call is drawn):
  features     `extractor.extract_features` (the front end): the frame's
               keypoints and descriptors, from the stream's own image
  planes       `planes.segment_planes`: the frame's planes, from the
               stream's own depth image
  pose         `pose_opt.optimize_pose` (K1's path): the pose it solved
  local_ba     `ba.bundle_adjust_coo` (K2-K4's path): the window cameras
  object       `update.object_update` (the object lane): the object table
and, for every frame of the window, the pose that `slam_chunk` reports.

Numbers compared, each against the cell's limit (workloads/<cell>.json):
  feature_miss_pct    keypoints (level and pixel) of the drawn frames that
                      only one of the program and the reference has, in %
                      of the reference's
  desc_bits_pct       descriptor bits that differ on the keypoints both
                      have, in % of their bits
  plane_mismatch      planes of the drawn frames whose presence, support
                      or boundary count differ from the reference's
  plane_gap           the largest gap of the planes of equal rank: the
                      angle between normals (rad) or the offsets'
                      difference (m)
  pose_gap            max over the drawn solves of max(|dt| m, angle rad)
                      between the program's pose and the reference's
  ba_gap              the same over the drawn local BAs' free cameras
  object_mismatch     entries of the drawn object updates' membership and
                      counters that differ from the reference's (exact)
  object_gap          the largest gap of their centres, cuboids, radii,
                      centre sums (m) and boxes (px)
  object_spread_gap   the largest gap of their members' spread (m)
  frozen_frames       window frames that passed the tracker's own gate of
                      inliers and report, bit for bit, the pose of the
                      frame before while the ground truth moved: a pose
                      that is not the frame's own answer
A number with nothing to compare (no drawn call was reached) is missing,
and a missing number is not correct."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import features as rfeat
from benchmark.reference import lie as rlie
from benchmark.reference import local_ba, objects as robj
from benchmark.reference import planes as rplanes
from benchmark.reference import pose as rpose

TARGETS = {
    "features": ("eao_fusion_tpu_torch.frontend.extractor",
                 "extract_features"),
    "planes": ("eao_fusion_tpu_torch.ops.planes", "segment_planes"),
    "pose": ("eao_fusion_tpu_torch.solvers.pose_opt", "optimize_pose"),
    "local_ba": ("eao_fusion_tpu_torch.solvers.ba", "bundle_adjust_coo"),
    "object": ("eao_fusion_tpu_torch.objects.update", "object_update"),
}
ORB_KEYS = ("n_levels", "scale_factor", "ini_th_fast", "min_th_fast",
            "max_keypoints", "cell_size", "blur_sigma")
PLANE_KEYS = ("window", "mse_max", "merge_normal_dot", "merge_dist",
              "n_merge_sweeps", "min_support_px", "max_planes_per_frame",
              "max_boundary_points")
FO_FIELDS = ("cls", "box", "valid", "pt_ids", "pt_w", "pt_valid", "n_pts",
             "center", "on_edge")
SOLVER_KEYS = ("pose_rounds", "pose_iters_per_round", "chi2_mono",
               "chi2_stereo", "plane_angle_info", "plane_dist_info",
               "plane_chi2")


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x) if not hasattr(x, "_fields") \
            else type(x)(*(_clone(v) for v in x))
    return x


def _fields(m, names):
    return {n: getattr(m, n).detach().clone() for n in names}


class Capture:
    """Wraps the program's functions named in `plan` ({kind: {"samples":
    n, "within": R}}) while installed, and copies the inputs and outputs
    of the calls whose index (counted per kind from installation) was
    drawn from the seed: n of the first R."""

    def __init__(self, plan: dict, seed: int):
        rng = np.random.default_rng([int(seed), 17])
        self.draws = {}
        for kind, spec in plan.items():
            R, n = int(spec["within"]), int(spec["samples"])
            self.draws[kind] = set(
                rng.choice(R, size=min(n, R), replace=False).tolist())
        self.calls = {k: 0 for k in plan}
        self.items = {k: [] for k in plan}
        self._saved = []

    def _take(self, kind) -> bool:
        i = self.calls[kind]
        self.calls[kind] += 1
        return i in self.draws[kind]

    def install(self) -> None:
        import importlib
        for kind in self.draws:
            mod_name, attr = TARGETS[kind]
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, getattr(self, f"_wrap_{kind}")(orig))

    def remove(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []

    def _wrap_pose(self, orig):
        def optimize_pose(pose0, obs, plane_obs=None, *, cam, cfg):
            if not self._take("pose"):
                return orig(pose0, obs, plane_obs, cam=cam, cfg=cfg)
            item = dict(pose0=_clone(pose0), obs=_clone(tuple(obs)),
                        planes=None if plane_obs is None
                        else _clone(tuple(plane_obs)), cam=tuple(cam),
                        p={k: getattr(cfg, k) for k in SOLVER_KEYS})
            res = orig(pose0, obs, plane_obs, cam=cam, cfg=cfg)
            item["out"] = res.pose.detach().clone()
            self.items["pose"].append(item)
            return res
        return optimize_pose

    def _wrap_local_ba(self, orig):
        def bundle_adjust_coo(prob, plane_block=None, *, cam, cfg, **kw):
            if not self._take("local_ba"):
                return orig(prob, plane_block, cam=cam, cfg=cfg, **kw)
            item = dict(prob={k: _clone(v) for k, v in
                              prob._asdict().items()},
                        planes=_clone(plane_block), cam=tuple(cam),
                        p={k: getattr(cfg, k) for k in SOLVER_KEYS},
                        kw=dict(n_iters1=kw.get("n_iters1", 5),
                                n_iters2=kw.get("n_iters2", 10),
                                damping=kw.get("damping", 1e-3),
                                ftol=kw.get("ftol", 1e-4)))
            res = orig(prob, plane_block, cam=cam, cfg=cfg, **kw)
            item["out"] = res.cam_pose.detach().clone()
            self.items["local_ba"].append(item)
            return res
        return bundle_adjust_coo

    def _wrap_features(self, orig):
        def extract_features(img, depth=None, *, orb_cfg, cam_cfg,
                             with_depth=True):
            out = orig(img, depth, orb_cfg=orb_cfg, cam_cfg=cam_cfg,
                       with_depth=with_depth)
            if self._take("features"):
                self.items["features"].append(dict(
                    img=img.detach().clone(),
                    p={k: getattr(orb_cfg, k) for k in ORB_KEYS},
                    out={k: getattr(out, k).detach().clone() for k in (
                        "uv", "level", "valid", "desc_packed")}))
            return out
        return extract_features

    def _wrap_planes(self, orig):
        def segment_planes(depth, *, cam, cfg):
            out = orig(depth, cam=cam, cfg=cfg)
            if self._take("planes"):
                self.items["planes"].append(dict(
                    depth=depth.detach().clone(),
                    cam=(cam.fx, cam.fy, cam.cx, cam.cy),
                    p={k: getattr(cfg, k) for k in PLANE_KEYS},
                    out={k: getattr(out, k).detach().clone() for k in (
                        "coeffs", "n_inliers", "valid", "boundary_valid")}))
            return out
        return segment_planes

    def _wrap_object(self, orig):
        def object_update(tab, fo, assoc, pt_xyz, tcw, frame_id, rand, *,
                          cfg):
            oc = cfg.objects
            plain = oc.mode in ("None", "NA") or oc.iforest_keyframe_rate
            if not (plain and self._take("object")):
                return orig(tab, fo, assoc, pt_xyz, tcw, frame_id, rand,
                            cfg=cfg)
            cam = cfg.camera
            item = dict(tab=_fields(tab, tab._fields),
                        fo=_fields(fo, FO_FIELDS),
                        target=assoc.target.clone(),
                        potential=assoc.potential.clone(),
                        pt_xyz=pt_xyz.clone(), tcw=tcw.clone(),
                        fid=int(frame_id), W=cam.width, H=cam.height,
                        cam=(cam.fx, cam.fy, cam.cx, cam.cy),
                        min_points=oc.min_points_init)
            out = orig(tab, fo, assoc, pt_xyz, tcw, frame_id, rand, cfg=cfg)
            item["out"] = _fields(out, out._fields)
            self.items["object"].append(item)
            return out
        return object_update


# ------------------------------------------------------------- the numbers

def _np(d: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in d.items()}


def feature_numbers(items):
    """(feature_miss_pct, desc_bits_pct) over the drawn frames."""
    if not items:
        return None, None
    miss, n_ref, both, bits = 0, 0, 0, 0
    for it in items:
        ref = rfeat.extract(it["img"].cpu().numpy(), it["p"])
        o = _np(it["out"])
        prog = rfeat.program_features(o["uv"], o["level"], o["valid"],
                                      o["desc_packed"],
                                      it["p"]["scale_factor"])
        m, b, nb = rfeat.gaps(prog, ref)
        miss, n_ref, both, bits = miss + m, n_ref + len(ref), both + b, \
            bits + nb
    return (100.0 * miss / max(n_ref, 1),
            100.0 * bits / max(256 * both, 1))


def plane_numbers(items):
    """(plane_mismatch, plane_gap) over the drawn frames."""
    if not items:
        return None, None
    miss, gap = 0, 0.0
    for it in items:
        ref = rplanes.segment(it["depth"].cpu().numpy(), it["cam"], it["p"])
        m, g = rplanes.gaps(_np(it["out"]), ref)
        miss, gap = miss + m, max(gap, g)
    return float(miss), gap


def pose_gap(items):
    gaps = []
    for it in items:
        obs = it["obs"]
        ref = rpose.solve(it["pose0"], obs[0], obs[1], obs[2], obs[3],
                          obs[4], it["planes"], it["cam"], it["p"])
        gaps.append(float(rlie.pose_gap(it["out"], ref)))
    return max(gaps) if gaps else None


def ba_gap(items):
    gaps = []
    for it in items:
        prob = it["prob"]
        cams, _ = local_ba.solve(prob, it["planes"], it["cam"], it["p"],
                                 **it["kw"])
        free = prob["cam_valid"] & ~prob["cam_fixed"]
        if bool(free.any()):
            gaps.append(float(rlie.pose_gap(it["out"][free],
                                             cams[free]).max()))
    return max(gaps) if gaps else None


def object_args(it) -> tuple:
    """The reference's arguments for a captured object update."""
    return (_np(it["tab"]), _np(it["fo"]), it["target"].cpu().numpy(),
            it["potential"].cpu().numpy(), it["pt_xyz"].cpu().numpy(),
            it["tcw"].cpu().numpy(), it["fid"], it["cam"], it["W"], it["H"],
            it["min_points"])


def object_numbers(items):
    """(object_mismatch, object_gap, object_spread_gap) over the drawn
    object updates."""
    if not items:
        return None, None, None
    n, g, sg = 0, 0.0, 0.0
    for it in items:
        dn, dg, ds = robj.gaps(_np(it["out"]), robj.update(*object_args(it)))
        n, g, sg = n + dn, max(g, dg), max(sg, ds)
    return float(n), g, sg


def frozen_frames(est, truth, first: int, n_inliers, gate: int):
    """Window frames (trajectory rows first, first + 1, ...; `n_inliers`
    theirs) that passed `gate` and repeat the previous frame's pose
    exactly while the truth moved."""
    count = 0
    for j, n_in in enumerate(n_inliers):
        t = first + j
        if (t > 0 and n_in >= gate and np.array_equal(est[t], est[t - 1])
                and not np.array_equal(truth[t], truth[t - 1])):
            count += 1
    return float(count)


def numbers(cap: Capture, run: dict, truth: np.ndarray,
            est: np.ndarray, names) -> dict:
    """{name: value or None} of the numbers in `names`."""
    out = {}
    items = cap.items
    with torch.no_grad():
        if {"feature_miss_pct", "desc_bits_pct"} & set(names):
            out["feature_miss_pct"], out["desc_bits_pct"] = \
                feature_numbers(items.get("features", []))
        if {"plane_mismatch", "plane_gap"} & set(names):
            out["plane_mismatch"], out["plane_gap"] = plane_numbers(
                items.get("planes", []))
        if "pose_gap" in names:
            out["pose_gap"] = pose_gap(items.get("pose", []))
        if "ba_gap" in names:
            out["ba_gap"] = ba_gap(items.get("local_ba", []))
        if {"object_mismatch", "object_gap",
                "object_spread_gap"} & set(names):
            (out["object_mismatch"], out["object_gap"],
             out["object_spread_gap"]) = object_numbers(
                items.get("object", []))
    if "frozen_frames" in names:
        out["frozen_frames"] = frozen_frames(est, truth, run["traj0"],
                                             run["n_inliers"], run["gate"])
    return out


def verdict(nums: dict, limits: dict):
    """({name: {"value", "limit"}}, correct) of the numbers `limits`
    names: correct where each is there and within its limit."""
    checks = {k: {"value": nums.get(k), "limit": v}
              for k, v in limits.items()}
    return checks, all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values())
