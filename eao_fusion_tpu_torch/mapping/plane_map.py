"""Plane landmarks: frame-to-map association, map updates and the pose
factors' inputs (port of `eao_fusion_tpu/mapping/plane_map.py`;
`transform_planes` comes with the loop-closing slice).

Map planes are rows of the MapState plane table: world Hessian coeffs and
a block of boundary points. Association is batched over (frame planes x
map planes): normal agreement (|cos| > 0.8) and the least distance of the
map plane's boundary points to the frame plane (< 0.2 m).
"""

from __future__ import annotations

import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.mapping.map_state import MapState, set_rows
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.solvers.pose_opt import PlaneObs
from eao_fusion_tpu_torch.types import FramePlanes


def planes_to_world(coeffs_c: torch.Tensor, tcw: torch.Tensor
                    ) -> torch.Tensor:
    """Camera-frame planes [n_c, d_c] -> world [n_w, d_w] under
    x_c = R x_w + t: n_w = Rᵀ n_c, d_w = d_c + n_c·t."""
    R = lie.quat_to_rotmat(tcw[:4])
    n_c = coeffs_c[:, :3]
    return torch.cat([n_c @ R, (coeffs_c[:, 3] + n_c @ tcw[4:7])[:, None]],
                     dim=-1)


def boundary_to_world(boundary_c: torch.Tensor, tcw: torch.Tensor
                      ) -> torch.Tensor:
    return lie.se3_apply(lie.se3_inverse(tcw), boundary_c)


def associate_planes(m: MapState, fp: FramePlanes, tcw: torch.Tensor, *,
                     cfg: SystemConfig) -> torch.Tensor:
    """[Pf] int32: the matched map plane of each frame plane, -1 none."""
    pc = cfg.planes
    coeff_w = planes_to_world(fp.coeffs, tcw)                  # [Pf, 4]
    ang_ok = torch.abs(coeff_w[:, :3] @ m.pl_coeff[:, :3].T) \
        > pc.assoc_angle_cos                                    # [Pf, L]
    # least distance of the MAP plane's boundary points to the FRAME
    # plane's world coeffs (`Map::PointDistanceFromPlane`)
    dist = torch.abs(torch.einsum("lbi,pi->plb", m.pl_boundary,
                                  coeff_w[:, :3])
                     + coeff_w[:, None, None, 3])               # [Pf, L, B]
    dist = torch.where(m.pl_boundary_valid[None, :, :], dist, 1e9)
    min_dist = torch.amin(dist, dim=2)                          # [Pf, L]
    ok = (ang_ok & (min_dist < pc.assoc_dist) & fp.valid[:, None]
          & m.pl_valid[None, :])
    score = torch.where(ok, min_dist, 1e9)
    best = torch.argmin(score, dim=1).to(torch.int32)
    return torch.where(torch.amin(score, dim=1) < 1e8, best, -1)


def build_plane_obs(m: MapState, fp: FramePlanes, assoc: torch.Tensor
                    ) -> PlaneObs:
    """PlaneObs for pose optimization from the associated subset."""
    idx = torch.clamp(assoc.long(), 0, m.pl_coeff.shape[0] - 1)
    return PlaneObs(plane_w=m.pl_coeff[idx], meas_c=fp.coeffs,
                    valid=(assoc >= 0) & fp.valid)


def _align_sign(meas_c: torch.Tensor, plane_w: torch.Tensor,
                tcw: torch.Tensor) -> torch.Tensor:
    """Flip measured camera planes whose normal disagrees with the landmark
    moved into the camera."""
    R = lie.quat_to_rotmat(tcw[:4])
    n_c_pred = plane_w[:, :3] @ R.T
    flip = torch.sum(n_c_pred * meas_c[:, :3], dim=-1) < 0
    return torch.where(flip[:, None], -meas_c, meas_c)


def _boundary_rows(Bf: int, take: int, device) -> torch.Tensor:
    """The `take` boundary samples of a frame plane that a merge keeps:
    `jnp.linspace(0, Bf - 1, take).astype(int32)`, rounded as XLA's CPU
    compiler evaluates it: i · (stop · (1 / (take - 1))) in float32, the
    last entry exactly Bf - 1. The truncation to int turns a last-bit
    difference into another sample."""
    if take == 1:
        return torch.zeros((1,), dtype=torch.int64, device=device)
    f32 = torch.float32
    recip = torch.tensor(1.0, dtype=f32) / torch.tensor(take - 1, dtype=f32)
    sel = torch.arange(take, dtype=f32) * (torch.tensor(Bf - 1, dtype=f32)
                                           * recip)
    sel[-1] = Bf - 1
    return sel.to(torch.int64).to(device)


def update_plane_map(m: MapState, fp: FramePlanes, assoc: torch.Tensor,
                     tcw: torch.Tensor, ref_kf: int = -1, *,
                     cfg: SystemConfig):
    """Keyframe-rate plane map update: a matched plane overwrites the oldest
    block of its boundary ring with a subsample of the new points; an
    unmatched plane becomes a new landmark. Returns (new map, plane_ids
    [Pf]: the landmark of every frame plane, -1 none)."""
    L = m.pl_coeff.shape[0]
    B = m.pl_boundary.shape[1]
    Pf, Bf, _ = fp.boundary.shape
    dev = fp.coeffs.device
    coeff_w = planes_to_world(fp.coeffs, tcw)
    bw = boundary_to_world(fp.boundary, tcw)

    # --- merge matched: ring-buffer overwrite of `take` boundary slots ---
    take = min(B // 4, Bf)
    matched = (assoc >= 0) & fp.valid
    assoc_c = torch.clamp(assoc.long(), 0, L - 1)
    start = (m.pl_obs_count[assoc_c].long() * take) % max(B - take, 1)
    rows = start[:, None] + torch.arange(take, device=dev)[None, :]
    sel = _boundary_rows(Bf, take, dev)
    new_pts = bw[:, sel]                                       # [Pf, take, 3]
    new_ok = fp.boundary_valid[:, sel] & matched[:, None]
    tgt = torch.where(matched, assoc_c, L)
    # one padding row L takes the writes of unmatched planes; the frame
    # planes write in order, so where two match one landmark the later
    # one's points stand, as the JAX scatter's last write does
    bnd = torch.cat([m.pl_boundary, m.pl_boundary.new_zeros((1, B, 3))])
    bval = torch.cat([m.pl_boundary_valid,
                      m.pl_boundary_valid.new_zeros((1, B))])
    for i in range(Pf):
        bnd[tgt[i], rows[i]] = new_pts[i]
        bval[tgt[i], rows[i]] |= new_ok[i]
    count = torch.cat([m.pl_obs_count, m.pl_obs_count.new_zeros((1,))])
    count = count.index_add_(0, tgt, torch.ones_like(tgt, dtype=count.dtype))
    m = m._replace(pl_boundary=bnd[:L], pl_boundary_valid=bval[:L],
                   pl_obs_count=count[:L])

    # --- insert unmatched as new landmarks --------------------------------
    new = fp.valid & (assoc < 0)
    order = torch.cumsum(new.to(torch.int64), 0) - 1
    slot = torch.where(new, m.next_pl.long() + order, L)
    slot = torch.clamp(slot, max=L)
    pad_b = torch.zeros((Pf, B, 3), dtype=torch.float32, device=dev)
    pad_b[:, :Bf] = bw
    pad_v = torch.zeros((Pf, B), dtype=torch.bool, device=dev)
    pad_v[:, :Bf] = fp.boundary_valid & new[:, None]

    def put(table, vals):
        out = torch.cat([table, table.new_zeros((1,) + table.shape[1:])])
        out[slot] = vals
        return out[:L]

    n_new = new.sum().to(m.next_pl.dtype)
    m = m._replace(
        pl_coeff=put(m.pl_coeff, coeff_w),
        pl_valid=put(m.pl_valid, torch.ones_like(new)),
        pl_boundary=put(m.pl_boundary, pad_b),
        pl_boundary_valid=put(m.pl_boundary_valid, pad_v),
        pl_obs_count=put(m.pl_obs_count,
                         torch.ones_like(slot, dtype=m.pl_obs_count.dtype)),
        pl_ref_kf=put(m.pl_ref_kf, torch.full_like(
            slot, int(ref_kf), dtype=m.pl_ref_kf.dtype)),
        next_pl=torch.clamp(m.next_pl + n_new, max=L))
    plane_ids = torch.where(matched, assoc.long(),
                            torch.where(new & (slot < L), slot, -1))
    return m, plane_ids.to(torch.int32)


def record_kf_plane_obs(m: MapState, kf_slot: int, fp: FramePlanes,
                        plane_ids: torch.Tensor) -> MapState:
    """Store the keyframe's camera-frame plane measurements and landmark
    ids (the BA plane factors read them)."""
    return m._replace(
        kf_pl_coeff=set_rows(m.kf_pl_coeff, int(kf_slot), fp.coeffs),
        kf_pl_idx=set_rows(m.kf_pl_idx, int(kf_slot),
                           torch.where(fp.valid, plane_ids, -1)))
