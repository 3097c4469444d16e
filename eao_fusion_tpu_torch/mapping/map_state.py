"""The global map as one fixed-capacity tuple of tensors (port of
`eao_fusion_tpu/mapping/map_state.py`: insertion, observation indicators,
point and keyframe compaction, capacity eviction, point statistics).

Keyframes, points and planes live in dense tensors with validity masks;
observations are the per-keyframe slot table `kf_pt_idx` ([K, N] point id
per keypoint slot, -1 = none) and its cached indicator `obs_ind` [K, P].
Field names equal the JAX `MapState`'s, so `from_numpy` takes the JAX
state as `jax.tree.map(np.asarray, m)._asdict()` gives it and tests compare
the two field by field.

Updates are functional, as in the JAX package: every function returns a
new `MapState` and leaves its input as it was (a tensor that changes is
copied first), so a caller may keep an earlier state.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.ops.topk import top_k_stable
from eao_fusion_tpu_torch.types import (FrameFeatures, tree_from_numpy,
                                        tree_to_numpy)


class MapState(NamedTuple):
    # --- keyframes -------------------------------------------------------
    kf_pose: torch.Tensor        # [K, 7] Tcw
    kf_valid: torch.Tensor       # [K] bool
    kf_frame_id: torch.Tensor    # [K] int32
    kf_timestamp: torch.Tensor   # [K] f32 seconds
    kf_kp_uv: torch.Tensor       # [K, N, 2]
    kf_kp_level: torch.Tensor    # [K, N] int32
    kf_kp_angle: torch.Tensor    # [K, N]
    kf_kp_depth: torch.Tensor    # [K, N]
    kf_kp_uright: torch.Tensor   # [K, N]
    kf_kp_valid: torch.Tensor    # [K, N] bool
    kf_desc_pm1: torch.Tensor    # [K, N, 256] int8
    kf_pt_idx: torch.Tensor      # [K, N] int32, -1 none
    kf_by_obj: torch.Tensor      # [K] bool
    # --- map points ------------------------------------------------------
    pt_xyz: torch.Tensor         # [P, 3]
    pt_valid: torch.Tensor       # [P] bool
    pt_desc_pm1: torch.Tensor    # [P, 256] int8
    pt_normal: torch.Tensor      # [P, 3]
    pt_min_dist: torch.Tensor    # [P]
    pt_max_dist: torch.Tensor    # [P]
    pt_ref_kf: torch.Tensor      # [P] int32
    pt_found: torch.Tensor       # [P] int32
    pt_visible: torch.Tensor     # [P] int32
    pt_first_frame: torch.Tensor  # [P] int32
    # --- planes ----------------------------------------------------------
    pl_coeff: torch.Tensor       # [L, 4]
    pl_valid: torch.Tensor       # [L] bool
    pl_boundary: torch.Tensor    # [L, B, 3]
    pl_boundary_valid: torch.Tensor  # [L, B] bool
    pl_obs_count: torch.Tensor   # [L] int32
    pl_ref_kf: torch.Tensor      # [L] int32
    kf_pl_coeff: torch.Tensor    # [K, F, 4]
    kf_pl_idx: torch.Tensor      # [K, F] int32
    # --- derived ---------------------------------------------------------
    obs_ind: torch.Tensor        # [K, P] bool
    # --- counters --------------------------------------------------------
    next_kf: torch.Tensor        # [] int32
    next_pt: torch.Tensor        # [] int32
    next_pl: torch.Tensor        # [] int32

    @property
    def max_kf(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def max_pt(self) -> int:
        return self.pt_xyz.shape[0]


def from_numpy(d, device) -> MapState:
    """MapState from a dict (or NamedTuple) of numpy arrays."""
    return tree_from_numpy(MapState, d, device)


def to_numpy(m: MapState) -> dict:
    return tree_to_numpy(m)


def empty_map(cfg: SystemConfig, device) -> MapState:
    K = cfg.capacity.max_keyframes
    N = cfg.orb.max_keypoints
    P = cfg.capacity.max_points
    L = cfg.capacity.max_planes
    B = cfg.planes.max_boundary_points
    F = cfg.planes.max_planes_per_frame
    f32, i32, dev = torch.float32, torch.int32, device

    def full(shape, v, dt=f32):
        return torch.full(shape, v, dtype=dt, device=dev)

    return MapState(
        kf_pose=lie.se3_identity((K,), device=dev),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_timestamp=full((K,), 0.0),
        kf_kp_uv=full((K, N, 2), 0.0),
        kf_kp_level=full((K, N), 0, i32),
        kf_kp_angle=full((K, N), 0.0),
        kf_kp_depth=full((K, N), 0.0),
        kf_kp_uright=full((K, N), -1.0),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_desc_pm1=full((K, N, 256), 0, torch.int8),
        kf_pt_idx=full((K, N), -1, i32),
        kf_by_obj=full((K,), False, torch.bool),
        pt_xyz=full((P, 3), 0.0),
        pt_valid=full((P,), False, torch.bool),
        pt_desc_pm1=full((P, 256), 0, torch.int8),
        pt_normal=full((P, 3), 0.0),
        pt_min_dist=full((P,), 0.0),
        pt_max_dist=full((P,), 1e6),
        pt_ref_kf=full((P,), -1, i32),
        pt_found=full((P,), 0, i32),
        pt_visible=full((P,), 0, i32),
        pt_first_frame=full((P,), -1, i32),
        pl_coeff=full((L, 4), 0.0),
        pl_valid=full((L,), False, torch.bool),
        pl_boundary=full((L, B, 3), 0.0),
        pl_boundary_valid=full((L, B), False, torch.bool),
        pl_obs_count=full((L,), 0, i32),
        pl_ref_kf=full((L,), -1, i32),
        kf_pl_coeff=full((K, F, 4), 0.0),
        kf_pl_idx=full((K, F), -1, i32),
        obs_ind=full((K, P), False, torch.bool),
        next_kf=full((), 0, i32),
        next_pt=full((), 0, i32),
        next_pl=full((), 0, i32),
    )


def set_rows(table: torch.Tensor, idx, vals) -> torch.Tensor:
    """Out-of-place `table.at[idx].set(vals)`."""
    out = table.clone()
    out[idx] = vals
    return out


def set_rows_where(table: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                   vals) -> torch.Tensor:
    """Out-of-place `table.at[idx].set(vals)` of the entries where `ok`
    (idx, ok and vals alike along the first axis): the others write a
    spare row, dropped after, so nothing waits for the card as a masked
    `idx[ok]` would."""
    n = table.shape[0]
    out = torch.cat([table, table[:1]])
    if not isinstance(vals, torch.Tensor):
        # made on the card: an assigned number is copied from the host
        vals = torch.full((), vals, dtype=table.dtype, device=table.device)
    out.index_put_((torch.where(ok, idx.long(), n),), vals)
    return out[:n]


# --------------------------------------------------------------- insertion

def insert_keyframe(m: MapState, feats: FrameFeatures, pose: torch.Tensor,
                    frame_id: int, timestamp: float, kp_pt_idx: torch.Tensor,
                    by_obj: bool = False) -> Tuple[MapState, int]:
    """Append a keyframe at slot next_kf; returns (new map, slot). The
    caller gates on capacity."""
    k = int(m.next_kf)
    m = m._replace(
        kf_by_obj=set_rows(m.kf_by_obj, k, bool(by_obj)),
        kf_pose=set_rows(m.kf_pose, k, pose),
        kf_valid=set_rows(m.kf_valid, k, True),
        kf_frame_id=set_rows(m.kf_frame_id, k, int(frame_id)),
        kf_timestamp=set_rows(m.kf_timestamp, k, float(timestamp)),
        kf_kp_uv=set_rows(m.kf_kp_uv, k, feats.uv),
        kf_kp_level=set_rows(m.kf_kp_level, k, feats.level),
        kf_kp_angle=set_rows(m.kf_kp_angle, k, feats.angle),
        kf_kp_depth=set_rows(m.kf_kp_depth, k, feats.depth),
        kf_kp_uright=set_rows(m.kf_kp_uright, k, feats.uright),
        kf_kp_valid=set_rows(m.kf_kp_valid, k, feats.valid),
        kf_desc_pm1=set_rows(m.kf_desc_pm1, k, feats.desc_pm1),
        kf_pt_idx=set_rows(m.kf_pt_idx, k, kp_pt_idx),
        next_kf=m.next_kf + 1,
    )
    return m, k


def create_points_from_depth(m: MapState, kf_slot: int, feats: FrameFeatures,
                             pose: torch.Tensor, kp_pt_idx: torch.Tensor,
                             max_depth: float, cam, frame_id: int, *,
                             scale_factor: float = 1.2,
                             n_levels: int = 8) -> MapState:
    """RGBD landmark creation: every valid keypoint with 0 < depth <
    max_depth and no associated point spawns a point at its
    back-projection, in consecutive slots from next_pt; writes past the
    capacity are dropped. Both branches of the JAX function (the plain
    scatter for tiny maps, the contiguous-block write) write the same
    values to the same slots; here it is one masked scatter."""
    make = (feats.valid & (feats.depth > 0) & (feats.depth < max_depth)
            & (kp_pt_idx < 0))
    order = torch.cumsum(make.to(torch.int32), 0) - 1
    new_ids = torch.where(make, m.next_pt + order, -1)
    overflow = new_ids >= m.max_pt
    new_ids = torch.where(overflow, -1, new_ids)
    make = make & (~overflow)

    xc = lie.backproject(cam, feats.uv, feats.depth)
    twc = lie.se3_inverse(pose)
    xw = lie.se3_apply(twc, xc)
    view = xw - twc[4:7]
    dist = torch.linalg.norm(view, dim=-1)
    normal = view / torch.clamp(dist[:, None], min=1e-9)
    lvl = feats.level.float()
    max_d = dist * (scale_factor ** lvl) * scale_factor
    min_d = max_d / (scale_factor ** n_levels)

    tgt = new_ids[make].long()
    n_make = make.sum().to(torch.int32)
    m = m._replace(
        pt_xyz=set_rows(m.pt_xyz, tgt, xw[make]),
        pt_valid=set_rows(m.pt_valid, tgt, True),
        pt_desc_pm1=set_rows(m.pt_desc_pm1, tgt, feats.desc_pm1[make]),
        pt_normal=set_rows(m.pt_normal, tgt, normal[make]),
        pt_min_dist=set_rows(m.pt_min_dist, tgt, min_d[make]),
        pt_max_dist=set_rows(m.pt_max_dist, tgt, max_d[make]),
        pt_ref_kf=set_rows(m.pt_ref_kf, tgt, int(kf_slot)),
        pt_first_frame=set_rows(m.pt_first_frame, tgt, int(frame_id)),
        pt_found=set_rows(m.pt_found, tgt, 1),
        pt_visible=set_rows(m.pt_visible, tgt, 1),
        next_pt=torch.clamp(m.next_pt + n_make, max=m.max_pt),
    )
    kp_pt_new = torch.where(make, new_ids, kp_pt_idx)
    return m._replace(kf_pt_idx=set_rows(m.kf_pt_idx, int(kf_slot),
                                         kp_pt_new))


def _indicator_rows(m: MapState, rows: torch.Tensor) -> torch.Tensor:
    """[R, P] bool indicator of the given keyframe rows."""
    P = m.max_pt
    sub = m.kf_pt_idx[rows].long()                             # [R, N]
    ok = (sub >= 0) & m.kf_valid[rows][:, None]
    Z = torch.zeros((rows.shape[0], P + 1), dtype=torch.bool,
                    device=sub.device)
    Z.scatter_(1, torch.where(ok, sub, P), True)
    return Z[:, :P]


def refresh_obs_ind(m: MapState) -> MapState:
    """Recompute the whole observation indicator from kf_pt_idx."""
    rows = torch.arange(m.max_kf, device=m.kf_pt_idx.device)
    return m._replace(obs_ind=_indicator_rows(m, rows))


def refresh_obs_rows(m: MapState, rows: torch.Tensor) -> MapState:
    """Recompute the indicator rows of the given keyframe slots only
    (duplicates are harmless: each row is rebuilt from its own slots)."""
    rows = rows.long()
    return m._replace(obs_ind=set_rows(m.obs_ind, rows,
                                       _indicator_rows(m, rows)))


def merge_obs_columns(m: MapState, remap: torch.Tensor,
                      max_merges: int = 512) -> MapState:
    """Apply a point-id remap (loser -> winner) to the indicator: winner
    columns absorb loser columns, loser columns clear. At most
    `max_merges` remapped ids are applied (the rest heal at the next full
    refresh), as in the JAX package."""
    P = m.max_pt
    K = m.obs_ind.shape[0]
    dev = remap.device
    moved = remap != torch.arange(P, dtype=remap.dtype, device=dev)
    order = torch.argsort((~moved).to(torch.int8), stable=True)[:max_merges]
    live = moved[order]
    src = torch.where(live, order, P)
    dst = torch.where(live, remap[order].long(), P)
    Zt = torch.zeros((P + 1, K), dtype=torch.int32, device=dev)
    Zt[:P] = m.obs_ind.T.to(torch.int32)
    g = Zt[src]                      # loser columns (before the update)
    Zt.index_fill_(0, src, 0)        # clear losers first: a winner may
    Zt.index_add_(0, dst, g)         # itself be a later loser
    return m._replace(obs_ind=(Zt[:P] > 0).T.contiguous())


def compact_points(m: MapState) -> Tuple[MapState, torch.Tensor]:
    """Compact valid points into the table prefix and remap every
    keyframe observation; returns (new map, remap [P] with -1 for dropped
    slots)."""
    P = m.max_pt
    alive = m.pt_valid
    # int32 like the JAX remap (torch's cumsum promotes to int64)
    new_idx = (torch.cumsum(alive.to(torch.int32), 0) - 1).to(torch.int32)
    remap = torch.where(alive, new_idx, -1)
    n_alive = alive.sum().to(torch.int32)
    tgt = new_idx[alive].long()

    def scatter_rows(x, fill):
        out = torch.full_like(x, fill)
        out[tgt] = x[alive]
        return out

    dev = alive.device
    m = m._replace(
        pt_xyz=scatter_rows(m.pt_xyz, 0.0),
        pt_valid=torch.arange(P, device=dev) < n_alive,
        pt_desc_pm1=scatter_rows(m.pt_desc_pm1, 0),
        pt_normal=scatter_rows(m.pt_normal, 0.0),
        pt_min_dist=scatter_rows(m.pt_min_dist, 0.0),
        pt_max_dist=scatter_rows(m.pt_max_dist, 1e6),
        pt_ref_kf=scatter_rows(m.pt_ref_kf, -1),
        pt_found=scatter_rows(m.pt_found, 0),
        pt_visible=scatter_rows(m.pt_visible, 0),
        pt_first_frame=scatter_rows(m.pt_first_frame, -1),
        next_pt=n_alive,
    )
    kf_pt = torch.where(m.kf_pt_idx >= 0,
                        remap[torch.clamp(m.kf_pt_idx.long(), min=0)], -1)
    m = m._replace(kf_pt_idx=kf_pt)
    return refresh_obs_ind(m), remap


def compact_keyframes(m: MapState) -> Tuple[MapState, torch.Tensor]:
    """Compact valid keyframes into the table prefix, in insertion order,
    and remap every keyframe-slot reference in the map: the kf_* rows,
    obs_ind rows, pt_ref_kf, pl_ref_kf and next_kf. Slots freed by
    keyframe culling become reusable, so lifetime keyframe insertions are
    unbounded. A point or plane whose reference keyframe went is
    re-anchored to its first surviving observer; one with no surviving
    observer is invalidated. The caller remaps its own state (tracking
    reference, trajectory references) with the returned remap ([K], -1 for
    dropped slots)."""
    K = m.max_kf
    alive = m.kf_valid
    dev = alive.device
    new_idx = (torch.cumsum(alive.to(torch.int32), 0) - 1).to(torch.int32)
    remap = torch.where(alive, new_idx, -1)
    n_alive = alive.sum().to(torch.int32)
    tgt = new_idx[alive].long()

    def scat(x, fill):
        out = torch.full_like(x, fill)
        out[tgt] = x[alive]
        return out

    m2 = m._replace(
        kf_pose=set_rows(lie.se3_identity((K,), device=dev), tgt,
                         m.kf_pose[alive]),
        kf_valid=torch.arange(K, device=dev) < n_alive,
        kf_frame_id=scat(m.kf_frame_id, -1),
        kf_timestamp=scat(m.kf_timestamp, 0.0),
        kf_kp_uv=scat(m.kf_kp_uv, 0.0),
        kf_kp_level=scat(m.kf_kp_level, 0),
        kf_kp_angle=scat(m.kf_kp_angle, 0.0),
        kf_kp_depth=scat(m.kf_kp_depth, 0.0),
        kf_kp_uright=scat(m.kf_kp_uright, -1.0),
        kf_kp_valid=scat(m.kf_kp_valid, False),
        kf_desc_pm1=scat(m.kf_desc_pm1, 0),
        kf_pt_idx=scat(m.kf_pt_idx, -1),
        kf_by_obj=scat(m.kf_by_obj, False),
        kf_pl_coeff=scat(m.kf_pl_coeff, 0.0),
        kf_pl_idx=scat(m.kf_pl_idx, -1),
        obs_ind=scat(m.obs_ind, False),
        next_kf=n_alive,
    )

    def reanchor(ref, observed):
        """A reference keyframe that survived, remapped; otherwise the
        first surviving observer ([K, X] indicator), else -1."""
        rc = torch.clamp(ref.long(), min=0)
        live = (ref >= 0) & alive[rc]
        new_ref = torch.where(live, remap[rc], -1)
        first = torch.argmax(observed.to(torch.int8), dim=0).to(torch.int32)
        return torch.where(new_ref >= 0, new_ref,
                           torch.where(observed.any(dim=0), first, -1))

    # --- points: observers from the compacted obs_ind --------------------
    new_ref = reanchor(m.pt_ref_kf, m2.obs_ind & m2.kf_valid[:, None])
    pt_valid = m.pt_valid & (new_ref >= 0)

    # --- planes: observers from kf_pl_idx ---------------------------------
    L = m.pl_coeff.shape[0]
    pl_tgt = torch.where((m2.kf_pl_idx >= 0) & m2.kf_valid[:, None],
                         m2.kf_pl_idx.long(), L)
    pl_ind = torch.zeros((K, L + 1), dtype=torch.bool, device=dev)
    pl_ind.scatter_(1, pl_tgt, True)
    new_pref = reanchor(m.pl_ref_kf, pl_ind[:, :L])
    pl_valid = m.pl_valid & (new_pref >= 0)

    m2 = m2._replace(pt_ref_kf=torch.where(m.pt_valid, new_ref, -1),
                     pt_valid=pt_valid,
                     pl_ref_kf=torch.where(m.pl_valid, new_pref, -1),
                     pl_valid=pl_valid)
    # points invalidated above leave the observation table too
    kf_pt = m2.kf_pt_idx
    kf_pt = torch.where(
        (kf_pt >= 0) & pt_valid[torch.clamp(kf_pt.long(), min=0)], kf_pt, -1)
    return refresh_obs_ind(m2._replace(kf_pt_idx=kf_pt)), remap


def evict_keyframes(m: MapState, n_evict: int,
                    protect_recent: int = 10) -> MapState:
    """Capacity eviction: invalidate up to `n_evict` keyframes least
    relevant to the current mapping window, for a table full of live
    keyframes that redundancy culling cannot free (exploration). The
    `protect_recent` newest keyframes are kept; the rest are scored by their
    strongest covisibility with those, lowest first, oldest first on ties,
    with object-created keyframes last. Landmarks left without an observer
    go at the following `compact_keyframes`."""
    K = m.max_kf
    dev = m.kf_valid.device
    Z = (m.obs_ind & m.kf_valid[:, None]).float()
    covis = Z @ Z.T
    idx = torch.arange(K, device=dev)
    order_rank = torch.where(m.kf_valid, idx, -1)
    recent_cut = torch.sort(order_rank).values[K - protect_recent]
    protected = m.kf_valid & (idx >= recent_cut)
    rel = torch.amax(torch.where(protected[None, :], covis, -1.0), dim=1)
    # rel counts shared points, so a 1e4 scale keeps idx a tie-break
    score = rel * 1e4 + idx.float() + torch.where(m.kf_by_obj, 1e8, 0.0)
    score = torch.where(m.kf_valid & (~protected), score, float("inf"))
    victim_score, victims = top_k_stable(-score, n_evict)
    ok = victim_score > float("-inf")
    return m._replace(kf_valid=set_rows(m.kf_valid, victims[ok], False))


def update_point_stats(m: MapState) -> MapState:
    """Mean viewing normal of every point from all its observations, in
    the product form of the JAX package: with W = Z / dist(cam_k, point_p),
    sum of unit directions[p] = x_p · Σ_k W[k,p] − (Wᵀ C)[p].
    PRECONDITION: obs_ind is current."""
    Z = (m.obs_ind & m.kf_valid[:, None]).float()              # [K, P]
    C = lie.se3_inverse(m.kf_pose)[:, 4:7]                      # [K, 3]
    X = m.pt_xyz
    G = C @ X.T
    d2 = (torch.sum(X * X, dim=-1)[None, :]
          + torch.sum(C * C, dim=-1)[:, None] - 2.0 * G)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    W = Z / torch.clamp(d, min=1e-9)
    w1 = torch.sum(W, dim=0)
    normal = X * w1[:, None] - W.T @ C
    nrm = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = torch.where(nrm > 1e-6, normal / torch.clamp(nrm, min=1e-9),
                         m.pt_normal)
    return m._replace(pt_normal=torch.where(m.pt_valid[:, None], normal,
                                            m.pt_normal))
