"""Loop closing: bag-of-words detection with covisibility consistency, Sim3
RANSAC, loop correction (pose propagation, point and plane fusion, the
essential graph) and the global BA, synchronous or on a side thread (port
of the per-keyframe path of `eao_fusion_tpu/pipeline/loop_closing.py`).

`LoopClosing.cc` and `KeyFrameDatabase.cc` (SURVEY.md §3.4) as in the JAX
package: the inverted index becomes dense L1 scores of the query's bow
vector against the keyframe bow matrix; the consistency bookkeeping (3
consecutive detections) stays on the host; Sim3 RANSAC is batched
(`ops/ransac.py`); the corrections are whole-table tensor updates.

Per keyframe, `on_keyframe` makes one device pass (observation indicator,
bow row, covisibility product, L1 scores) and one read of its statistics;
the gating, the essential graph's edges and the GBA merge are host numpy,
as in the JAX package. The RANSAC draws come from the System's
`torch.Generator`.

Asynchronous GBA: the JAX package runs it on a host thread that dispatches
short stage programs while tracking goes on (`:623-653,727-753`). Here the
thread enters the System's card (a new thread starts on card 0) and runs
its stages on a CUDA stream of its own, which first waits for
an event recorded on the caller's stream when the snapshot is taken; the
snapshot's tensors are copies, so nothing the main path does later can
reach them. The thread waits for its stream before it ends, and the merge
makes the caller's stream wait for the GBA's last event. A failure in the
thread is kept and raised by `poll_gba` (or `abort_gba`), not printed and
dropped as the JAX thread does.

With `gba_mesh_devices = n > 1` every GBA stage runs over an n-rank
`torch.distributed` mesh (`parallel/dist_ba.gba_stage`, as the JAX route
through `distributed_bundle_adjust`); the loop closer runs on rank 0, the
other ranks run `dist_ba.serve_gba`, and without such a group it raises
(the JAX route falls back to the single-device solver).

Batched detection for the steady chunked loop: `dispatch_detect` refreshes
the observation indicator and writes the chunk's bow rows on the caller's
stream, then enqueues the covisibility product and the L1 scores on a
stream of its own (after an event recorded on the caller's stream) and
returns a pending handle without reading anything back; the next chunk
runs meanwhile. `harvest_detect` makes the caller's stream wait for the
handle's event, reads the statistics once and gates each keyframe as
`on_keyframe` does.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.frontend import matcher
from eao_fusion_tpu_torch.mapping import covisibility, plane_map, vocabulary
from eao_fusion_tpu_torch.mapping.map_state import MapState, refresh_obs_ind
from eao_fusion_tpu_torch.ops import lie, ransac
from eao_fusion_tpu_torch.ops.scatter import put_last
from eao_fusion_tpu_torch.parallel import dist_ba, multihost
from eao_fusion_tpu_torch.parallel import mesh as pmesh
from eao_fusion_tpu_torch.solvers import ba, pose_graph
from eao_fusion_tpu_torch.types import FrameFeatures

N_PAIR_PAD = 512     # the Sim3 pair table: the best matches, masked
DETECT_BATCH = 64    # keyframe slots per batched detection


def _gba_mesh(n: int, device: torch.device):
    """The ``lm`` mesh of n ranks that the global BA runs over, made on the
    primary rank (the other ranks make theirs and run
    `dist_ba.serve_gba`). Raises without such a process group: there is
    no single-device fallback."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"gba_mesh_devices = {n} runs the global BA over a "
            f"torch.distributed process group of {n} ranks, and no process "
            f"group is initialized: call parallel.multihost."
            f"ensure_initialized() on every rank and run "
            f"parallel.dist_ba.serve_gba on ranks 1..{n - 1}")
    if dist.get_world_size() < n:
        raise RuntimeError(
            f"gba_mesh_devices = {n} needs a process group of {n} ranks; "
            f"the initialized group has {dist.get_world_size()}")
    if not multihost.is_primary():
        raise RuntimeError("the loop closer runs on the primary rank; the "
                           "other ranks run parallel.dist_ba.serve_gba")
    mesh = pmesh.make_mesh(n_landmark=n, device_type=device.type)
    dist_ba.gba_control(mesh)    # collective: `serve_gba` makes it too
    return mesh


def _covis(m: MapState) -> Tuple[torch.Tensor, torch.Tensor]:
    Z = covisibility.observation_indicator(m)
    return Z, covisibility.covisibility_counts(Z)


def _batch_scores(obs_ind: torch.Tensor, kf_valid: torch.Tensor,
                  bow: torch.Tensor, slots: List[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L1 scores [S, K] of the slots' bow rows against the table, the
    covisibility counts [K, K])."""
    Z = (obs_ind & kf_valid[:, None]).float()
    scores = torch.stack([vocabulary.l1_scores(bow[s], bow, kf_valid)
                          for s in slots])
    return scores, covisibility.covisibility_counts(Z)


class LoopCloser:
    """Host orchestrator; owns the bow matrix and the consistency state."""

    def __init__(self, cfg: SystemConfig, vocab: vocabulary.Vocabulary,
                 generator: torch.Generator):
        self.cfg = cfg
        # the mesh of the distributed GBA (gba_mesh_devices > 1)
        self.gba_mesh = (_gba_mesh(cfg.gba_mesh_devices, vocab.words.device)
                         if cfg.gba_mesh_devices > 1 else None)
        self.vocab = vocab
        self.generator = generator
        self.device = vocab.words.device
        K = cfg.capacity.max_keyframes
        self.bow = torch.zeros((K, vocab.n_words), dtype=torch.float32,
                               device=self.device)
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.last_loop_kf = -10 ** 9
        # loop edges of accepted closures, kept for later essential graphs
        # (`KeyFrame::GetLoopEdges`)
        self.loop_edges: List[Tuple[int, int]] = []
        self.stats: dict = {}     # cumulative host seconds and counts
        self._gba_thread: Optional[threading.Thread] = None
        self._gba_abort: Optional[threading.Event] = None
        self._gba_out = None      # (BAResult, its finishing CUDA event)
        self._gba_exc: Optional[BaseException] = None
        self._gba_snap = None
        self._gba_pt_map = None
        self._detect_stream = None    # the batched detection's CUDA stream

    def _tally(self, name: str, t0: float) -> None:
        self.stats["t_" + name] = (self.stats.get("t_" + name, 0.0)
                                   + time.perf_counter() - t0)
        self.stats["n_" + name] = self.stats.get("n_" + name, 0) + 1

    # ------------------------------------------------------------ remap
    def apply_kf_remap(self, remap: np.ndarray) -> None:
        """Keyframe-slot compaction (`map_state.compact_keyframes`): move
        the bow rows to their new slots and remap or drop slot references
        in the consistency state. remap[k] = new slot of old slot k, -1 if
        the keyframe went."""
        alive = remap >= 0
        bow = torch.zeros_like(self.bow)
        bow[torch.as_tensor(remap[alive], device=self.device).long()] = \
            self.bow[torch.as_tensor(np.where(alive)[0],
                                     device=self.device)]
        self.bow = bow
        self.loop_edges = [(int(remap[a]), int(remap[b]))
                           for a, b in self.loop_edges
                           if remap[a] >= 0 and remap[b] >= 0]
        groups = []
        for grp, cnt in self.consistent_groups:
            g2 = {int(remap[x]) for x in grp if remap[x] >= 0}
            if g2:
                groups.append((g2, cnt))
        self.consistent_groups = groups
        if self.last_loop_kf >= 0:
            r = int(remap[self.last_loop_kf])
            if r < 0:
                # the nearest earlier surviving keyframe keeps the "no
                # loops right after a loop" gate roughly in force
                earlier = remap[:self.last_loop_kf + 1]
                r = int(earlier.max()) if (earlier >= 0).any() else -10 ** 9
            self.last_loop_kf = r

    # ---------------------------------------------------------------- bow
    def add_keyframe_bow(self, m: MapState, slot: int) -> None:
        self.bow[slot] = vocabulary.bow_vector(
            self.vocab, m.kf_desc_pm1[slot], m.kf_kp_valid[slot])

    # ------------------------------------------------------------- detect
    def detect_stats(self, m: MapState, slot: int):
        """The keyframe's device pass: the observation indicator refreshed,
        its bow row written, the covisibility product and the L1 scores,
        then one read. Returns (map, scores [K], covis [K, K], kf_valid
        [K]) with the three statistics as numpy."""
        m = refresh_obs_ind(m)
        self.add_keyframe_bow(m, slot)
        _, covis = _covis(m)
        scores = vocabulary.l1_scores(self.bow[slot], self.bow, m.kf_valid)
        packed = torch.cat([scores, covis.reshape(-1),
                            m.kf_valid.float()]).cpu().numpy()
        K = m.max_kf
        return (m, packed[:K], packed[K:K + K * K].reshape(K, K),
                packed[K + K * K:] > 0.5)

    def _detect_from_stats(self, slot: int, scores: np.ndarray,
                           covis: np.ndarray, kf_valid: np.ndarray) -> int:
        """The gating of `KeyFrameDatabase::DetectLoopCandidates` and the
        3-consecutive-group consistency of LoopClosing
        (`src/LoopClosing.cc:103-229`), on host statistics."""
        cfg = self.cfg.loop
        if slot < 10 or slot - self.last_loop_kf < 10:
            return -1
        connected = covis[slot] >= 15
        connected[slot] = True
        neigh = connected.copy()
        neigh[slot] = False
        if not neigh.any():
            return -1
        min_score = (float(scores[neigh & kf_valid].min())
                     if (neigh & kf_valid).any() else 0.0)
        cand_mask = kf_valid & (~connected) & (scores >= max(min_score,
                                                             1e-6))
        cand_mask[max(0, slot - 10):] = False     # skip recent keyframes
        cand = np.where(cand_mask)[0]
        if len(cand) == 0:
            self.consistent_groups = []
            return -1
        # scores accumulated over covisibility groups; keep >= 0.75 best
        groups = []
        for c in cand:
            grp = set(np.where(covis[c] >= 15)[0].tolist()) | {int(c)}
            groups.append((int(c), grp, float(scores[list(grp)].sum())))
        best_acc = max(g[2] for g in groups)
        groups = [g for g in groups if g[2] >= cfg.acc_score_retain * best_acc]
        # consistency with the previous keyframes' groups
        new_groups: List[Tuple[Set[int], int]] = []
        enough: List[int] = []
        for c, grp, _ in groups:
            count = 0
            for prev_grp, prev_cnt in self.consistent_groups:
                if grp & prev_grp:
                    count = max(count, prev_cnt + 1)
            new_groups.append((grp, count))
            if count >= cfg.covisibility_consistency_th:
                enough.append(c)
        self.consistent_groups = new_groups
        return int(enough[0]) if enough else -1

    # ------------------------------------------------------- compute sim3
    def compute_sim3(self, m: MapState, cur: int, cand: int,
                     idx: Optional[torch.Tensor] = None
                     ) -> Optional[torch.Tensor]:
        """S (sim3 [8]) with pb(cur camera) ≈ S pa(cand camera), or None
        (`LoopClosing::ComputeSim3`, `src/LoopClosing.cc:231-420`): mutual
        descriptor matches, the best 512 pairs with a map point on both
        sides as a masked table, Horn RANSAC, Sim3 refinement; one read of
        the pair and inlier counts. `idx` [128, 3] are the RANSAC draws
        (drawn from the System's generator when not given)."""
        cfg = self.cfg
        mm = matcher.mutual_match(
            m.kf_desc_pm1[cand], m.kf_kp_valid[cand], m.kf_kp_angle[cand],
            m.kf_desc_pm1[cur], m.kf_kp_valid[cur], m.kf_kp_angle[cur],
            th=cfg.matcher.th_low, use_ratio=True, check_rotation=True)
        tgt = mm.target_idx.long()
        pt_a = m.kf_pt_idx[cand].long()
        pt_b = m.kf_pt_idx[cur][torch.clamp(tgt, min=0)].long()
        ok = (tgt >= 0) & (pt_a >= 0) & (pt_b >= 0)
        # valid pairs first, lowest Hamming distance leading
        order = torch.argsort(torch.where(ok, mm.dist.float(), float("inf")),
                              stable=True)
        sel = order[:N_PAIR_PAD]
        valid = ok[sel]
        ia = torch.where(valid, pt_a[sel], 0)
        ib = torch.where(valid, pt_b[sel], 0)
        pa_c = lie.se3_apply(m.kf_pose[cand], m.pt_xyz[ia])
        pb_c = lie.se3_apply(m.kf_pose[cur], m.pt_xyz[ib])
        if idx is None:
            idx = ransac.draw_hypotheses(valid, 128, 3, self.generator)
        res = ransac.ransac_align(pa_c, pb_c, valid, idx,
                                  with_scale=not cfg.loop.fix_scale_rgbd,
                                  inlier_th=0.10)
        g = pose_graph.sim3_refine(pa_c, pb_c, res.inliers.float(),
                                   res.transform,
                                   fix_scale=cfg.loop.fix_scale_rgbd)
        n_inl, n_pairs = torch.stack([res.n_inliers.long(),
                                      valid.sum()]).tolist()
        if n_pairs < cfg.loop.min_sim3_matches:
            return None
        if n_inl < cfg.loop.sim3_min_inliers:
            return None
        return g

    # ------------------------------------------------------- correct loop
    def correct(self, m: MapState, cur: int, cand: int,
                s_cur_cand: torch.Tensor) -> MapState:
        """Propagate the corrected pose through the covisible window, fuse
        the loop's points and planes, run the essential graph, then the
        global BA, on this thread or on the GBA thread
        (`LoopClosing::CorrectLoop`, `src/LoopClosing.cc:422-660`)."""
        cfg = self.cfg
        K = m.max_kf
        # corrected current pose: Tcw_corr = S_cur_cand ∘ Tcw_cand; the
        # world-side correction p' = Tcw_corr⁻¹ ∘ Tcw_old (p), T_iw' =
        # T_iw ∘ C⁻¹
        scw_corr = lie.sim3_compose(s_cur_cand,
                                    lie.sim3_from_se3(m.kf_pose[cand]))
        C = lie.se3_compose(lie.se3_inverse(lie.sim3_to_se3(scw_corr)),
                            m.kf_pose[cur])
        C_inv = lie.se3_inverse(C)

        Z, covis = _covis(m)
        window = covisibility.top_covisible(covis, cur, m.kf_valid, 30)
        window[cur] = True
        win_pts = covisibility.points_of_keyframes(Z, window) & m.pt_valid
        old_poses = m.kf_pose
        m = m._replace(
            kf_pose=torch.where(window[:, None],
                                lie.se3_compose(m.kf_pose, C_inv[None]),
                                m.kf_pose),
            pt_xyz=torch.where(win_pts[:, None], lie.se3_apply(C, m.pt_xyz),
                               m.pt_xyz))
        if cfg.use_planes:
            # planes anchored in the corrected window move with it
            win_pl = (m.pl_valid & (m.pl_ref_kf >= 0)
                      & window[torch.clamp(m.pl_ref_kf.long(), 0, K - 1)])
            m = m._replace(
                pl_coeff=torch.where(win_pl[:, None],
                                     plane_map.transform_planes(m.pl_coeff,
                                                                C),
                                     m.pl_coeff),
                pl_boundary=torch.where(win_pl[:, None, None],
                                        lie.se3_apply(C, m.pl_boundary),
                                        m.pl_boundary))

        # fuse duplicated landmarks across the loop
        covis_before = covis.cpu().numpy()
        m = self._fuse_loop_points(m, cur, cand)
        if cfg.use_planes:
            m = self._fuse_loop_planes(m, cur, cand, window)

        # new connections made by the fusion: window keyframes now strongly
        # covisible with keyframes outside it (the reference's
        # LoopConnections, `src/LoopClosing.cc:540-560`)
        covis_after = _covis(m)[1].cpu().numpy()
        win_np = window.cpu().numpy()
        new_strong = ((covis_after >= 100) & win_np[:, None]
                      & (~win_np)[None, :] & (covis_before < 15))
        loop_pairs = [(int(j), int(i)) for i, j in np.argwhere(new_strong)
                      if j < i]
        m = self._essential_graph(m, cur, cand, old_poses, loop_pairs)

        # global BA (`RunGlobalBundleAdjustment`)
        if cfg.loop.async_gba:
            self.launch_gba_async(m)
        else:
            m = self._global_ba(m)
        self.last_loop_kf = cur
        self.consistent_groups = []
        return m

    def _fuse_loop_points(self, m: MapState, cur: int, cand: int
                          ) -> MapState:
        """SearchAndFuse (`src/LoopClosing.cc:604-654`): project the loop
        side's points into the corrected current keyframe; where one lands
        on a keypoint holding another point, the two ids merge (the loop
        side's wins, every reference redirected)."""
        cfg = self.cfg
        cam = (cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
        Z, covis = _covis(m)
        loop_kfs = covisibility.top_covisible(covis, cand, m.kf_valid, 20)
        loop_kfs[cand] = True
        loop_pts = covisibility.points_of_keyframes(Z, loop_kfs) & m.pt_valid
        n = m.kf_kp_uv.shape[1]
        dev = m.pt_xyz.device
        cur_feats = FrameFeatures(
            uv=m.kf_kp_uv[cur], response=torch.ones_like(m.kf_kp_angle[cur]),
            level=m.kf_kp_level[cur], angle=m.kf_kp_angle[cur],
            desc_packed=torch.zeros((n, 8), dtype=torch.int32, device=dev),
            desc_pm1=m.kf_desc_pm1[cur], valid=m.kf_kp_valid[cur],
            depth=m.kf_kp_depth[cur], uright=m.kf_kp_uright[cur])
        P = m.max_pt
        lvl = torch.zeros((P,), dtype=torch.int32, device=dev)
        res = matcher.match_points_to_frame(
            m.pt_xyz, m.pt_desc_pm1, loop_pts, torch.zeros((P,), device=dev),
            lvl, torch.full((P,), 4.0 * cfg.orb.scale_factor, device=dev),
            lvl, lvl + cfg.orb.n_levels, cur_feats, m.kf_pose[cur], cam=cam,
            width=cfg.camera.width, height=cfg.camera.height,
            th=cfg.matcher.th_low, check_rotation=False)
        cur_pt = m.kf_pt_idx[cur].long()
        loop_pt = res.target_idx.long()
        both = ((loop_pt >= 0) & (cur_pt >= 0) & (loop_pt != cur_pt)
                & m.pt_valid[torch.clamp(cur_pt, min=0)])
        remap = put_last(torch.arange(P + 1, device=dev),
                         torch.where(both, cur_pt, P),
                         torch.where(both, loop_pt, P))[:P]
        kf_pt = torch.where(m.kf_pt_idx >= 0,
                            remap[torch.clamp(m.kf_pt_idx.long(), min=0)],
                            m.kf_pt_idx.long()).to(torch.int32)
        pt_valid = torch.cat([m.pt_valid, m.pt_valid.new_zeros((1,))])
        pt_valid[torch.where(both, cur_pt, P)] = False
        return refresh_obs_ind(m._replace(kf_pt_idx=kf_pt,
                                          pt_valid=pt_valid[:P]))

    def _fuse_loop_planes(self, m: MapState, cur: int, cand: int,
                          window: torch.Tensor) -> MapState:
        """Plane fusion across the loop (`Map::SearchMatchedPlanes` and
        `MapPlane::Replace`): a plane of the corrected window that now
        coincides with a loop-side plane merges into it; keyframe plane
        references are redirected and the duplicate is invalidated."""
        pcfg = self.cfg.planes
        L = m.pl_coeff.shape[0]
        _, covis = _covis(m)
        loop_kfs = covisibility.top_covisible(covis, cand, m.kf_valid, 20)
        loop_kfs[cand] = True

        def planes_of(kf_mask):
            tgt = torch.where(kf_mask[:, None] & (m.kf_pl_idx >= 0),
                              m.kf_pl_idx.long(), L)
            seen = torch.zeros((L + 1,), dtype=torch.bool,
                               device=tgt.device)
            seen[tgt.reshape(-1)] = True
            return seen[:L] & m.pl_valid

        loop_pl = planes_of(loop_kfs)
        cur_pl = planes_of(window) & (~loop_pl)
        dots = torch.abs(m.pl_coeff[:, :3] @ m.pl_coeff[:, :3].T)
        dist = torch.abs(torch.einsum("lbi,pi->plb", m.pl_boundary,
                                      m.pl_coeff[:, :3])
                         + m.pl_coeff[:, None, None, 3])
        dist = torch.where(m.pl_boundary_valid[None, :, :], dist, 1e9)
        min_dist = torch.amin(dist, dim=2)
        ok = ((dots > pcfg.assoc_angle_cos) & (min_dist < pcfg.assoc_dist)
              & cur_pl[:, None] & loop_pl[None, :])
        score = torch.where(ok, min_dist, 1e9)
        best = torch.argmin(score, dim=1)
        fuse = torch.amin(score, dim=1) < 1e8
        remap = torch.where(fuse, best, torch.arange(L, device=best.device))
        kf_pl = torch.where(m.kf_pl_idx >= 0,
                            remap[torch.clamp(m.kf_pl_idx.long(), min=0)],
                            m.kf_pl_idx.long()).to(torch.int32)
        absorbed = torch.zeros((L,), dtype=m.pl_obs_count.dtype,
                               device=best.device).index_add_(
            0, torch.where(fuse, best, 0),
            torch.where(fuse, m.pl_obs_count, 0))
        return m._replace(kf_pl_idx=kf_pl, pl_valid=m.pl_valid & (~fuse),
                          pl_obs_count=m.pl_obs_count + absorbed)

    def _essential_graph(self, m: MapState, cur: int, cand: int,
                         old_poses: torch.Tensor, loop_pairs=None
                         ) -> MapState:
        """Sim3 pose graph over the essential graph
        (`Optimizer::OptimizeEssentialGraph`, `src/Optimizer.cc:1141-1435`):
        the spanning tree (parent = most covisible earlier keyframe), strong
        covisibility edges (>= 100 shared points), the new loop connections
        and the loop edges of earlier closures. The edges are built on the
        host from one read of the covisibility counts."""
        cfg = self.cfg
        K = m.max_kf
        dev = m.kf_pose.device
        covis = _covis(m)[1].cpu().numpy()
        kf_valid = m.kf_valid.cpu().numpy()
        min_feat = 100

        # spanning tree: parent(i) = most covisible valid j < i
        idx = np.arange(K)
        earlier = ((idx[None, :] < idx[:, None]) & kf_valid[None, :]
                   & kf_valid[:, None])
        w_tree = np.where(earlier, covis, -1)
        parent = w_tree.argmax(axis=1)
        has_parent = (w_tree.max(axis=1) > 0) & kf_valid & (idx > 0)
        # keyframes orphaned by culling chain to the nearest earlier valid
        orphan = kf_valid & (idx > 0) & (~has_parent)
        if orphan.any():
            prev_valid = np.where(kf_valid, idx, -1)
            nearest = np.maximum.accumulate(
                np.concatenate([[-1], prev_valid[:-1]]))
            parent = np.where(orphan & (nearest >= 0), nearest, parent)
            has_parent = has_parent | (orphan & (nearest >= 0))
        tree_i = parent[has_parent]
        tree_j = idx[has_parent]

        # strong covisibility edges (upper triangle, tree edges left out)
        strong = (covis >= min_feat) & kf_valid[:, None] & kf_valid[None, :]
        strong &= idx[None, :] > idx[:, None]
        strong[parent[has_parent], idx[has_parent]] = False
        strong[idx[has_parent], parent[has_parent]] = False
        cov_i, cov_j = np.nonzero(strong)

        # loop connections take precedence over duplicate tree / covis edges
        lp = [(int(cand), int(cur))]
        if loop_pairs is not None:
            lp += [(int(a), int(b)) for a, b in loop_pairs
                   if (int(a), int(b)) != (int(cand), int(cur))]
        lp_set = {(min(p), max(p)) for p in lp}

        def drop_dups(a, b):
            keep = np.array([(min(x, y), max(x, y)) not in lp_set
                             for x, y in zip(a.tolist(), b.tolist())], bool)
            return a[keep], b[keep]

        tree_i, tree_j = drop_dups(tree_i, tree_j)
        cov_i, cov_j = drop_dups(cov_i, cov_j)
        seen = (set(zip(cov_i.tolist(), cov_j.tolist()))
                | set(zip(tree_i.tolist(), tree_j.tolist())) | lp_set)
        prev_lp = [(a, b) for a, b in self.loop_edges
                   if kf_valid[a] and kf_valid[b]
                   and (min(a, b), max(a, b)) not in seen]
        ei = np.concatenate([tree_i, cov_i, np.array(
            [p[0] for p in prev_lp + lp], np.int64)]).astype(np.int64)
        ej = np.concatenate([tree_j, cov_j, np.array(
            [p[1] for p in prev_lp + lp], np.int64)]).astype(np.int64)
        wgt = np.ones(len(ei), np.float32)
        wgt[-len(lp):] = 10.0          # the new loop connections
        use_new = np.zeros(len(ei), bool)
        use_new[-len(lp):] = True

        # Measurements S_ji: the pre-existing edges use the poses before
        # the correction (the reference's NonCorrectedSim3), only the new
        # loop connections the corrected ones
        old_sim = lie.sim3_from_se3(old_poses)
        new_sim = lie.sim3_from_se3(m.kf_pose)
        ei_t = torch.as_tensor(ei, device=dev)
        ej_t = torch.as_tensor(ej, device=dev)
        un = torch.as_tensor(use_new, device=dev)[:, None]
        src = torch.where(un, new_sim[ei_t], old_sim[ei_t])
        dst = torch.where(un, new_sim[ej_t], old_sim[ej_t])
        meas = lie.sim3_compose(dst, lie.sim3_inverse(src))
        fixed = torch.zeros((K,), dtype=torch.bool, device=dev)
        fixed[cand] = True
        fixed[0] = True
        opt = pose_graph.optimize_pose_graph(
            pose_graph.PoseGraphProblem(
                poses=new_sim, pose_valid=m.kf_valid, fixed=fixed,
                edge_i=ei_t, edge_j=ej_t, edge_meas=meas,
                edge_weight=torch.as_tensor(wgt, device=dev)),
            n_iters=cfg.loop.pose_graph_iters,
            fix_scale=cfg.loop.fix_scale_rgbd)
        self.loop_edges.extend(lp)

        # points through their reference keyframe: p' = T_ref_new⁻¹ ∘
        # T_ref_old (p) (`src/Optimizer.cc:1380-1410`)
        new_se3 = lie.sim3_to_se3(opt)
        ref = torch.clamp(m.pt_ref_kf.long(), 0, K - 1)
        moved = lie.se3_apply(lie.se3_compose(lie.se3_inverse(new_se3[ref]),
                                              m.kf_pose[ref]), m.pt_xyz)
        enter_poses = m.kf_pose        # the poses that entered the graph
        m = m._replace(
            kf_pose=torch.where(m.kf_valid[:, None], new_se3, m.kf_pose),
            pt_xyz=torch.where(m.pt_valid[:, None], moved, m.pt_xyz))
        if cfg.use_planes:
            # planes follow their reference keyframe, as points do
            pref = torch.clamp(m.pl_ref_kf.long(), 0, K - 1)
            T_pl = lie.se3_compose(lie.se3_inverse(new_se3[pref]),
                                   enter_poses[pref])
            pl_ok = m.pl_valid & (m.pl_ref_kf >= 0)
            m = m._replace(
                pl_coeff=torch.where(pl_ok[:, None],
                                     plane_map.transform_planes(m.pl_coeff,
                                                                T_pl),
                                     m.pl_coeff),
                pl_boundary=torch.where(
                    pl_ok[:, None, None],
                    lie.se3_apply(T_pl[:, None, :], m.pl_boundary),
                    m.pl_boundary))
        return m

    # ------------------------------------------------------- global BA
    def _build_gba_problem(self, m: MapState):
        """The GBA problem of the map, (prob, plane_free), shared by the
        synchronous and the asynchronous paths. Cameras with fewer than
        `min_cam_obs` observations stay where the essential graph put
        them."""
        cfg = self.cfg
        obs_pt = m.kf_pt_idx
        pt_ok = m.pt_valid[torch.clamp(obs_pt.long(), min=0)] & (obs_pt >= 0)
        obs_ok = m.kf_kp_valid & pt_ok
        starved = obs_ok.sum(dim=1) < cfg.solver.min_cam_obs
        starved[0] = True
        prob = ba.BAProblem(
            cam_pose=m.kf_pose, cam_valid=m.kf_valid, cam_fixed=starved,
            pt_xyz=m.pt_xyz, pt_valid=m.pt_valid, obs_pt=obs_pt,
            obs_uv=m.kf_kp_uv, obs_ur=m.kf_kp_uright,
            obs_inv_sigma2=cfg.orb.scale_factor ** (
                -2.0 * m.kf_kp_level.float()),
            obs_valid=obs_ok)
        plane_free = None
        if cfg.use_planes:
            # GBA plane edges with free plane vertices
            # (`src/Optimizer.cc:210-250`)
            pl_idx = m.kf_pl_idx
            pl_ok = ((pl_idx >= 0)
                     & m.pl_valid[torch.clamp(pl_idx.long(), min=0)]
                     & m.kf_valid[:, None])
            plane_free = ba.PlaneFreeBlock(
                pl_coeff=m.pl_coeff, pl_free=m.pl_valid,
                obs_pl=torch.where(pl_ok, pl_idx, -1), obs_meas=m.kf_pl_coeff,
                obs_valid=pl_ok)
        return prob, plane_free

    def _gba_stage(self, prob, plane_free, n1: int, n2: int):
        """One stage of n1 phase-1 and n2 phase-2 LM iterations: on the
        mesh, the observation-sharded solver with the serving ranks (n1 = 0
        runs one phase over every valid observation, as the JAX route
        does); else the single-device solver."""
        c = self.cfg.camera
        cam = (c.fx, c.fy, c.cx, c.cy, c.bf)
        if self.gba_mesh is not None:
            return dist_ba.gba_stage(self.gba_mesh, prob, plane_free,
                                     cam=cam, cfg=self.cfg.solver,
                                     n_iters1=n1, n_iters=n2)
        return ba.bundle_adjust(prob, plane_free=plane_free, cam=cam,
                                cfg=self.cfg.solver, n_iters1=n1,
                                n_iters2=n2)

    def _run_gba_stages(self, prob, plane_free, abort=None):
        """The GBA schedule (phase 1, outlier gate, phase 2) as stages of
        `gba_stage_iters` LM iterations; an abort takes effect at the next
        stage boundary. Returns the last stage's BAResult (None if aborted
        before the first)."""
        scfg = self.cfg.solver
        total = scfg.global_ba_iters
        n1_total = total // 2
        stage = max(1, self.cfg.loop.gba_stage_iters)
        res = None
        done1 = done2 = 0
        while done1 < n1_total or done2 < total - n1_total:
            if abort is not None and abort.is_set():
                break
            if done1 < n1_total:
                n1, n2 = min(stage, n1_total - done1), 0
                done1 += n1
            else:
                n1, n2 = 0, min(stage, total - n1_total - done2)
                done2 += n2
            res = self._gba_stage(prob, plane_free, n1, n2)
            prob = prob._replace(cam_pose=res.cam_pose, pt_xyz=res.pt_xyz)
            if plane_free is not None:
                plane_free = plane_free._replace(pl_coeff=res.pl_coeff)
        return res

    def _global_ba(self, m: MapState) -> MapState:
        """The synchronous GBA: build, solve, apply."""
        prob, plane_free = self._build_gba_problem(m)
        res = self._run_gba_stages(prob, plane_free)
        return self._apply_gba(m, res, plane_free is not None)

    def _apply_gba(self, m: MapState, res, with_planes: bool) -> MapState:
        m = m._replace(
            kf_pose=torch.where(m.kf_valid[:, None], res.cam_pose, m.kf_pose),
            pt_xyz=torch.where(m.pt_valid[:, None], res.pt_xyz, m.pt_xyz))
        if with_planes:
            coeff = torch.where(m.pl_valid[:, None], res.pl_coeff,
                                m.pl_coeff)
            # boundary points projected onto their optimized planes (the
            # reference's `MapPlane::UpdateBoundary` keeps them current)
            nrm = coeff[:, :3]
            off = (torch.einsum("lbi,li->lb", m.pl_boundary, nrm)
                   + coeff[:, 3][:, None])
            bnd = m.pl_boundary - off[..., None] * nrm[:, None, :]
            keep = m.pl_valid[:, None, None] & m.pl_boundary_valid[..., None]
            m = m._replace(pl_coeff=coeff,
                           pl_boundary=torch.where(keep, bnd, m.pl_boundary))
        return m

    # ------------------------------------------------------ async GBA
    # The reference runs GBA in a transient thread with an abort interlock
    # and merges its output into a map that kept growing meanwhile
    # (`src/LoopClosing.cc:594, 686-796`). Keyframes are matched across the
    # flight by kf_frame_id; point-slot compactions during the flight are
    # composed into _gba_pt_map by note_pt_remap.

    def gba_inflight(self) -> bool:
        return self._gba_thread is not None and self._gba_thread.is_alive()

    def _take_failure(self) -> None:
        exc, self._gba_exc = self._gba_exc, None
        if exc is not None:
            raise RuntimeError("the global BA thread failed") from exc

    def abort_gba(self) -> None:
        """Discard any in-flight GBA (the mbStopGBA path: a newer loop
        closure supersedes it). A failure of that GBA is raised here."""
        t = self._gba_thread
        if t is not None:
            self._gba_abort.set()
            t.join()
            self.stats["n_gba_aborts"] = self.stats.get("n_gba_aborts", 0) + 1
        self._gba_thread = None
        self._gba_out = self._gba_snap = self._gba_pt_map = None
        self._take_failure()

    def note_pt_remap(self, remap: np.ndarray) -> None:
        """A point-slot compaction while the GBA is in flight: compose it
        into the snapshot -> current point map."""
        if self._gba_pt_map is not None:
            pm = self._gba_pt_map
            r = np.asarray(remap)
            self._gba_pt_map = np.where(pm >= 0, r[np.clip(pm, 0, None)], -1)

    def launch_gba_async(self, m: MapState) -> None:
        self.abort_gba()
        prob, plane_free = self._build_gba_problem(m)
        # the snapshot: copies, so that no later update of the live map
        # can reach the thread's inputs
        prob = ba.BAProblem(*(t.clone() for t in prob))
        if plane_free is not None:
            plane_free = ba.PlaneFreeBlock(*(t.clone() for t in plane_free))
        snap = torch.cat([m.kf_frame_id.double(), m.kf_valid.double(),
                          m.pt_valid.double(),
                          m.pl_valid.double()]).cpu().numpy()
        K, P = m.max_kf, m.max_pt
        self._gba_snap = {
            "kf_frame_id": snap[:K].astype(np.int64),
            "kf_valid": snap[K:2 * K] > 0.5,
            "pt_valid": snap[2 * K:2 * K + P] > 0.5,
            "pl_valid": snap[2 * K + P:] > 0.5,
        }
        self._gba_pt_map = np.arange(P, dtype=np.int64)
        self._gba_out = None
        self._gba_exc = None
        abort = self._gba_abort = threading.Event()
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))

        def work():
            try:
                t0 = time.perf_counter()
                done = None
                if cuda:
                    # the thread starts on card 0: enter the System's card
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(stream):
                        stream.wait_event(ready)
                        res = self._run_gba_stages(prob, plane_free, abort)
                        done = torch.cuda.Event()
                        done.record(stream)
                    # the inputs may be freed once this thread ends
                    done.synchronize()
                else:
                    res = self._run_gba_stages(prob, plane_free, abort)
                self._tally("gba", t0)
                if res is not None and not abort.is_set():
                    self._gba_out = (res, done)
            except BaseException as e:          # raised again by poll_gba
                self._gba_exc = e

        self._gba_thread = threading.Thread(target=work, daemon=True,
                                            name="eao-gba")
        self._gba_thread.start()

    def poll_gba(self, m: MapState, blocking: bool = False
                 ) -> Tuple[MapState, bool]:
        """If the async GBA finished, merge its result into the live map and
        return (merged map, True); otherwise (m, False). With `blocking`,
        wait for it first. A failure of the GBA thread is raised here."""
        t = self._gba_thread
        if t is None:
            return m, False
        if blocking:
            t.join()
        if t.is_alive():
            return m, False
        self._gba_thread = None
        out, snap, pt_map = self._gba_out, self._gba_snap, self._gba_pt_map
        self._gba_out = self._gba_snap = self._gba_pt_map = None
        self._take_failure()
        if out is None:
            return m, False
        res, done = out
        if done is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(done)
            for x in res:
                if isinstance(x, torch.Tensor):
                    x.record_stream(main)
        return self._merge_gba(m, res, snap, pt_map), True

    def _merge_gba(self, m: MapState, res, snap, pt_map) -> MapState:
        """Post-hoc merge (`LoopClosing::RunGlobalBundleAdjustment`,
        `src/LoopClosing.cc:686-796`), on the host: keyframes present at
        the snapshot take their GBA poses; keyframes made during the flight
        are corrected through the spanning tree (Tchild' = Tchild ∘
        Tparent⁻¹ ∘ Tparent'); points present at the snapshot take their
        GBA positions; newer points and planes move with their reference
        keyframe."""
        K, P = m.max_kf, m.max_pt
        dev = m.kf_pose.device
        kf_valid = m.kf_valid.cpu().numpy()
        cur_fid = m.kf_frame_id.cpu().numpy()
        pose_before = m.kf_pose.cpu()
        gba_pose = res.cam_pose.cpu()
        snap_slot = {int(f): i for i, f in enumerate(snap["kf_frame_id"])
                     if snap["kf_valid"][i]}
        new_pose = pose_before.clone()
        new_kfs = []
        for j in np.where(kf_valid)[0]:
            s = snap_slot.get(int(cur_fid[j]), -1)
            if s >= 0:
                new_pose[j] = gba_pose[s]
            else:
                new_kfs.append(int(j))
        if new_kfs:
            covis = _covis(m)[1].cpu().numpy()
            for j in new_kfs:    # ascending: parents already corrected
                cand = covis[j, :j].copy()
                cand[~kf_valid[:j]] = -1.0
                parent = int(np.argmax(cand)) if cand.size else -1
                if parent < 0 or cand[parent] <= 0:
                    earlier = np.where(kf_valid[:j])[0]
                    if len(earlier) == 0:
                        continue
                    parent = int(earlier[-1])
                new_pose[j] = lie.se3_compose(
                    pose_before[j], lie.se3_compose(
                        lie.se3_inverse(pose_before[parent]),
                        new_pose[parent]))

        # points
        pt_valid = m.pt_valid.cpu().numpy()
        X = m.pt_xyz.cpu().numpy().copy()
        sel = (pt_map >= 0) & snap["pt_valid"]
        sel &= pt_valid[np.clip(pt_map, 0, None)]
        X[pt_map[sel]] = res.pt_xyz.cpu().numpy()[sel]
        from_snap = np.zeros(P, bool)
        from_snap[pt_map[sel]] = True
        new_pts = pt_valid & (~from_snap)
        pt_ref = m.pt_ref_kf.cpu().numpy()
        if new_pts.any():
            ref = torch.as_tensor(np.clip(pt_ref, 0, K - 1)).long()
            T_move = lie.se3_compose(lie.se3_inverse(new_pose[ref]),
                                     pose_before[ref])
            moved = lie.se3_apply(T_move, torch.from_numpy(X)).numpy()
            ok = new_pts & (pt_ref >= 0)
            X[ok] = moved[ok]
        out = m._replace(kf_pose=new_pose.to(dev),
                         pt_xyz=torch.from_numpy(X).to(dev))

        # planes (ids are stable: no plane compaction)
        if self.cfg.use_planes and res.pl_coeff is not None:
            pl_valid = m.pl_valid.cpu().numpy()
            both = pl_valid & snap["pl_valid"]
            coeff = m.pl_coeff.cpu().numpy().copy()
            coeff[both] = res.pl_coeff.cpu().numpy()[both]
            bnd = m.pl_boundary.cpu().numpy().copy()
            bv = m.pl_boundary_valid.cpu().numpy()
            # snapshot planes: boundaries projected onto the new planes
            off = (np.einsum("lbi,li->lb", bnd, coeff[:, :3])
                   + coeff[:, 3][:, None])
            proj = bnd - off[..., None] * coeff[:, None, :3]
            keep = both[:, None] & bv
            bnd[keep] = proj[keep]
            # planes made during the flight follow their reference keyframe
            pl_ref = m.pl_ref_kf.cpu().numpy()
            new_pl = pl_valid & (~snap["pl_valid"]) & (pl_ref >= 0)
            if new_pl.any():
                pref = torch.as_tensor(np.clip(pl_ref, 0, K - 1)).long()
                T_pl = lie.se3_compose(lie.se3_inverse(new_pose[pref]),
                                       pose_before[pref])
                c_new = plane_map.transform_planes(
                    torch.from_numpy(coeff), T_pl).numpy()
                b_new = lie.se3_apply(T_pl[:, None, :],
                                      torch.from_numpy(bnd)).numpy()
                coeff[new_pl] = c_new[new_pl]
                bnd[new_pl[:, None] & bv] = b_new[new_pl[:, None] & bv]
            out = out._replace(pl_coeff=torch.from_numpy(coeff).to(dev),
                               pl_boundary=torch.from_numpy(bnd).to(dev))
        return out

    # ------------------------------------------------------------ batched
    def dispatch_detect(self, m: MapState, slots) -> Tuple[MapState, dict]:
        """The asynchronous half of batched loop detection for up to
        DETECT_BATCH keyframe slots: the indicator refresh and the bow
        rows, then the covisibility product and the L1 scores of every
        slot against the bow table enqueued on the detection stream,
        nothing read back.
        Returns the map and the pending handle ({"slots", "scores" [S, K],
        "covis" [K, K], "done" event or None}); harvest it with
        `harvest_detect`."""
        slots = [int(x) for x in slots]
        assert 0 < len(slots) <= DETECT_BATCH
        t0 = time.perf_counter()
        m = refresh_obs_ind(m)
        for slot in slots:
            self.add_keyframe_bow(m, slot)
        # the inputs as they are now: later writes to the live bow table
        # cannot reach the detection stream's reads
        obs, kf_valid, bow = m.obs_ind, m.kf_valid, self.bow.clone()
        done = None
        if self.device.type == "cuda":
            main = torch.cuda.current_stream(self.device)
            if self._detect_stream is None:
                self._detect_stream = torch.cuda.Stream(self.device)
            side = self._detect_stream
            side.wait_stream(main)
            for t in (obs, kf_valid, bow):
                t.record_stream(side)     # freed only once side is done
            with torch.cuda.stream(side):
                scores, covis = _batch_scores(obs, kf_valid, bow, slots)
                done = torch.cuda.Event()
                done.record(side)
        else:
            scores, covis = _batch_scores(obs, kf_valid, bow, slots)
        self.stats["t_detect"] = (self.stats.get("t_detect", 0.0)
                                  + time.perf_counter() - t0)
        self.stats["n_detect"] = self.stats.get("n_detect", 0) + len(slots)
        return m, {"slots": slots, "scores": scores, "covis": covis,
                   "done": done}

    def harvest_detect(self, m: MapState, pending: dict,
                       kf_valid: Optional[np.ndarray] = None
                       ) -> Tuple[MapState, int, int]:
        """Read a pending detection's statistics and gate its slots in
        insertion order; on a candidate, Sim3 and `correct` run here against
        the current map. After a closure the remaining slots go through
        `on_keyframes`, which computes their statistics again, so no later
        slot gates on stale covisibility or scores. `kf_valid` is the
        validity mask if the caller has read it already. Returns (map,
        loops closed, the last closing slot or -1)."""
        K = m.max_kf
        if pending["done"] is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(pending["done"])
            for t in (pending["scores"], pending["covis"]):
                t.record_stream(main)
        parts = [pending["scores"].reshape(-1), pending["covis"].reshape(-1)]
        if kf_valid is None:
            parts.append(m.kf_valid.float())
        packed = torch.cat(parts).cpu().numpy()
        S = len(pending["slots"])
        scores = packed[:S * K].reshape(S, K)
        covis = packed[S * K:S * K + K * K].reshape(K, K)
        kf_valid = (packed[S * K + K * K:] > 0.5 if kf_valid is None
                    else np.asarray(kf_valid).astype(bool))
        slots = pending["slots"]
        for i, slot in enumerate(slots):
            cand = self._detect_from_stats(slot, scores[i], covis, kf_valid)
            if cand < 0:
                continue
            t0 = time.perf_counter()
            g = self.compute_sim3(m, slot, cand)
            self._tally("sim3", t0)
            if g is None:
                continue
            t0 = time.perf_counter()
            m = self.correct(m, slot, cand, g)
            self._tally("correct", t0)
            rest = slots[i + 1:]
            if rest:
                m, n2, last2 = self.on_keyframes(m, rest)
                return m, 1 + n2, (last2 if last2 >= 0 else slot)
            return m, 1, slot
        return m, 0, -1

    def on_keyframes(self, m: MapState, slots
                     ) -> Tuple[MapState, int, int]:
        """The synchronous batch form: dispatch and harvest per sub-batch
        of up to DETECT_BATCH slots, with the semantics of one
        `on_keyframe` per slot (a closure mid-batch detects on the rest
        with fresh statistics). Returns (map, loops closed, the last closing slot or
        -1)."""
        slots = [int(x) for x in slots]
        n_closed, last = 0, -1
        for lo in range(0, len(slots), DETECT_BATCH):
            m, pending = self.dispatch_detect(m, slots[lo:lo + DETECT_BATCH])
            m, n, ls = self.harvest_detect(m, pending)
            n_closed += n
            last = ls if ls >= 0 else last
        return m, n_closed, last

    # ------------------------------------------------------- per keyframe
    def on_keyframe(self, m: MapState, slot: int
                    ) -> Tuple[MapState, bool]:
        """Loop detection for a new keyframe and, on a candidate, Sim3 and
        the correction. Returns (map, closed)."""
        t0 = time.perf_counter()
        m, scores, covis, kf_valid = self.detect_stats(m, slot)
        cand = self._detect_from_stats(slot, scores, covis, kf_valid)
        self._tally("detect", t0)
        if cand < 0:
            return m, False
        t0 = time.perf_counter()
        g = self.compute_sim3(m, slot, cand)
        self._tally("sim3", t0)
        if g is None:
            return m, False
        t0 = time.perf_counter()
        m = self.correct(m, slot, cand, g)
        self._tally("correct", t0)
        return m, True
