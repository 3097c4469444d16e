"""Map-sharded steady step: the live map held in row blocks over the ranks
of an (``lm``, ``kf``) mesh (port of
`eao_fusion_tpu/parallel/sharded_step.py`).

The JAX module jits the unchanged `steady.slam_step` with the map's fields
placed on the mesh and lets GSPMD split the landmark-axis work. PyTorch
has no GSPMD, so here the split is written out. One process runs each
rank, as in `dist_ba`, and holds

  * its block of every sharded map field: the rows of the point tables
    (``pt_*``) over ``lm``, the rows of the keyframe tables (``kf_*``) over
    ``kf``, and the [K/n_kf, P/n_lm] block of ``obs_ind``; the same rows
    that JAX's `NamedSharding` gives the device at the same mesh position;
  * whole copies of the rest: the plane tables and counters, the track
    state, the object table, the last frame's objects, the frame id and a
    random generator in the same state on every rank.

Every rank runs the replicated work of a frame (feature extraction, plane
segmentation, both pose solves, the keyframe decision, the object lane)
on the same inputs, so every rank computes the same bits. The
landmark-axis steps of `tracking.track_frame` go through `ShardedMap`:

  * the frustum and view-cone gate, the visible / found counters and the
    local-map projection search run on the rank's point rows; the search
    resolves a keypoint claimed by several rows (lowest distance, then
    lowest row) by one all-reduce MIN over ``lm`` of the key
    distance · P + global row;
  * the products with the observation indicator (the votes of the local
    and the reference keyframe, the points of the local keyframes, the
    points' observation counts) run on the rank's block, followed by SUMs
    over ``lm`` and ``kf``; they are float32 sums of 0 and 1, exact below
    2^24, so the split changes no bit;
  * rows read by global index (the reference keyframe's row; the point
    table, gathered whole once a frame for the pose solves and the object
    lane) are a SUM of zero-padded blocks over their bytes: exact, -0.0
    included (each byte is one rank's, plus zeros).

The keyframe branch (insertion, point creation, the plane update, local
mapping with K2 / K3 / K4) and the object merge run on the map gathered
whole, on every rank, after which each rank keeps its rows: the resident
map is split, the peak during a keyframe is not.

Only `all_reduce` (SUM and MIN) is used: gloo runs it on CUDA tensors, and
ranks that share one card need gloo. A failed collective raises; no path
falls back to the unsharded step.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from eao_fusion_tpu_torch.config import SystemConfig
from eao_fusion_tpu_torch.frontend import matcher
from eao_fusion_tpu_torch.mapping import covisibility
from eao_fusion_tpu_torch.mapping import map_state as ms
from eao_fusion_tpu_torch.objects import object_map as om
from eao_fusion_tpu_torch.parallel import multihost
from eao_fusion_tpu_torch.pipeline import steady, tracking

LM, KF = 0, 1     # the mesh's axes


def _placements(field: str) -> tuple:
    """The placements of MapState field `field` over the mesh's (lm, kf)
    axes."""
    if field == "obs_ind":
        return (Shard(1), Shard(0))
    if field.startswith("pt_"):
        return (Shard(0), Replicate())
    if field.startswith("kf_"):
        return (Replicate(), Shard(0))
    return (Replicate(), Replicate())    # pl_* plane tables, next_* counters


def map_shardings(mesh: DeviceMesh) -> ms.MapState:
    """The placements of every MapState field over the mesh's (lm, kf)
    axes: point tables sharded over ``lm``, keyframe tables over ``kf``,
    the [K, P] observation indicator over both (rows over ``kf``, columns
    over ``lm``), the rest replicated. Descriptions only: the tensors are
    plain local blocks."""
    return ms.MapState(**{f: _placements(f) for f in ms.MapState._fields})


def block_index(field: str, shape: Sequence[int], mesh_shape: Sequence[int],
                coord: Sequence[int]) -> tuple:
    """The index (one slice per dimension) of the block of MapState field
    `field`, whole shape `shape`, that the rank at mesh position `coord`
    = (i_lm, i_kf) of an (n_lm, n_kf) mesh holds: contiguous equal blocks,
    as `NamedSharding.devices_indices_map` gives them."""
    idx = [slice(None)] * len(shape)
    for axis, pl in enumerate(_placements(field)):
        if isinstance(pl, Shard):
            n = shape[pl.dim] // mesh_shape[axis]
            idx[pl.dim] = slice(coord[axis] * n, (coord[axis] + 1) * n)
    return tuple(idx)


def _check_mesh(mesh: DeviceMesh, n_points: int, n_keyframes: int) -> None:
    """Raise unless a process group is up, the mesh fits it and holds this
    rank, and the capacities split evenly over the mesh."""
    if not dist.is_initialized():
        raise RuntimeError("the sharded step needs an initialized "
                           "torch.distributed process group "
                           "(multihost.ensure_initialized)")
    if tuple(mesh.mesh_dim_names) != ("lm", "kf"):
        raise ValueError(f"the mesh's dims are {mesh.mesh_dim_names}, not "
                         f"('lm', 'kf') (mesh.make_mesh)")
    n_lm, n_kf = mesh.mesh.shape
    world = dist.get_world_size()
    if mesh.mesh.numel() > world:
        raise ValueError(f"a {n_lm} x {n_kf} mesh does not fit a group of "
                         f"{world} ranks")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    bad = [f"{name} = {n} does not divide over {axis} = {d}"
           for name, n, axis, d in (("max_points", n_points, "n_lm", n_lm),
                                    ("max_keyframes", n_keyframes, "n_kf",
                                     n_kf)) if n % d]
    if bad:
        raise ValueError("; ".join(bad))


def _device(mesh: DeviceMesh) -> torch.device:
    """The rank's device: the CPU on a CPU mesh, else its card
    (`multihost.local_device`)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return multihost.local_device()


class ShardedMap(tracking.WholeMap):
    """`tracking.WholeMap`'s steps on this rank's blocks of a map split over
    an (lm, kf) mesh, with the collectives that make each step's result
    the whole map's. Counts its collectives (`calls`, `bytes` of this
    rank's payload) and their host ms (`ms`; with `timed` set, between
    synchronizations of the card, so that earlier work is not counted)."""

    def __init__(self, mesh: DeviceMesh, n_points: int, n_keyframes: int):
        _check_mesh(mesh, n_points, n_keyframes)
        self.mesh = mesh
        self.shape = tuple(int(n) for n in mesh.mesh.shape)
        self.coord = tuple(int(i) for i in mesh.get_coordinate())
        self.groups = (mesh.get_group("lm"), mesh.get_group("kf"))
        self.device = _device(mesh)
        self.P, self.K = n_points, n_keyframes
        self.P_loc = n_points // self.shape[LM]
        self.K_loc = n_keyframes // self.shape[KF]
        self.pt_block = slice(self.coord[LM] * self.P_loc,
                              (self.coord[LM] + 1) * self.P_loc)
        self.kf_block = slice(self.coord[KF] * self.K_loc,
                              (self.coord[KF] + 1) * self.K_loc)
        self._points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.timed = False
        self.reset_stats()

    # ------------------------------------------------------- collectives

    def reset_stats(self) -> None:
        self.calls, self.bytes, self.ms = 0, 0, 0.0

    def _reduce(self, t: torch.Tensor, axis: int,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
        """all_reduce `t` in place over the mesh axis `axis` (nothing on an
        axis of one rank)."""
        if self.shape[axis] == 1:
            return t
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=self.groups[axis])
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.ms += (time.perf_counter() - t0) * 1e3
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        return t

    def _assemble(self, items, axis: int) -> list:
        """Whole tensors from blocks: each (block, whole shape, index) is
        zero-padded to its whole shape, and one all_reduce SUM over `axis`
        of the bytes of all of them fills in the other ranks' blocks."""
        if self.shape[axis] == 1:
            return [blk for blk, _, _ in items]
        wholes, flat = [], []
        for blk, shape, idx in items:
            w = torch.zeros(shape, dtype=blk.dtype, device=blk.device)
            w[idx] = blk
            wholes.append(w)
            b = w.reshape(-1).view(torch.uint8)
            pad = -b.numel() % 8          # keeps every part 8-byte aligned
            flat.append(torch.cat([b, b.new_zeros(pad)]) if pad else b)
        buf = self._reduce(torch.cat(flat), axis)
        out, at = [], 0
        for w, b in zip(wholes, flat):
            out.append(buf[at:at + w.numel() * w.element_size()]
                       .view(w.dtype).reshape(w.shape))
            at += b.numel()
        return out

    def _kf_whole(self, *blocks: torch.Tensor) -> list:
        """[K] vectors from their [K/n_kf] blocks of this rank."""
        return self._assemble([(b, (self.K,) + tuple(b.shape[1:]),
                                self.kf_block) for b in blocks], KF)

    # ------------------------------------------------- tracking's steps

    def n_points(self, m: ms.MapState) -> int:
        return self.P

    def n_keyframes(self, m: ms.MapState) -> int:
        return self.K

    def begin_frame(self, m: ms.MapState) -> None:
        """Gathers the whole pt_xyz / pt_valid, which the frame's pose
        solves and object lane read by point id."""
        self._points = tuple(self._assemble(
            [(m.pt_xyz, (self.P, 3), self.pt_block),
             (m.pt_valid, (self.P,), self.pt_block)], LM))

    def point_rows(self, m, idx):
        xyz, valid = self._points
        return xyz[idx], valid[idx]

    def whole_points(self, m):
        return self._points

    def kf_rows(self, m, k, names) -> tuple:
        if self.shape[KF] == 1:
            return super().kf_rows(m, k, names)
        j = torch.as_tensor(k, device=self.device).long() - \
            self.kf_block.start
        mine = (j >= 0) & (j < self.K_loc)
        rows = [getattr(m, n)[torch.clamp(j, 0, self.K_loc - 1)]
                for n in names]
        return tuple(self._assemble(
            [(torch.where(mine, r, torch.zeros_like(r)), r.shape, ...)
             for r in rows], KF))

    def mark(self, m, idx):
        i = idx.long() - self.pt_block.start
        own = (idx >= 0) & (i >= 0) & (i < self.P_loc)
        out = torch.zeros((self.P_loc,), dtype=torch.bool, device=idx.device)
        out[i[own]] = True
        return out

    def local_keyframes(self, m, Z, seen, k_top):
        votes = self._reduce(Z @ seen.float(), LM)
        votes, kf_valid = self._kf_whole(votes, m.kf_valid)
        return covisibility.select_local_keyframes(votes, kf_valid, k_top)

    def points_of_keyframes(self, Z, kf_mask):
        held = kf_mask[self.kf_block].float()
        return self._reduce(Z.T @ held, KF) > 0.5

    def match_points_to_frame(self, pts_w, pt_desc_pm1, pt_valid,
                              pt_ref_angle, pt_level, radius_px, level_lo,
                              level_hi, feats, tcw, *, cam, width: int,
                              height: int, th: int = 100,
                              nn_ratio: float = 1.0, use_ratio: bool = False,
                              histo_length: int = 30,
                              check_rotation: bool = True
                              ) -> matcher.MatchResult:
        if check_rotation:
            raise ValueError("the sharded projection search has no "
                             "rotation check")
        best_kp, best, ok = matcher.candidate_matches(
            pts_w, pt_desc_pm1, pt_valid, radius_px, level_lo, level_hi,
            feats, tcw, cam=cam, width=width, height=height, th=th,
            nn_ratio=nn_ratio, use_ratio=use_ratio)
        dev = best.device
        rows = torch.arange(self.pt_block.start, self.pt_block.stop,
                            dtype=torch.int64, device=dev)
        # `matcher.resolve_duplicates` with global rows, its scatter-min
        # finished over the ranks
        key = torch.where(ok, best.long() * self.P + rows, matcher.INF)
        slot = torch.where(ok, best_kp.long(), 0)
        best_key = torch.full((feats.uv.shape[0],), matcher.INF,
                              dtype=torch.int64, device=dev)
        best_key = best_key.scatter_reduce(0, slot, key, reduce="amin")
        best_key = self._reduce(best_key, LM, dist.ReduceOp.MIN)
        hit = best_key < matcher.INF
        return matcher.MatchResult(
            target_idx=torch.where(hit, best_key % self.P, -1).to(
                torch.int32),
            dist=torch.where(hit, best_key // self.P, matcher.INF).to(
                torch.int32))

    def reference_keyframe(self, Z, found, cand):
        v = self._reduce(torch.cat([Z @ found.float(),
                                    cand.sum().float()[None]]), LM)
        votes, = self._kf_whole(v[:-1])
        return torch.argmax(votes).to(torch.int32), v[-1].long()

    def point_obs_at(self, Z, idx):
        i = torch.clamp(idx.long(), min=0) - self.pt_block.start
        own = (i >= 0) & (i < self.P_loc)
        cnt = torch.sum(Z, dim=0)[torch.clamp(i, 0, self.P_loc - 1)]
        cnt = torch.where(own, cnt, 0.0)
        return self._reduce(self._reduce(cnt, LM), KF)

    # --------------------------------------------- the keyframe branch

    def gather(self, m: ms.MapState) -> ms.MapState:
        out = m._asdict()
        pt = [f for f in out if f.startswith("pt_")]
        kf = [f for f in out if f.startswith("kf_")]
        got = self._assemble(
            [(out[f], (self.P,) + tuple(out[f].shape[1:]), self.pt_block)
             for f in pt]
            + [(m.obs_ind, (self.K_loc, self.P), (slice(None),
                                                  self.pt_block))], LM)
        out.update(zip(pt, got))
        got = self._assemble(
            [(out[f], (self.K,) + tuple(out[f].shape[1:]), self.kf_block)
             for f in kf] + [(got[-1], (self.K, self.P), self.kf_block)],
            KF)
        out.update(zip(kf, got))
        out["obs_ind"] = got[-1]
        return ms.MapState(**out)

    def keep_rows(self, m: ms.MapState) -> ms.MapState:
        return ms.MapState(**{f: self._block(f, v)
                              for f, v in m._asdict().items()})

    def _block(self, field: str, v: torch.Tensor) -> torch.Tensor:
        idx = block_index(field, v.shape, self.shape, self.coord)
        if all(s == slice(None) for s in idx):
            return v
        return v[idx].clone()


class ShardedState(NamedTuple):
    """The steady carry of one rank: `m` holds this rank's blocks of the
    sharded map fields (`map_shardings`) and whole copies of the rest;
    `maps` holds the mesh, the rank's row blocks and the collectives."""
    m: ms.MapState
    ts: tracking.TrackState
    objs: om.ObjectTable
    last_fo: om.FrameObjects
    frame_id: int
    generator: torch.Generator
    maps: ShardedMap


def _to(tree, dev):
    """A NamedTuple of tensors (nested ones too) moved to `dev`."""
    return type(tree)(*(_to(x, dev) if isinstance(x, tuple) else x.to(dev)
                        for x in tree))


def shard_state(st: steady.SteadyState, mesh: DeviceMesh) -> ShardedState:
    """This rank's part of an unsharded SteadyState that every rank holds:
    its blocks of the sharded fields and whole copies of the rest, on its
    device, with a generator in the generator's state."""
    maps = ShardedMap(mesh, st.m.max_pt, st.m.max_kf)
    dev = maps.device
    if st.generator.device.type != dev.type:
        raise ValueError(f"a {st.generator.device.type} generator's state "
                         f"does not carry to a {dev.type} rank")
    gen = torch.Generator(device=dev)
    gen.set_state(st.generator.get_state())
    return ShardedState(m=_to(maps.keep_rows(st.m), dev), ts=_to(st.ts, dev),
                        objs=_to(st.objs, dev),
                        last_fo=_to(st.last_fo, dev), frame_id=st.frame_id,
                        generator=gen, maps=maps)


def unshard_state(sst: ShardedState) -> steady.SteadyState:
    """The whole SteadyState, on every rank of the mesh (collective)."""
    return steady.SteadyState(m=sst.maps.gather(sst.m), ts=sst.ts,
                              objs=sst.objs, last_fo=sst.last_fo,
                              frame_id=sst.frame_id, generator=sst.generator)


def _steady(sst: ShardedState) -> steady.SteadyState:
    return steady.SteadyState(*sst[:-1])


def _on(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev)


def make_sharded_slam_step(mesh: DeviceMesh, cfg: SystemConfig,
                           kf_every: int = 0):
    """`steady.slam_step` over a map sharded on the mesh. Returns
    fn(sst, gray, depth, boxes, timestamp) -> (sst, diag), which every
    rank of the mesh calls with the same frame; `diag` is the unsharded
    step's."""
    _check_mesh(mesh, cfg.capacity.max_points, cfg.capacity.max_keyframes)

    def step(sst: ShardedState, gray, depth, boxes, timestamp):
        dev = sst.maps.device
        st, diag = steady.slam_step(
            _steady(sst), _on(gray, dev), _on(depth, dev), _on(boxes, dev),
            float(timestamp), cfg=cfg, kf_every=kf_every, maps=sst.maps)
        return ShardedState(*st, maps=sst.maps), diag
    return step


def make_sharded_slam_chunk(mesh: DeviceMesh, cfg: SystemConfig,
                            kf_every: int = 0):
    """`steady.slam_chunk` over a map sharded on the mesh: fn(sst, grays,
    depths, boxes, timestamps) -> (sst, the stacked `steady.CHUNK_DIAG`)."""
    _check_mesh(mesh, cfg.capacity.max_points, cfg.capacity.max_keyframes)

    def chunk(sst: ShardedState, grays, depths, boxes, timestamps):
        dev = sst.maps.device
        st, diag = steady.slam_chunk(
            _steady(sst), _on(grays, dev), _on(depths, dev), _on(boxes, dev),
            timestamps, cfg=cfg, kf_every=kf_every, maps=sst.maps)
        return ShardedState(*st, maps=sst.maps), diag
    return chunk


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's values as int64 bit patterns, flattened."""
    t = t.reshape(-1)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32).long()
    return t.long()


def assert_replicated(sst: ShardedState) -> None:
    """Raise unless the replicated state is the same, bit for bit, on every
    rank of the mesh: the pose, `kp_pt`, `next_kf`, `next_pt`, the frame id
    and the object table (a MIN and a MAX of their bits over the mesh).
    Collective; for tests and checks, not the hot path."""
    maps = sst.maps
    named = {"pose": sst.ts.pose, "kp_pt": sst.ts.kp_pt,
             "next_kf": sst.m.next_kf, "next_pt": sst.m.next_pt,
             "frame_id": torch.tensor(sst.frame_id),
             **{f"objs.{k}": v for k, v in sst.objs._asdict().items()}}
    parts = [_bits(v.to(maps.device)) for v in named.values()]
    lo = torch.cat(parts)
    hi = lo.clone()
    for axis in (LM, KF):
        if maps.shape[axis] > 1:
            dist.all_reduce(lo, op=dist.ReduceOp.MIN,
                            group=maps.groups[axis])
            dist.all_reduce(hi, op=dist.ReduceOp.MAX,
                            group=maps.groups[axis])
    differ, at = [], 0
    for name, p in zip(named, parts):
        if bool((lo[at:at + p.numel()] != hi[at:at + p.numel()]).any()):
            differ.append(name)
        at += p.numel()
    if differ:
        raise RuntimeError(f"rank {dist.get_rank()}: the replicated state "
                           f"differs across the mesh in {differ}")
