"""Plain reference of the object lane's table update for one frame (EAO's
`Object_Map` data association outcome applied to the map objects, as the
port's `objects/update.py` states it), in numpy, one frame object and one
member at a time. It starts from the table, the frame objects and their
association as the program had them before the call.

1. Each map object keeps one associated frame object, the one with the
   most points (the first on a tie).
2. Its member points are gated by the distance to the object's centre
   (within 0.9 of its radius once it has more than 5 frames, 1.0 before;
   anything on its first frame); a point already a member counts one more
   observation, a new one takes the lowest free member slot, in sample
   order, while slots last, with one observation.
3. The object counts a frame: last and second-last frame and box, the sums
   of the frame objects' centres and of their squares.
4. Where the box lies 25 px inside the image, members seen at most 8 times
   that project into the image but outside the box leave.
5. A valid frame object with no association, off the image edge, with at
   least `min_points_init` points makes a new object in the next row,
   while rows last.
6. Every row's centre, spread, cuboid and radius are those of its members.
7. Objects seen together count it; each kept frame object's potential
   associations count one."""

from __future__ import annotations

import numpy as np

F32 = np.float32
EXACT = ("cls", "valid", "pt_idx", "pt_ok", "pt_addcnt", "n_frames",
         "last_frame", "lastlast_frame", "reobj", "sametime", "next_obj")
CLOSE = ("center", "cub_min", "cub_max", "rmax", "cen_sum", "cen_sq",
         "last_rect", "lastlast_rect")


def _cross(a, b):
    return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                     a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                     a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _project(tcw, x, cam):
    """(z, u, v) of world points `x` in camera `tcw`, in float32 with the
    quaternion rotation v + 2 (w (u x v) + u x (u x v)), as the port's
    pose arithmetic states it (a member on the box's edge is decided by
    the same roundings)."""
    tcw, x = tcw.astype(F32), x.astype(F32)
    w, u = tcw[0], tcw[1:4]
    uv = _cross(u[None], x)
    pc = x + F32(2.0) * (w * uv + _cross(u[None], uv)) + tcw[4:7]
    z = np.maximum(pc[:, 2:3], F32(1e-8))
    fx, fy, cx, cy = (F32(c) for c in cam)
    return (pc[:, 2], (fx * pc[:, 0:1] / z + cx)[:, 0],
            (fy * pc[:, 1:2] / z + cy)[:, 0])


def update(tab: dict, fo: dict, target, potential, pt_xyz, tcw, fid: int,
           cam, W: int, H: int, min_points_init: int,
           quant=lambda a: a) -> dict:
    """The table after the frame's update; every argument a numpy array
    (the table and the frame objects as dicts of their fields). `quant`
    rounds the points and the spread's means (the control passes a
    bfloat16 rounding)."""
    pt_xyz = quant(pt_xyz)
    t = {k: np.array(v, copy=True) for k, v in tab.items()}
    F, S = fo["pt_ids"].shape
    O, M = t["pt_idx"].shape
    # 1. one frame object per map object
    winner = {}
    for f in range(F):
        o = int(target[f])
        if o < 0:
            continue
        if o not in winner or fo["n_pts"][f] > fo["n_pts"][winner[o]]:
            winner[o] = f
    old = {k: t[k].copy() for k in ("pt_idx", "pt_ok", "center", "rmax",
                                    "n_frames")}
    margin = {}
    for o, f in winner.items():
        # 2. members
        th = 0.9 if old["n_frames"][o] > 5 else 1.0
        first = old["n_frames"][o] == 0
        members = {}
        for m in range(M):
            if old["pt_ok"][o, m]:
                members.setdefault(int(old["pt_idx"][o, m]), m)
        free = [m for m in range(M) if not old["pt_ok"][o, m]]
        for s in range(S):
            if not fo["pt_valid"][f, s]:
                continue
            d = np.linalg.norm(fo["pt_w"][f, s] - old["center"][o])
            if not (first or d <= old["rmax"][o] * th):
                continue
            pid = int(fo["pt_ids"][f, s])
            if pid in members:
                t["pt_addcnt"][o, members[pid]] += 1
            elif free:
                m = free.pop(0)
                t["pt_idx"][o, m], t["pt_ok"][o, m] = pid, True
                t["pt_addcnt"][o, m] = 1
        # 3. bookkeeping
        t["n_frames"][o] += 1
        t["lastlast_frame"][o] = t["last_frame"][o]
        t["last_frame"][o] = fid
        t["lastlast_rect"][o] = t["last_rect"][o]
        t["last_rect"][o] = fo["box"][f]
        t["cen_sum"][o] = t["cen_sum"][o] + fo["center"][f]
        t["cen_sq"][o] = t["cen_sq"][o] + fo["center"][f] * fo["center"][f]
        b = fo["box"][f]
        margin[o] = b[0] > 25 and b[1] > 25 and b[2] < W - 25 and b[3] < H - 25
    # 4. members outside the box
    for o, f in winner.items():
        if not margin[o]:
            continue
        b = fo["box"][f]
        ids = np.maximum(t["pt_idx"][o], 0)
        z, u, v = _project(tcw, pt_xyz[ids], cam)
        in_img = (z > 0.05) & (u > 0) & (u < W) & (v > 0) & (v < H)
        inside = (u >= b[0]) & (u <= b[2]) & (v >= b[1]) & (v <= b[3])
        t["pt_ok"][o] &= ~(in_img & ~inside & (t["pt_addcnt"][o] <= 8))
    # 5. new objects
    nxt = int(t["next_obj"])
    made = []
    for f in range(F):
        if not (fo["valid"][f] and target[f] < 0 and not fo["on_edge"][f]
                and fo["n_pts"][f] >= min_points_init):
            continue
        row = nxt + len(made)
        made.append(row)
        if row >= O:
            continue
        t["cls"][row], t["valid"][row] = fo["cls"][f], True
        t["pt_idx"][row] = -1
        t["pt_idx"][row, :S] = fo["pt_ids"][f]
        t["pt_ok"][row] = False
        t["pt_ok"][row, :S] = fo["pt_valid"][f]
        t["pt_addcnt"][row] = 0
        t["pt_addcnt"][row, :S] = fo["pt_valid"][f]
        t["n_frames"][row] = 1
        t["last_frame"][row] = t["lastlast_frame"][row] = fid
        t["last_rect"][row] = t["lastlast_rect"][row] = fo["box"][f]
        t["cen_sum"][row] = fo["center"][f]
        t["cen_sq"][row] = fo["center"][f] * fo["center"][f]
    t["next_obj"] = np.array(min(nxt + len(made), O), t["next_obj"].dtype)
    # 6. member statistics, every row
    for o in range(O):
        ok = t["pt_ok"][o]
        p = pt_xyz[np.maximum(t["pt_idx"][o], 0)][ok].astype(np.float64)
        n = max(len(p), 1)
        c = quant(p.sum(0) / n) if len(p) else np.zeros(3)
        sq = quant((p * p).sum(0) / n) if len(p) else np.zeros(3)
        t["center"][o] = c
        t["std"][o] = np.sqrt(np.maximum(quant(sq - c * c), 0))
        lo = p.min(0) if len(p) else np.zeros(3)
        hi = p.max(0) if len(p) else np.zeros(3)
        t["cub_min"][o], t["cub_max"][o] = lo, hi
        t["rmax"][o] = np.linalg.norm(np.maximum(np.abs(lo - c),
                                                 np.abs(hi - c)))
    # 7. co-occurrence and potential associations
    present = sorted(set(winner) | {r for r in made if r < O})
    for a in present:
        for b in present:
            if a != b:
                t["sametime"][a, b] += 1
    for o, f in winner.items():
        t["reobj"][o] += potential[f].astype(t["reobj"].dtype)
    return t


def gaps(prog: dict, ref: dict):
    """(entries of the exact fields that differ, largest gap of the
    float fields in m or px, largest gap of the spread in m)."""
    def gap(k):
        return float(np.max(np.abs(np.asarray(prog[k], np.float64)
                                   - np.asarray(ref[k], np.float64))))
    n = sum(int((np.asarray(prog[k]) != np.asarray(ref[k])).sum())
            for k in EXACT)
    return n, max(gap(k) for k in CLOSE), gap("std")
