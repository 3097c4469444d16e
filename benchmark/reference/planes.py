"""Plain reference of one frame's plane segmentation (PEAC's windowed
fitting with label-propagation merging, as the port's `ops/planes.py`
states it), in numpy, float64:

1. Pixels with depth in (0.1, 10) m are back-projected at their centres.
   The image is cut into `window`-px windows (a ragged edge is dropped);
   each window's plane is the least-squares fit of its valid points: the
   eigenvector of the smallest eigenvalue of their covariance (that
   eigenvalue is the window's mean squared error), the normal turned so
   that its offset d = -n . mean is not negative.
2. A window is planar with at least 80 % of its pixels valid and a mean
   squared error under mse_max * max(mean z, 0.3)^2.
3. Each planar window starts with its own index as its label. A sweep
   takes the four directions in turn (right, left, down, up): every
   window whose neighbour that way may merge with it (both planar,
   normals' dot above merge_normal_dot, the neighbour's mean within
   merge_dist of the window's plane) takes the lesser of the two labels,
   all windows at once from the labels after the direction before. It
   then replaces every label by its label's label, twice.
   `n_merge_sweeps` sweeps.
4. Each label's windows' points are fitted again as one plane; labels
   with at least min_support_px points are planes, the largest first
   (equal supports: the lower label), at most max_planes_per_frame.
5. A plane's boundary is the samples of every 8th row and column that lie
   within 3 cm of it, nearest first, at most max_boundary_points.

`quant` rounds the depth image (the control passes a bfloat16 rounding)."""

from __future__ import annotations

import numpy as np

STRIDE = 8


def _fit(n, s, pp):
    """(normal [G, 3], d [G], mse [G], mean [G, 3]) from point counts,
    sums and sums of outer products."""
    nf = np.maximum(n, 1.0)
    mu = s / nf[:, None]
    cov = pp / nf[:, None, None] - mu[:, :, None] * mu[:, None, :]
    lam, vec = np.linalg.eigh(cov)
    normal = vec[:, :, 0]
    d = -(normal * mu).sum(-1)
    flip = d < 0
    normal[flip] *= -1.0
    d = np.abs(d)
    return normal, d, np.maximum(lam[:, 0], 0.0), mu


def segment(depth: np.ndarray, cam, p: dict, quant=lambda a: a) -> dict:
    """{"coeffs" [P, 4], "n_inliers" [P], "n_boundary" [P]} of the frame's
    planes, largest first; `cam` is (fx, fy, cx, cy), `p` the segmentation
    settings."""
    z = quant(depth.astype(np.float32)).astype(np.float64)
    H, W = z.shape
    fx, fy, cx, cy = cam
    u = np.arange(W) + 0.5
    v = np.arange(H) + 0.5
    x = (u[None, :] - cx) / fx * z
    y = (v[:, None] - cy) / fy * z
    valid = (z > 0.1) & (z < 10.0)
    win = int(p["window"])
    gh, gw = H // win, W // win
    G = gh * gw

    def wsum(a):
        a = np.where(valid, a, 0.0)[:gh * win, :gw * win]
        return a.reshape(gh, win, gw, win).sum((1, 3)).reshape(G)

    P3 = (x, y, z)
    n = wsum(np.ones_like(z))
    s = np.stack([wsum(a) for a in P3], -1)
    pp = np.stack([np.stack([wsum(a * b) for b in P3], -1) for a in P3], -2)
    normal, d, mse, mu = _fit(n, s, pp)
    planar = (n >= int(0.8 * win * win)) & \
        (mse < p["mse_max"] * np.maximum(mu[:, 2], 0.3) ** 2)

    def may_merge(g, h):
        return (planar[g] and planar[h]
                and normal[g] @ normal[h] > p["merge_normal_dot"]
                and abs(normal[g] @ (mu[h] - mu[g])) < p["merge_dist"])

    steps = ((0, 1), (0, -1), (1, 0), (-1, 0))
    nbr = np.full((4, G), -1)
    for g in range(G):
        r, c = divmod(g, gw)
        for k, (dr, dc) in enumerate(steps):
            h = (r + dr) * gw + c + dc
            if 0 <= r + dr < gh and 0 <= c + dc < gw and may_merge(g, h):
                nbr[k, g] = h
    label = np.where(planar, np.arange(G), G)
    for _ in range(int(p["n_merge_sweeps"])):
        for k in range(4):
            has = nbr[k] >= 0
            label = np.where(has, np.minimum(
                label, label[np.maximum(nbr[k], 0)]), label)
        for _ in range(2):
            label = np.where(label >= G, G, label[np.minimum(label, G - 1)])
        label = np.where(planar, label, G)
    seg_n = np.zeros(G)
    seg_s = np.zeros((G, 3))
    seg_pp = np.zeros((G, 3, 3))
    for g in np.nonzero(label < G)[0]:
        seg_n[label[g]] += n[g]
        seg_s[label[g]] += s[g]
        seg_pp[label[g]] += pp[g]
    seg_normal, seg_d, _, _ = _fit(seg_n, seg_s, seg_pp)
    ok = seg_n >= p["min_support_px"]
    order = [g for g in np.argsort(-np.where(ok, seg_n, 0.0), kind="stable")
             if ok[g]][:int(p["max_planes_per_frame"])]
    coeffs = np.array([[*seg_normal[g], seg_d[g]] for g in order]
                      ).reshape(-1, 4)
    pts = np.stack([a[::STRIDE, ::STRIDE].reshape(-1) for a in P3], -1)
    pts_ok = valid[::STRIDE, ::STRIDE].reshape(-1)
    dist = np.abs(pts @ coeffs[:, :3].T + coeffs[None, :, 3])
    n_bnd = np.minimum(((dist < 0.03) & pts_ok[:, None]).sum(0),
                       int(p["max_boundary_points"]))
    return dict(coeffs=coeffs, n_inliers=seg_n[order].astype(np.int64),
                n_boundary=n_bnd.astype(np.int64))


def gaps(prog: dict, ref: dict):
    """(planes whose presence, support or boundary count differ; the
    largest gap of the planes of equal rank: the angle between normals in
    rad or the offsets' difference in m, whichever is larger). `prog`
    holds the program's `coeffs`, `n_inliers`, `valid` and
    `boundary_valid`."""
    keep = np.nonzero(prog["valid"])[0]
    n_ref = len(ref["n_inliers"])
    miss = abs(len(keep) - n_ref)
    gap = 0.0
    for j, i in enumerate(keep[:n_ref]):
        if (int(prog["n_inliers"][i]) != ref["n_inliers"][j]
                or int(prog["boundary_valid"][i].sum())
                != ref["n_boundary"][j]):
            miss += 1
        a = prog["coeffs"][i].astype(np.float64)
        b = ref["coeffs"][j]
        ang = np.arctan2(np.linalg.norm(np.cross(a[:3], b[:3])),
                         a[:3] @ b[:3])
        gap = max(gap, float(ang), abs(float(a[3] - b[3])))
    return miss, gap
