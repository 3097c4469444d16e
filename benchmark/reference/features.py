"""Plain reference of one frame's ORB features (the front end: the image
pyramid, FAST-9 corners with the 20 -> 7 threshold fallback, 3x3
non-maximum suppression, the spatially spread top-k, the intensity-centroid
orientation and the steered BRIEF descriptor), in numpy, as the port's
extractor states them:

1. Level l is the level above resized by 1/scale with an antialiased
   bilinear (triangle) filter, PIL's and PyTorch's: output pixel i spans
   the input around (i + 0.5) * s with weights max(0, 1 - |x| / s),
   normalised. Sizes round(H / scale^l) and round(W / scale^l), at least
   48.
2. A pixel's FAST score is the largest m such that 9 contiguous pixels of
   its radius-3 circle (edges replicated) are all brighter, or all darker,
   than it by m; below the low threshold it is 0. A score that is not the
   largest of its 3x3 neighbourhood is 0. Scores at or above the high
   threshold are raised by 1000.
3. Outside a border of 23 px, each cell of round(30 / scale^l) px (at
   least 8) keeps its 3 best pixels, then the level keeps its best
   `budget` of those; equal scores go to the earlier pixel (row-major in
   the cell, cells row-major). The budgets split `max_keypoints`
   geometrically over the levels, the remainder to level 0.
4. The angle is atan2 of the first moments over the disc of radius 15.
5. The descriptor's 256 bits compare two points of the level blurred by a
   7-tap Gaussian (sigma 2, edges replicated), at the pattern's offsets
   rotated by the angle and rounded.

Pixel arithmetic is float32, as the configuration states it: the scores'
ties and the +1000 lift are float32 ones, and so are the resize's
sampling positions and weights (in float64 a position of the 533-px
level moves by up to 6e-5 px, enough to reorder ties). The resize and
the blur are summed in float64 and stored in float32; `quant` rounds
every stored image (the control passes a bfloat16 rounding)."""

from __future__ import annotations

import numpy as np

F32 = np.float32
CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
])
ARC = 9
HALF = 22               # descriptor patch half-size (rotated tests + blur)
BORDER = HALF + 1
ORI_RADIUS = 15
TOP_PER_CELL = 3


def pattern(seed: int = 42) -> np.ndarray:
    """[256, 4] (y1, x1, y2, x2): ORB's test pairs as the port draws them,
    N(0, (31/5)^2) from numpy's generator seeded 42, rounded, clipped to
    +-13."""
    r = np.random.default_rng(seed)
    pts = r.normal(0.0, 31.0 / 5.0, size=(256, 4))
    return np.clip(np.round(pts), -13, 13).astype(np.int64)


def _aa_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] antialiased bilinear resize matrix, its sampling
    positions and weights in float32."""
    s = F32(n_in) / F32(n_out)
    support = s if s >= 1.0 else F32(1.0)
    inv = F32(1.0) / s if s >= 1.0 else F32(1.0)
    W = np.zeros((n_out, n_in))
    for i in range(n_out):
        c = s * F32(i + 0.5)
        lo = max(int(c - support + F32(0.5)), 0)
        hi = min(int(c + support + F32(0.5)), n_in)
        j = np.arange(hi - lo, dtype=F32)
        w = np.maximum(F32(0), F32(1) - np.abs(
            (j + (F32(lo) - c) + F32(0.5)) * inv))
        W[i, lo:hi] = w / w.sum(dtype=F32)
    return W


def pyramid(img: np.ndarray, n_levels: int, scale: float, quant):
    h, w = img.shape
    out = [quant(img.astype(F32))]
    for l in range(1, n_levels):
        hl = max(int(round(h / scale ** l)), 48)
        wl = max(int(round(w / scale ** l)), 48)
        prev = out[-1].astype(np.float64)
        H, V = _aa_weights(prev.shape[1], wl), _aa_weights(prev.shape[0], hl)
        out.append(quant((V @ (prev @ H.T)).astype(F32)))
    return out


def fast_scores(img: np.ndarray, th_lo: float, th_hi: float) -> np.ndarray:
    h, w = img.shape
    pad = np.pad(img, 3, mode="edge")
    ring = np.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                     for dy, dx in CIRCLE])                    # [16, H, W]
    best = np.zeros((h, w), F32)
    for diff in (ring - img[None], img[None] - ring):
        for a in range(16):
            arc = diff[[(a + k) % 16 for k in range(ARC)]].min(0)
            best = np.maximum(best, arc)
    score = np.where(best >= F32(th_lo), best, F32(0))
    p = np.pad(score, 1, mode="constant", constant_values=-np.inf)
    mx = np.max(np.stack([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                          for dy in (-1, 0, 1) for dx in (-1, 0, 1)]), 0)
    score = np.where((score >= mx) & (score > 0), score, F32(0))
    return np.where(score >= F32(th_hi), score + F32(1000.0), score)


def select(score: np.ndarray, cell: int, budget: int):
    """[(y, x, score)] of the level's kept corners, best first."""
    h, w = score.shape
    s = np.zeros_like(score)
    s[BORDER:h - BORDER, BORDER:w - BORDER] = \
        score[BORDER:h - BORDER, BORDER:w - BORDER]
    cand = []
    for gy in range(h // cell):
        for gx in range(w // cell):
            tile = s[gy * cell:(gy + 1) * cell,
                     gx * cell:(gx + 1) * cell].reshape(-1)
            for i in np.argsort(-tile, kind="stable")[:TOP_PER_CELL]:
                cand.append((gy * cell + i // cell, gx * cell + i % cell,
                             tile[i]))
    vals = np.array([c[2] for c in cand], F32)
    keep = np.argsort(-vals, kind="stable")[:budget]
    return [cand[i] for i in keep if cand[i][2] > 0]


def blur(img: np.ndarray, sigma: float, radius: int = 3) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    h, w = img.shape
    p = np.pad(img.astype(np.float64), radius, mode="edge")
    v = sum(k[i] * p[i:i + h, :] for i in range(2 * radius + 1))
    return sum(k[i] * v[:, i:i + w] for i in range(2 * radius + 1))


def budgets(total: int, n_levels: int, scale: float):
    raw = np.array([(1.0 / scale) ** l for l in range(n_levels)])
    alloc = np.floor(total * raw / raw.sum()).astype(int)
    alloc[0] += total - alloc.sum()
    return alloc


def extract(img: np.ndarray, p: dict, quant=lambda a: a) -> dict:
    """{(level, y, x): (angle, bits [256] bool)} of the frame's features;
    `p` holds the extractor's settings (n_levels, scale_factor,
    ini_th_fast, min_th_fast, max_keypoints, cell_size, blur_sigma)."""
    L, sc = int(p["n_levels"]), float(p["scale_factor"])
    pyr = pyramid(img, L, sc, quant)
    pat = pattern()
    yy, xx = np.mgrid[-HALF:HALF + 1, -HALF:HALF + 1]
    disc = (yy ** 2 + xx ** 2) <= ORI_RADIUS ** 2
    out = {}
    for l, budget in enumerate(budgets(int(p["max_keypoints"]), L, sc)):
        if budget == 0:
            continue
        lvl = pyr[l]
        cell = max(int(round(p["cell_size"] / sc ** l)), 8)
        kps = select(fast_scores(lvl, p["min_th_fast"] / 255.0,
                                 p["ini_th_fast"] / 255.0), cell, budget)
        if not kps:
            continue
        blurred = quant(blur(lvl, float(p["blur_sigma"])).astype(F32))
        for y, x, _ in kps:
            patch = lvl[y - HALF:y + HALF + 1,
                        x - HALF:x + HALF + 1].astype(np.float64)
            ang = np.arctan2((yy * disc * patch).sum(),
                             (xx * disc * patch).sum())
            ca, sa = np.cos(ang), np.sin(ang)
            ys = np.concatenate([pat[:, 0], pat[:, 2]])
            xs = np.concatenate([pat[:, 1], pat[:, 3]])
            ry = np.clip(np.round(sa * xs + ca * ys), -HALF, HALF)
            rx = np.clip(np.round(ca * xs - sa * ys), -HALF, HALF)
            vals = blurred[y + ry.astype(int), x + rx.astype(int)]
            out[(l, int(y), int(x))] = (ang, vals[:256] < vals[256:])
    return out


def program_features(uv, level, valid, desc_packed, scale: float) -> dict:
    """The program's features as `extract` gives them: {(level, y, x):
    (None, bits)}, the level pixel recovered from level-0 `uv`."""
    out = {}
    words = desc_packed.astype(np.int64) & 0xFFFFFFFF
    bits = ((words[:, :, None] >> np.arange(32)) & 1).astype(bool)
    bits = bits.reshape(len(uv), 256)
    for i in np.nonzero(valid)[0]:
        l = int(level[i])
        y = int(round(float(uv[i, 1]) / scale ** l))
        x = int(round(float(uv[i, 0]) / scale ** l))
        out[(l, y, x)] = (None, bits[i])
    return out


def gaps(prog: dict, ref: dict):
    """(keypoints in one set and not the other, keypoints in both,
    descriptor bits that differ over those)."""
    both = prog.keys() & ref.keys()
    miss = len(prog.keys() ^ ref.keys())
    bits = sum(int((prog[k][1] != ref[k][1]).sum()) for k in both)
    return miss, len(both), bits
