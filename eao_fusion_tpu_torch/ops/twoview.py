"""Monocular two-view initialization: H / F RANSAC, model selection, motion
recovery, initial triangulation (port of `eao_fusion_tpu/ops/twoview.py`).

`src/Initializer.cc` as in the JAX package: all hypotheses at once (8-point
F, 4-point H, normalized DLT, the JAX `vmap` a batch axis), scored with the
reference's symmetric-transfer truncated scores; the model chosen by RH =
SH / (SH + SF) > 0.40; motion recovered from the essential-matrix SVD (4
candidates) and the Faugeras decomposition of H (8 candidates), the
candidate with the most valid triangulations winning.

The draws are split from the solver, as `ops/ransac.py` splits them:
`draw_two_view_hypotheses` takes a `torch.Generator`;
`initialize_two_view` is deterministic given the draws, so tests hand both
packages the JAX draws. The SVDs are `torch.linalg.svd`. Their singular
vectors may come with other signs than LAPACK's in JAX; F and H are
defined up to sign, the scores do not change, and the decompositions
normalize the determinant signs, so the candidate sets are the same (in
another order, and a success has a unique best candidate).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from eao_fusion_tpu_torch.ops import lie
from eao_fusion_tpu_torch.solvers.triangulation import triangulate_dlt


def draw_two_view_hypotheses(valid: torch.Tensor, generator: torch.Generator,
                             n_hypotheses: int = 200
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([n_hypotheses, 8] F indices, [n_hypotheses, 4] H indices), drawn
    with replacement, each row weighted by `valid` (`jax.random.choice(p=
    valid / Σ valid)` in the JAX function)."""
    idx = torch.multinomial(valid.float(), n_hypotheses * 12,
                            replacement=True, generator=generator)
    return (idx[:n_hypotheses * 8].reshape(n_hypotheses, 8),
            idx[n_hypotheses * 8:].reshape(n_hypotheses, 4))


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    w = valid.float()[:, None]
    n = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(pts * w, 0) / n
    d = torch.sum(torch.abs(pts - mean) * w, 0) / n
    s = 1.0 / torch.clamp(d, min=1e-9)
    T = torch.eye(3, dtype=pts.dtype, device=pts.device)
    T[0, 0], T[1, 1] = s[0], s[1]
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return (pts - mean) * s, T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """[..., 9] right singular vector of the smallest singular value."""
    return torch.linalg.svd(A)[2][..., -1, :]


def _dlt_f(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point fundamental from [..., 8, 2] normalized pairs, rank 2."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    F = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    U, D, Vt = torch.linalg.svd(F)
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], dim=-1)
    return (U * D[..., None, :]) @ Vt


def _dlt_h(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """4-point homography from [..., 4, 2] pairs."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    A = torch.stack([r1, r2], dim=-2).reshape(x.shape[:-1] + (8, 9))
    return _null_vector(A).reshape(A.shape[:-2] + (3, 3))


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _score_f(F, p1, p2, valid, sigma2: float = 1.0, th: float = 3.841,
             th_score: float = 5.991):
    """Symmetric epipolar-distance score (`Initializer::CheckFundamental`);
    F [..., 3, 3], points [N, 2]. Returns (score [...], inliers [..., N])."""
    h1, h2 = _homog(p1), _homog(p2)
    l2 = h1 @ F.transpose(-1, -2)           # epipolar lines in image 2
    l1 = h2 @ F                             # epipolar lines in image 1
    d2 = torch.sum(h2 * l2, -1) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) / sigma2
    d1 = torch.sum(h1 * l1, -1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) / sigma2
    inl = (d1 < th) & (d2 < th) & valid
    score = torch.sum(torch.where(valid & (d1 < th), th_score - d1, 0.0)
                      + torch.where(valid & (d2 < th), th_score - d2, 0.0),
                      dim=-1)
    return score, inl


def _dehomog(p: torch.Tensor) -> torch.Tensor:
    w = p[..., 2:]
    return p[..., :2] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)


def _score_h(H, p1, p2, valid, sigma2: float = 1.0, th: float = 5.991):
    """Symmetric transfer-error score (`Initializer::CheckHomography`)."""
    Hinv = torch.linalg.inv_ex(H)[0]
    p12 = _dehomog(_homog(p1) @ H.transpose(-1, -2))
    p21 = _dehomog(_homog(p2) @ Hinv.transpose(-1, -2))
    d2 = torch.sum((p2 - p12) ** 2, -1) / sigma2
    d1 = torch.sum((p1 - p21) ** 2, -1) / sigma2
    inl = (d1 < th) & (d2 < th) & valid
    score = torch.sum(torch.where(valid & (d1 < th), th - d1, 0.0)
                      + torch.where(valid & (d2 < th), th - d2, 0.0), dim=-1)
    return score, inl


def _decompose_e(E: torch.Tensor):
    """4 (R, t) candidates from an essential matrix."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    Wm = E.new_tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ Wm @ Vt
    R2 = U @ Wm.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H: torch.Tensor):
    """8 (R, t) candidates (Faugeras SVD method, `Initializer::ReconstructH`
    `src/Initializer.cc:580-770`)."""
    U, D, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = D[0], D[1], D[2]
    aux1 = torch.sqrt(torch.clamp(
        (d1 * d1 - d2 * d2) / torch.clamp(d1 * d1 - d3 * d3, min=1e-12),
        min=0.0))
    aux3 = torch.sqrt(torch.clamp(
        (d2 * d2 - d3 * d3) / torch.clamp(d1 * d1 - d3 * d3, min=1e-12),
        min=0.0))
    x1s = H.new_tensor([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = H.new_tensor([1.0, -1.0, 1.0, -1.0]) * aux3
    zero = torch.zeros_like(aux1)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    # (sin, cos, Rp[1, 1], sign of Rp[0, 2], t scale, sign of t's x3):
    # d' = d2, then d' = -d2
    cases = ((root / torch.clamp((d1 + d3) * d2, min=1e-12),
              (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12),
              1.0, -1.0, d1 - d3, -1.0),
             (root / torch.clamp((d1 - d3) * d2, min=1e-12),
              (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12),
              -1.0, 1.0, d1 + d3, 1.0))
    Rs, ts = [], []
    for sn, cs, mid, sgn02, tscale, sgn_x3 in cases:
        for i in range(4):
            eps = torch.sign(x1s[i] * x3s[i] + 1e-20)
            Rp = torch.stack([
                torch.stack([cs, zero, sgn02 * eps * sn]),
                torch.stack([zero, zero + mid, zero]),
                torch.stack([eps * sn, zero, cs])])
            tp = tscale * torch.stack([x1s[i], zero, sgn_x3 * x3s[i]])
            Rs.append(s * U @ Rp @ Vt)
            ts.append(U @ tp)
    ts = [t / torch.clamp(torch.linalg.norm(t), min=1e-12) for t in ts]
    return torch.stack(Rs), torch.stack(ts)


class TwoViewResult(NamedTuple):
    success: torch.Tensor     # [] bool
    tcw2: torch.Tensor        # [7] pose of frame 2 (frame 1 = identity)
    xyz: torch.Tensor         # [N, 3] triangulated points
    ok: torch.Tensor          # [N] triangulation validity
    used_h: torch.Tensor      # [] bool (model selection diagnostic)


def initialize_two_view(uv1: torch.Tensor, uv2: torch.Tensor,
                        valid: torch.Tensor, idx_f: torch.Tensor,
                        idx_h: torch.Tensor, *,
                        cam: Tuple[float, float, float, float]
                        ) -> TwoViewResult:
    """uv1, uv2: [N, 2] matched pixels; idx_f [n_hyp, 8], idx_h [n_hyp, 4]
    the hypotheses' rows (`draw_two_view_hypotheses`). Frame 1's camera is
    the identity."""
    fx, fy, cx, cy = cam
    dev = uv1.device
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                     device=dev)
    n1, T1 = _normalize(uv1, valid)
    n2, T2 = _normalize(uv2, valid)
    idx_f, idx_h = idx_f.long(), idx_h.long()

    Fs = T2.T @ _dlt_f(n1[idx_f], n2[idx_f]) @ T1              # [H, 3, 3]
    sf, _ = _score_f(Fs, uv1, uv2, valid)
    Hs = torch.linalg.inv(T2) @ _dlt_h(n1[idx_h], n2[idx_h]) @ T1
    sh, _ = _score_h(Hs, uv1, uv2, valid)
    # argmax takes the first of tied hypotheses, as jnp.argmax does
    bf = torch.argmax(sf)
    bh = torch.argmax(sh)
    F, H = Fs[bf], Hs[bh]
    SF, SH = sf[bf], sh[bh]
    _, inl_f = _score_f(F, uv1, uv2, valid)
    _, inl_h = _score_h(H, uv1, uv2, valid)
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40

    # candidate motions from both decompositions; all 12 evaluated
    Rf, tf = _decompose_e(K.T @ F @ K)
    Rh, th = _decompose_h(torch.linalg.inv(K) @ H @ K)
    Rall = torch.cat([Rf, Rh])
    tall = torch.cat([tf, th])
    from_h = torch.arange(12, device=dev) >= 4
    inl = torch.where(use_h, inl_h, inl_f)

    tcw2s = lie.se3_from_Rt(Rall, tall)                         # [12, 7]
    xn1 = torch.stack([(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy], -1)
    xn2 = torch.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], -1)
    xw = triangulate_dlt(lie.se3_identity(device=dev), tcw2s, xn1, xn2)
    xc2 = lie.se3_apply(tcw2s[:, None, :], xw)                  # [12, N, 3]
    e1 = lie.project(cam, xw) - uv1
    e2 = lie.project(cam, xc2) - uv2
    goods = (inl & (xw[..., 2] > 0.0) & (xc2[..., 2] > 0.0)
             & (torch.sum(e1 * e1, -1) < 16.0)
             & (torch.sum(e2 * e2, -1) < 16.0)
             & torch.all(torch.isfinite(xw), dim=-1))
    counts = goods.sum(dim=-1)
    counts = torch.where(from_h == use_h, counts, -1)
    best = torch.argmax(counts)
    n_good = counts[best]
    n_inl = inl.sum()
    # acceptance: enough triangulations and a clear winner (the reference
    # asks nGood > 0.9 * inliers and at least 50)
    second = torch.max(torch.where(torch.arange(12, device=dev) == best, -1,
                                   counts))
    success = ((n_good >= 50) & (n_good.float() > 0.75 * n_inl.float())
               & (second.float() < 0.9 * n_good.float()))
    return TwoViewResult(success=success, tcw2=tcw2s[best], xyz=xw[best],
                         ok=goods[best], used_h=use_h)
