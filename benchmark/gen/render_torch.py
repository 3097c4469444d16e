"""The stream's ray cast in torch, for the card: the same arithmetic as
`synthetic.render_frame` (term by term, in the same order), over a batch
of frames at once. Frames stay on the device; nothing is written to
disk."""

from __future__ import annotations

import numpy as np
import torch

from . import synthetic as syn


def _dot3(a: torch.Tensor, b) -> torch.Tensor:
    return a[..., 0] * b[0] + a[..., 1] * b[1] + a[..., 2] * b[2]


def scene_textures(scene: syn.Scene, device) -> torch.Tensor:
    """[T, S, S] float32 on `device`, made on the host."""
    return torch.as_tensor(np.stack(scene.textures), device=device)


def render(scene: syn.Scene, textures: torch.Tensor, cam: syn.Camera,
           tcws: np.ndarray, batch: int = 16):
    """(gray [F, H, W], depth [F, H, W]) float32 on the textures' device
    for the F poses `tcws` [F, 7]."""
    dev = textures.device
    F, H, W = len(tcws), cam.height, cam.width
    gray_out = torch.empty((F, H, W), dtype=torch.float32, device=dev)
    depth_out = torch.empty((F, H, W), dtype=torch.float32, device=dev)
    dirs_np = syn.ray_dirs(cam)
    dirs = torch.as_tensor(dirs_np, device=dev)
    rects = [(r, *syn.rect_constants(r)) for r in scene.rects]
    S = textures.shape[1]
    for f0 in range(0, F, batch):
        rays = [syn.world_rays(cam, t) for t in tcws[f0:f0 + batch]]
        o = torch.as_tensor(np.stack([r[0] for r in rays]), device=dev)
        R = np.stack([r[1] for r in rays])                  # [B, 3, 3]
        Rt = torch.as_tensor(R, device=dev)
        # d[b, n, k] = dirs[n] · R[b, k]
        d = torch.stack([dirs[None, :, 0] * Rt[:, k, 0, None]
                         + dirs[None, :, 1] * Rt[:, k, 1, None]
                         + dirs[None, :, 2] * Rt[:, k, 2, None]
                         for k in range(3)], dim=-1)         # [B, N, 3]
        B, N = d.shape[:2]
        best_t = torch.full((B, N), float("inf"), device=dev)
        best_uv = torch.zeros((B, N, 2), device=dev)
        best_tex = torch.full((B, N), -1, dtype=torch.int32, device=dev)
        for rect, nrm, lu2, lv2 in rects:
            nrm = [float(x) for x in nrm]
            denom = _dot3(d, nrm)
            denom = torch.where(denom.abs() < 1e-9,
                                torch.tensor(1e-9, device=dev), denom)
            org = torch.as_tensor(rect.origin, device=dev)
            t = _dot3(org[None] - o, nrm)[:, None] / denom
            rel = (o[:, None, :] + t[..., None] * d) - org
            u = _dot3(rel, [float(x) for x in rect.eu]) / float(lu2)
            vq = _dot3(rel, [float(x) for x in rect.ev]) / float(lv2)
            ok = ((t > 0.05) & (u >= 0) & (u <= 1) & (vq >= 0) & (vq <= 1)
                  & (t < best_t))
            best_t = torch.where(ok, t, best_t)
            best_uv = torch.where(ok[..., None], torch.stack([u, vq], -1),
                                  best_uv)
            best_tex = torch.where(ok, rect.tex_id, best_tex)
        inv = 1.0 / torch.where(d.abs() < 1e-9,
                                torch.tensor(1e-9, device=dev), d)
        for box in scene.boxes:
            lo = torch.as_tensor(box.lo, device=dev)
            ext = torch.as_tensor(np.maximum(box.hi - box.lo,
                                             np.float32(1e-9)), device=dev)
            t0 = (lo - o)[:, None, :] * inv
            t1 = (torch.as_tensor(box.hi, device=dev) - o)[:, None, :] * inv
            tlo = torch.minimum(t0, t1)
            tmin = tlo.max(dim=-1).values
            tmax = torch.maximum(t0, t1).min(dim=-1).values
            ok = (tmax > tmin) & (tmin > 0.05) & (tmin < best_t)
            rel = ((o[:, None, :] + tmin[..., None] * d) - lo) / ext
            axis = torch.argmax(tlo, dim=-1)[..., None]
            uv = torch.where(axis == 0, rel[..., [1, 2]],
                             torch.where(axis == 1, rel[..., [0, 2]],
                                         rel[..., [0, 1]]))
            best_t = torch.where(ok, tmin, best_t)
            best_uv = torch.where(ok[..., None], uv, best_uv)
            best_tex = torch.where(ok, box.tex_id, best_tex)
        ti = torch.clamp((best_uv * float(S - 1)).to(torch.int32), 0, S - 1)
        gray = torch.where(
            best_tex >= 0,
            textures[best_tex.clamp(min=0).long(), ti[..., 1].long(),
                     ti[..., 0].long()], 0.0)
        z = torch.where(torch.isfinite(best_t), best_t * dirs[None, :, 2],
                        0.0)
        gray_out[f0:f0 + B] = gray.reshape(B, H, W)
        depth_out[f0:f0 + B] = z.reshape(B, H, W)
    return gray_out, depth_out
