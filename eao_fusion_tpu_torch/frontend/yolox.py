"""YOLOX object detector, the serving half (port of
`eao_fusion_tpu/frontend/yolox.py`).

The same YOLOX-s graph (CSPDarknet backbone, PAFPN neck, decoupled
anchor-free head, strides {8, 16, 32}) and the same pre/post processing as
the reference's TensorRT thread (`src/YOLOX.cc`): 640x640 letterbox
(`StaticResize` :51), grid decode (`GenerateYoloxProposals` :64-209),
score filter and class-agnostic greedy NMS at 0.65 (:131-163), with a fixed
top-k candidate set instead of dynamic lists.

Layout: NCHW activations and OIHW weights, as plain functions on a nested
parameter dict (the JAX package's tree with the same keys).
`params_from_numpy` turns the JAX package's HWIO numpy tree (the npz layout
of its `save_params`) into this one; `load_params` reads such an npz. The
convolutions are `torch.nn.functional.conv2d`: the JAX package computes
them with `lax.conv_general_dilated`, outside any Pallas kernel.

The reference's thread protocol (latest-wins image/result queues,
`src/YOLOX.cc:412-461`) maps to a side CUDA stream: `Detector.submit`
enqueues letterbox, forward and decode there and returns; `Detector.result`
waits for that stream and copies the detections to the host, so feature
extraction on the main stream overlaps detection.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eao_fusion_tpu_torch import DeviceLike, resolve_device
from eao_fusion_tpu_torch.ops.topk import top_k_stable

INPUT_SIZE = 640
STRIDES = (8, 16, 32)
NMS_THRESHOLD = 0.65
CONF_THRESHOLD = 0.3
MAX_DETECTIONS = 32
NMS_CANDIDATES = 128

Params = Dict


# ------------------------------------------------------------------ layers

def _conv(p, x, stride=1):
    """'BaseConv': conv + BN (folded) + SiLU."""
    y = _conv_linear(p, x, stride)
    return y * torch.sigmoid(y)


def _conv_linear(p, x, stride=1):
    w = p["w"]                                   # [cout, cin, kh, kw]
    return F.conv2d(x, w, p["b"], stride=stride,
                    padding=(w.shape[-1] - 1) // 2)


def _bottleneck(p, x, shortcut=True):
    y = _conv(p["c2"], _conv(p["c1"], x))
    return x + y if shortcut else y


def _csp(p, x, n, shortcut=True):
    a = _conv(p["c1"], x)
    b = _conv(p["c2"], x)
    for i in range(n):
        a = _bottleneck(p[f"m{i}"], a, shortcut)
    return _conv(p["c3"], torch.cat([a, b], dim=1))


def _focus(p, x):
    """Space-to-depth stem (channel order tl, bl, tr, br)."""
    return _conv(p["conv"], torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2],
                                       x[:, :, ::2, 1::2],
                                       x[:, :, 1::2, 1::2]], dim=1))


def _sppf(p, x):
    a = _conv(p["c1"], x)
    # SAME max pools with a -inf pad
    pools = [F.max_pool2d(a, k, stride=1, padding=k // 2) for k in (5, 9, 13)]
    return _conv(p["c2"], torch.cat([a] + pools, dim=1))


def _upsample(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


# --------------------------------------------------------------- the model

def yolox_forward(params: Params, img: torch.Tensor, depth_mult: int = 1
                  ) -> torch.Tensor:
    """img: [1, 3, 640, 640] normalized. Returns the raw head outputs as
    [n_anchors, 5 + n_classes] (pre-decode), anchors in the JAX package's
    order (stride 8, 16, 32; row-major within each)."""
    n = depth_mult
    # backbone (CSPDarknet)
    x = _focus(params["stem"], img)                       # /2
    x = _conv(params["dark2_down"], x, 2)                 # /4
    x = _csp(params["dark2_csp"], x, n)
    x = _conv(params["dark3_down"], x, 2)                 # /8
    c3 = _csp(params["dark3_csp"], x, 3 * n)
    x = _conv(params["dark4_down"], c3, 2)                # /16
    c4 = _csp(params["dark4_csp"], x, 3 * n)
    x = _conv(params["dark5_down"], c4, 2)                # /32
    x = _sppf(params["sppf"], x)
    c5 = _csp(params["dark5_csp"], x, n, shortcut=False)

    # PAFPN
    lat5 = _conv(params["lateral5"], c5)
    f4 = _csp(params["fpn4"], torch.cat([_upsample(lat5), c4], 1), n,
              shortcut=False)
    lat4 = _conv(params["lateral4"], f4)
    f3 = _csp(params["fpn3"], torch.cat([_upsample(lat4), c3], 1), n,
              shortcut=False)                             # /8 out
    d3 = _conv(params["down3"], f3, 2)
    p4 = _csp(params["pan4"], torch.cat([d3, lat4], 1), n,
              shortcut=False)                             # /16 out
    d4 = _conv(params["down4"], p4, 2)
    p5 = _csp(params["pan5"], torch.cat([d4, lat5], 1), n,
              shortcut=False)                             # /32 out

    outs = []
    for name, feat in (("head8", f3), ("head16", p4), ("head32", p5)):
        hp = params[name]
        s = _conv(hp["stem"], feat)
        cls_out = _conv_linear(hp["cls_pred"], _conv(hp["cls2"],
                                                     _conv(hp["cls1"], s)))
        reg = _conv(hp["reg2"], _conv(hp["reg1"], s))
        o = torch.cat([_conv_linear(hp["reg_pred"], reg),
                       _conv_linear(hp["obj_pred"], reg), cls_out], dim=1)
        outs.append(o[0].permute(1, 2, 0).reshape(-1, o.shape[1]))
    return torch.cat(outs, dim=0)


def forward_flops(params: Params, depth_mult: int = 1,
                  size: int = INPUT_SIZE) -> int:
    """Multiply-adds x 2 of `yolox_forward` at a size x size input, from
    the layer shapes (the convolutions; activations and pools left out)."""
    total = 0

    def conv(p, hw, stride=1):
        nonlocal total
        co, ci, kh, kw = p["w"].shape
        out = hw // stride
        total += 2 * co * ci * kh * kw * out * out
        return out

    def csp(p, hw, n):
        for k in ("c1", "c2", "c3"):
            conv(p[k], hw)
        for i in range(n):
            conv(p[f"m{i}"]["c1"], hw)
            conv(p[f"m{i}"]["c2"], hw)

    n = depth_mult
    hw = conv(params["stem"]["conv"], size // 2)
    hw = conv(params["dark2_down"], hw, 2)
    csp(params["dark2_csp"], hw, n)
    hw8 = conv(params["dark3_down"], hw, 2)
    csp(params["dark3_csp"], hw8, 3 * n)
    hw16 = conv(params["dark4_down"], hw8, 2)
    csp(params["dark4_csp"], hw16, 3 * n)
    hw32 = conv(params["dark5_down"], hw16, 2)
    conv(params["sppf"]["c1"], hw32)
    conv(params["sppf"]["c2"], hw32)
    csp(params["dark5_csp"], hw32, n)
    conv(params["lateral5"], hw32)
    csp(params["fpn4"], hw16, n)
    conv(params["lateral4"], hw16)
    csp(params["fpn3"], hw8, n)
    conv(params["down3"], hw8, 2)
    csp(params["pan4"], hw16, n)
    conv(params["down4"], hw16, 2)
    csp(params["pan5"], hw32, n)
    for name, h in (("head8", hw8), ("head16", hw16), ("head32", hw32)):
        for k in ("stem", "cls1", "cls2", "cls_pred", "reg1", "reg2",
                  "reg_pred", "obj_pred"):
            conv(params[name][k], h)
    return total


# -------------------------------------------------------------- decode/NMS

def _grids(input_size: int = INPUT_SIZE):
    gs, ss = [], []
    for s in STRIDES:
        n = input_size // s
        gy, gx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        gs.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        ss.append(np.full((n * n,), s))
    return (np.concatenate(gs).astype(np.float32),
            np.concatenate(ss).astype(np.float32))


_GRID, _STRIDE = _grids()


@functools.lru_cache(maxsize=None)
def _grid_on(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The anchor grid and strides on `device`, copied there once."""
    return (torch.as_tensor(_GRID, device=device),
            torch.as_tensor(_STRIDE, device=device))


def decode_and_nms(raw: torch.Tensor, scale, n_classes: int = 80
                   ) -> torch.Tensor:
    """raw [A, 5+n_classes] -> detections [MAX_DETECTIONS, 6]
    (class, x, y, w, h, score) in original-image pixels; empty rows have
    score 0. Anchor-free decode (`GenerateYoloxProposals`) and
    CLASS-AGNOSTIC greedy NMS over the top-128 candidates, as the
    reference's NmsSortedBboxes (`src/YOLOX.cc:131-163`) compares boxes
    regardless of label. The NMS is 128 dependent steps of small device
    ops; it is exact, not fast."""
    dev = raw.device
    grid, stride = _grid_on(dev)
    cx = (raw[:, 0] + grid[:, 0]) * stride
    cy = (raw[:, 1] + grid[:, 1]) * stride
    w = torch.exp(raw[:, 2]) * stride
    h = torch.exp(raw[:, 3]) * stride
    score = torch.sigmoid(raw[:, 4])[:, None] * torch.sigmoid(
        raw[:, 5:5 + n_classes])
    best_score, best_cls = torch.max(score, dim=1)

    K = NMS_CANDIDATES
    top_s, top_i = top_k_stable(best_score, K)
    x0 = (cx - w / 2)[top_i] / scale
    y0 = (cy - h / 2)[top_i] / scale
    bw = w[top_i] / scale
    bh = h[top_i] / scale
    bc = best_cls[top_i]
    x1, y1 = x0 + bw, y0 + bh

    ix0 = torch.maximum(x0[:, None], x0[None, :])
    iy0 = torch.maximum(y0[:, None], y0[None, :])
    ix1 = torch.minimum(x1[:, None], x1[None, :])
    iy1 = torch.minimum(y1[:, None], y1[None, :])
    inter = torch.clamp(ix1 - ix0, min=0) * torch.clamp(iy1 - iy0, min=0)
    area = torch.clamp(bw, min=0) * torch.clamp(bh, min=0)
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter,
                              min=1e-9)
    # greedy NMS over the K candidates (already score-sorted): candidate i,
    # if kept, suppresses every later candidate it overlaps
    later = torch.triu(torch.ones((K, K), dtype=torch.bool, device=dev), 1)
    over = (iou > NMS_THRESHOLD) & later
    keep = top_s > CONF_THRESHOLD
    for i in range(K):
        keep = keep & ~(over[i] & keep[i])
    order = torch.argsort((~keep).to(torch.int8), stable=True)  # kept first
    sel = order[:MAX_DETECTIONS]
    return torch.stack([bc[sel].to(torch.float32), x0[sel], y0[sel],
                        bw[sel], bh[sel],
                        torch.where(keep[sel], top_s[sel], 0.0)], dim=-1)


# ------------------------------------------------------------ preprocessing

def letterbox(img_rgb: torch.Tensor, size: int = INPUT_SIZE
              ) -> Tuple[torch.Tensor, float]:
    """[H, W, 3] float [0,1] -> ([1, 3, size, size], scale). Gray padding
    as the reference's `StaticResize` (`src/YOLOX.cc:51`); the bilinear
    resize antialiases when it shrinks, as `jax.image.resize` does."""
    h, w, _ = img_rgb.shape
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = img_rgb.permute(2, 0, 1)[None]
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                          align_corners=False, antialias=True)
    canvas = torch.full((1, 3, size, size), 114.0 / 255.0,
                        dtype=img_rgb.dtype, device=img_rgb.device)
    canvas[:, :, :nh, :nw] = x
    return canvas, scale


# ---------------------------------------------------------------- detector

class Detector:
    """Async detection lane with the reference's latest-wins semantics, on
    the device of its parameters."""

    def __init__(self, params: Params, depth_mult: int = 1,
                 n_classes: int = 80):
        self.params = params
        self.n_classes = n_classes
        self.depth_mult = depth_mult
        self.device = params["stem"]["conv"]["w"].device
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._pending = None

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        img, scale = letterbox(x)
        raw = yolox_forward(self.params, img, self.depth_mult)
        return decode_and_nms(raw, scale, n_classes=self.n_classes)

    def submit(self, img_rgb: np.ndarray) -> None:
        """Enqueue detection of an [H, W, 3] image in [0, 1] and return
        (InsertImage, `src/YOLOX.cc:457`); a later submit replaces an
        unread one. On the CPU it runs at once."""
        x = torch.as_tensor(np.asarray(img_rgb, np.float32),
                            device=self.device)
        if self._stream is None:
            self._pending = (self._run(x), x)
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            det = self._run(x)
        # the input stays referenced until the result is read
        self._pending = (det, x)

    def result(self) -> Optional[np.ndarray]:
        """The latest submitted frame's detections with score > 0, [B, 6]
        on the host, or None if nothing is pending (GetResult,
        `src/YOLOX.cc:412`)."""
        if self._pending is None:
            return None
        det, _ = self._pending
        self._pending = None
        if self._stream is not None:
            self._stream.synchronize()
        det = det.cpu().numpy()
        return det[det[:, 5] > 0]


# ------------------------------------------------------------------ weights

def params_from_numpy(tree: Dict, device: DeviceLike = None) -> Params:
    """The JAX package's parameter tree (nested dicts of numpy arrays, conv
    weights HWIO, as its `save_params` writes them) as this module's tree:
    float32 tensors, conv weights OIHW, on `device` (`cuda` unless named)."""
    device = resolve_device(device)
    out: Params = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device)
            continue
        a = np.array(v, np.float32)                      # a writable copy
        if a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        out[k] = torch.from_numpy(a).to(device)
    return out


def load_params(path: str, device: DeviceLike = None) -> Params:
    """An npz of the JAX package's `save_params` (keys "a.b.w"), as this
    module's tree on `device` (`cuda` unless named)."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split(".")
            d = tree
            for part in parts[:-1]:
                d = d.setdefault(part, {})
            d[parts[-1]] = z[key]
    return params_from_numpy(tree, device)


def infer_arch(params: Params) -> Tuple[int, int]:
    """(depth_mult, n_classes) from a loaded tree."""
    n_classes = int(params["head8"]["cls_pred"]["w"].shape[0])
    n_m = len([k for k in params["dark3_csp"] if k.startswith("m")])
    return max(n_m // 3, 1), n_classes
