"""YOLOX object detector (port of `eao_fusion_tpu/frontend/yolox.py`): the
graph, pre / post processing, the serving lane, and the weights (random
init, the npz layout, the importer of the official checkpoint).

The same YOLOX-s graph (CSPDarknet backbone, PAFPN neck, decoupled
anchor-free head, strides {8, 16, 32}) and the same pre/post processing as
the reference's TensorRT thread (`src/YOLOX.cc`): 640x640 letterbox
(`StaticResize` :51), grid decode (`GenerateYoloxProposals` :64-209),
score filter and class-agnostic greedy NMS at 0.65 (:131-163), with a fixed
top-k candidate set instead of dynamic lists.

Layout: NCHW activations and OIHW weights, as plain functions on a nested
parameter dict (the JAX package's tree with the same keys).
`params_from_numpy` turns the JAX package's HWIO numpy tree (the npz layout
of its `save_params`) into this one and `params_to_numpy` back;
`load_params` / `save_params` read and write such an npz. The
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
    return yolox_forward_batch(params, img, depth_mult)[0]


def yolox_forward_batch(params: Params, img: torch.Tensor,
                        depth_mult: int = 1) -> torch.Tensor:
    """`yolox_forward` over a batch: img [B, 3, 640, 640] -> raw head
    outputs [B, n_anchors, 5 + n_classes]."""
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
        outs.append(o.permute(0, 2, 3, 1).reshape(o.shape[0], -1,
                                                  o.shape[1]))
    return torch.cat(outs, dim=1)


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

def init_params(generator: torch.Generator, depth_mult: int = 1,
                width_mult: float = 0.5, n_classes: int = 80,
                device: DeviceLike = None) -> Params:
    """Random init with YOLOX-s dimensions (width 0.5, depth 0.33 -> n = 1)
    on `device` (`cuda` unless named): each conv weight N(0, 1 /
    (cin k k)), drawn from `generator` on its own device, biases zero. The
    JAX package draws from `jax.random`, whose bits no torch generator
    gives: a test carries its parameters across with `params_from_numpy`."""
    device = resolve_device(device)
    wb = int(64 * width_mult)

    def conv(cin, cout, k=3):
        w = torch.randn((cout, cin, k, k), generator=generator,
                        device=generator.device) / float(np.sqrt(cin * k * k))
        return {"w": w.to(device),
                "b": torch.zeros(cout, device=device)}

    def csp(cin, cout, n, expand=0.5):
        hid = int(cout * expand)
        d = {"c1": conv(cin, hid, 1), "c2": conv(cin, hid, 1),
             "c3": conv(2 * hid, cout, 1)}
        for i in range(n):
            d[f"m{i}"] = {"c1": conv(hid, hid, 1), "c2": conv(hid, hid, 3)}
        return d

    n = depth_mult
    p: Params = {}
    p["stem"] = {"conv": conv(12, wb, 3)}
    p["dark2_down"] = conv(wb, 2 * wb, 3)
    p["dark2_csp"] = csp(2 * wb, 2 * wb, n)
    p["dark3_down"] = conv(2 * wb, 4 * wb, 3)
    p["dark3_csp"] = csp(4 * wb, 4 * wb, 3 * n)
    p["dark4_down"] = conv(4 * wb, 8 * wb, 3)
    p["dark4_csp"] = csp(8 * wb, 8 * wb, 3 * n)
    p["dark5_down"] = conv(8 * wb, 16 * wb, 3)
    p["sppf"] = {"c1": conv(16 * wb, 8 * wb, 1),
                 "c2": conv(32 * wb, 16 * wb, 1)}
    p["dark5_csp"] = csp(16 * wb, 16 * wb, n)

    p["lateral5"] = conv(16 * wb, 8 * wb, 1)
    p["fpn4"] = csp(16 * wb, 8 * wb, n)
    p["lateral4"] = conv(8 * wb, 4 * wb, 1)
    p["fpn3"] = csp(8 * wb, 4 * wb, n)
    p["down3"] = conv(4 * wb, 4 * wb, 3)
    p["pan4"] = csp(8 * wb, 8 * wb, n)
    p["down4"] = conv(8 * wb, 8 * wb, 3)
    p["pan5"] = csp(16 * wb, 16 * wb, n)

    for name, cin in (("head8", 4 * wb), ("head16", 8 * wb),
                      ("head32", 16 * wb)):
        p[name] = {
            "stem": conv(cin, 4 * wb, 1),
            "cls1": conv(4 * wb, 4 * wb, 3),
            "cls2": conv(4 * wb, 4 * wb, 3),
            "cls_pred": conv(4 * wb, n_classes, 1),
            "reg1": conv(4 * wb, 4 * wb, 3),
            "reg2": conv(4 * wb, 4 * wb, 3),
            "reg_pred": conv(4 * wb, 4, 1),
            "obj_pred": conv(4 * wb, 1, 1),
        }
    return p


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


def params_to_numpy(params: Params) -> Dict:
    """The inverse of `params_from_numpy`: nested dicts of float32 numpy
    arrays on the host, conv weights HWIO."""
    out: Dict = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = params_to_numpy(v)
            continue
        a = v.detach().cpu().numpy()
        out[k] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return out


def save_params(path: str, params: Params, dtype=None) -> None:
    """Write the JAX package's npz layout (keys "a.b.w", HWIO).
    `dtype=np.float16` halves the file; the weights are cast back to
    float32 on load."""
    flat = {}

    def rec(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                rec(f"{prefix}{k}.", v)
            else:
                flat[f"{prefix}{k}"] = v.astype(dtype) if dtype else v
    rec("", params_to_numpy(params))
    np.savez_compressed(path, **flat)


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


# ------------------------------------------------- torch checkpoint import

# this module's name -> module path in the official YOLOX layout (Megvii
# YOLOX: YOLOX = {backbone: YOLOPAFPN{backbone: CSPDarknet, ...}, head:
# YOLOXHead}; the reference serializes this graph into its TensorRT engine,
# `src/YOLOX.cc:7-41`)
_TORCH_MAP = {
    "stem.conv": "backbone.backbone.stem.conv",
    "dark2_down": "backbone.backbone.dark2.0",
    "dark2_csp": "backbone.backbone.dark2.1",
    "dark3_down": "backbone.backbone.dark3.0",
    "dark3_csp": "backbone.backbone.dark3.1",
    "dark4_down": "backbone.backbone.dark4.0",
    "dark4_csp": "backbone.backbone.dark4.1",
    "dark5_down": "backbone.backbone.dark5.0",
    "sppf.c1": "backbone.backbone.dark5.1.conv1",
    "sppf.c2": "backbone.backbone.dark5.1.conv2",
    "dark5_csp": "backbone.backbone.dark5.2",
    "lateral5": "backbone.lateral_conv0",
    "fpn4": "backbone.C3_p4",
    "lateral4": "backbone.reduce_conv1",
    "fpn3": "backbone.C3_p3",
    "down3": "backbone.bu_conv2",
    "pan4": "backbone.C3_n3",
    "down4": "backbone.bu_conv1",
    "pan5": "backbone.C3_n4",
}
for _i, _h in enumerate(("head8", "head16", "head32")):
    _TORCH_MAP.update({
        f"{_h}.stem": f"head.stems.{_i}",
        f"{_h}.cls1": f"head.cls_convs.{_i}.0",
        f"{_h}.cls2": f"head.cls_convs.{_i}.1",
        f"{_h}.cls_pred": f"head.cls_preds.{_i}",
        f"{_h}.reg1": f"head.reg_convs.{_i}.0",
        f"{_h}.reg2": f"head.reg_convs.{_i}.1",
        f"{_h}.reg_pred": f"head.reg_preds.{_i}",
        f"{_h}.obj_pred": f"head.obj_preds.{_i}",
    })
_CSP = ("dark2_csp", "dark3_csp", "dark4_csp", "dark5_csp", "fpn3", "fpn4",
        "pan4", "pan5")
_CSP_SUB = {"c1": "conv1", "c2": "conv2", "c3": "conv3"}
_PLAIN_CONVS = ("cls_pred", "reg_pred", "obj_pred")  # bias, no BN
_BN_EPS = 1e-3   # YOLOX builds BatchNorm2d(eps=0.001, momentum=0.03)


def fold_conv_bn(w_oihw: np.ndarray, gamma, beta, mean, var,
                 eps: float = _BN_EPS) -> Tuple[np.ndarray, np.ndarray]:
    """Fold BatchNorm into the conv before it: y = BN(conv(x)) becomes one
    conv with w' = w gamma / sqrt(var + eps) per output channel and b' =
    beta - mean gamma / sqrt(var + eps). Returns (w' OIHW, b') as
    float32."""
    scale = gamma / np.sqrt(var + eps)
    w = w_oihw * scale[:, None, None, None]
    b = beta - mean * scale
    return w.astype(np.float32), b.astype(np.float32)


def convert_torch_state_dict(sd: Dict, n_classes: int = 80) -> Params:
    """An official YOLOX state dict (torch tensors or numpy arrays) as this
    module's tree of float32 CPU tensors (OIHW), every BatchNorm folded
    into its conv. `n_classes` is read from the class heads' shapes; the
    argument mirrors the JAX function's."""
    def arr(key):
        v = sd[key]
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))

    def base_conv(tpath):
        return fold_conv_bn(arr(f"{tpath}.conv.weight"),
                            arr(f"{tpath}.bn.weight"),
                            arr(f"{tpath}.bn.bias"),
                            arr(f"{tpath}.bn.running_mean"),
                            arr(f"{tpath}.bn.running_var"))

    def plain_conv(tpath):
        return (arr(f"{tpath}.weight").astype(np.float32),
                arr(f"{tpath}.bias").astype(np.float32))

    # strip a DataParallel "module." prefix
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}

    params: Params = {}

    def put(ours, w, b):
        parts = ours.split(".")
        d = params
        for part in parts[:-1]:
            d = d.setdefault(part, {})
        d[parts[-1]] = {"w": torch.from_numpy(np.ascontiguousarray(w)),
                        "b": torch.from_numpy(np.ascontiguousarray(b))}

    for ours, tpath in _TORCH_MAP.items():
        if ours in _CSP:
            for sub, tsub in _CSP_SUB.items():
                put(f"{ours}.{sub}", *base_conv(f"{tpath}.{tsub}"))
            i = 0
            while f"{tpath}.m.{i}.conv1.conv.weight" in sd:
                put(f"{ours}.m{i}.c1", *base_conv(f"{tpath}.m.{i}.conv1"))
                put(f"{ours}.m{i}.c2", *base_conv(f"{tpath}.m.{i}.conv2"))
                i += 1
        elif ours.split(".")[-1] in _PLAIN_CONVS:
            put(ours, *plain_conv(tpath))
        else:
            put(ours, *base_conv(tpath))
    return params


def convert_torch_checkpoint(pth_path: str, out_path: str) -> None:
    """Convert an official YOLOX checkpoint (e.g. yolox_s.pth: a dict with
    the state dict under "model") into the npz layout of `save_params`,
    BatchNorm folded into the convs. Offline, on the CPU; the file is
    read with `torch.load(weights_only=True)`, which takes tensors and
    plain containers and runs no pickled code."""
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    save_params(out_path, convert_torch_state_dict(sd))
