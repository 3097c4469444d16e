"""Train the YOLOX detector on the repo's synthetic renderer (port of
`eao_fusion_tpu/frontend/yolox_train.py`).

The reference ships a pretrained TensorRT engine (`src/YOLOX.cc:7-41`);
with no network, the same detector graph (frontend/yolox.py, the width-0.25
variant) is trained on ray-cast room scenes with exact ground-truth boxes
(io/synthetic.project_boxes), so the online lane (`semantic_online=True`)
runs with real weights.

Assignment is a static FCOS-style centre prior, not SimOTA: each box goes
to one FPN level by its longer side, and every cell whose centre lies
within `CENTER_RADIUS * stride` of the box centre (and inside the box) is
positive. Targets are built once on the host (numpy, as in the JAX
package); the step runs on the device of the data.

The random draws of a step (batch indices, contrast and brightness
factors, pixel noise) come from `draw_batch`, apart from the deterministic
`train_step`, so a test can feed both packages the same draws. The loss is
the JAX package's: objectness BCE, class BCE at 2x with no focal term, L1
regression at 5x, each over the number of positive cells. The optimizer is
AdamW (weight decay 5e-4 on every parameter, biases included, as optax's
`adamw`) behind a global-norm clip at 5, under `lr_schedule`, optax's
`warmup_cosine_decay_schedule`. Training runs in full float32 (the package
turns TF32 off on import).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from eao_fusion_tpu_torch import DeviceLike, resolve_device
from eao_fusion_tpu_torch.frontend import yolox

# level routing by the longer box side (pixels, letterboxed 640 input):
# stride 8 takes small boxes, 32 the large ones (FCOS scale ranges)
LEVEL_MAX_SIDE = (64.0, 160.0, 1e9)
CENTER_RADIUS = 1.5
PAD_VAL = 114.0 / 255.0
WEIGHT_DECAY = 5e-4
CLIP_NORM = 5.0


# ------------------------------------------------------------- target build

def build_targets(boxes: np.ndarray, n_classes: int,
                  input_size: int = yolox.INPUT_SIZE
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """boxes [B, 6] (class, x, y, w, h, score) in letterboxed pixels ->
    (pos [A] bool, cls [A] int32, reg [A, 4] f32), reg the raw head
    targets (tx, ty, tw, th): `yolox.decode_and_nms` computes cx = (tx +
    gx) s and w = exp(tw) s, so tx = cx / s - gx, tw = log(w / s)."""
    grid, stride = yolox._grids(input_size)
    A = grid.shape[0]
    pos = np.zeros((A,), bool)
    cls = np.zeros((A,), np.int32)
    reg = np.zeros((A, 4), np.float32)
    if len(boxes) == 0:
        return pos, cls, reg
    # smaller boxes, assigned last, win contested cells (they are harder)
    order = np.argsort(-(boxes[:, 3] * boxes[:, 4]))
    cell_cx = (grid[:, 0] + 0.5) * stride
    cell_cy = (grid[:, 1] + 0.5) * stride
    for b in boxes[order]:
        c, x, y, w, h = int(b[0]), b[1], b[2], b[3], b[4]
        if w <= 2 or h <= 2:
            continue
        lvl = int(np.searchsorted(LEVEL_MAX_SIDE, max(w, h)))
        lvl = min(lvl, len(yolox.STRIDES) - 1)
        s = float(yolox.STRIDES[lvl])
        on_lvl = stride == s
        bcx, bcy = x + w / 2, y + h / 2
        near = (np.abs(cell_cx - bcx) <= CENTER_RADIUS * s) & \
               (np.abs(cell_cy - bcy) <= CENTER_RADIUS * s)
        inside = (cell_cx >= x) & (cell_cx <= x + w) & \
                 (cell_cy >= y) & (cell_cy <= y + h)
        sel = on_lvl & near & inside
        if not sel.any():   # tiny / edge box: the nearest cell takes it
            d2 = (cell_cx - bcx) ** 2 + (cell_cy - bcy) ** 2
            d2[~on_lvl] = np.inf
            sel = np.zeros((A,), bool)
            sel[int(np.argmin(d2))] = True
        pos |= sel
        cls[sel] = c
        reg[sel, 0] = bcx / s - grid[sel, 0]
        reg[sel, 1] = bcy / s - grid[sel, 1]
        reg[sel, 2] = np.log(max(w, 1e-3) / s)
        reg[sel, 3] = np.log(max(h, 1e-3) / s)
    return pos, cls, reg


def flip_boxes(boxes: np.ndarray, width: int) -> np.ndarray:
    out = boxes.copy()
    if len(out):
        out[:, 1] = width - out[:, 1] - out[:, 3]
    return out


# ------------------------------------------------------------------ dataset

def _zoom_out(gray: np.ndarray, boxes: np.ndarray, scale: float
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Scale augmentation: shrink the frame by `scale` into a pad-value
    canvas of the same size (so the scale-1 letterbox and pixel-space
    targets stay consistent) and scale the boxes. It teaches the class
    head scale invariance."""
    h, w = gray.shape
    nh, nw = int(round(h * scale)), int(round(w * scale))
    ys = (np.arange(nh) / scale).astype(np.int32).clip(0, h - 1)
    xs = (np.arange(nw) / scale).astype(np.int32).clip(0, w - 1)
    small = gray[ys][:, xs]
    canvas = np.full_like(gray, PAD_VAL)
    canvas[:nh, :nw] = small
    b = boxes.copy()
    if len(b):
        b[:, 1:5] *= scale
    return canvas, b


def build_dataset(seqs, n_classes: int, with_flips: bool = True,
                  zoom_scales: Tuple[float, ...] = (0.75, 0.55)
                  ) -> Dict[str, np.ndarray]:
    """seqs: SyntheticSequences. Returns stacked host arrays: gray [N, H, W]
    f32, pos [N, A] bool, cls [N, A] i32, reg [N, A, 4] f32, and the boxes
    of each image as a list."""
    grays, poss, clss, regs, boxes_all = [], [], [], [], []

    def add(g, b):
        p, c, r = build_targets(b, n_classes)
        grays.append(np.asarray(g, np.float32))
        poss.append(p)
        clss.append(c)
        regs.append(r)
        boxes_all.append(b)

    for seq in seqs:
        w = seq.camera.width
        for i, f in enumerate(seq.frames):
            for flip in ((False, True) if with_flips else (False,)):
                g = f.gray[:, ::-1] if flip else f.gray
                b = flip_boxes(f.boxes, w) if flip else f.boxes
                add(g, b)
                # one zoomed copy per frame, the scale cycled by frame index
                if zoom_scales:
                    s = zoom_scales[i % len(zoom_scales)]
                    add(*_zoom_out(g, b, s))
    return {"gray": np.stack(grays), "pos": np.stack(poss),
            "cls": np.stack(clss), "reg": np.stack(regs),
            "boxes": boxes_all}


def dataset_to_device(data_h: Dict, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    """`build_dataset`'s arrays as tensors on `device` (cls as int64)."""
    return {"gray": torch.as_tensor(data_h["gray"], device=device),
            "pos": torch.as_tensor(data_h["pos"], device=device),
            "cls": torch.as_tensor(data_h["cls"], device=device).long(),
            "reg": torch.as_tensor(data_h["reg"], device=device)}


# ----------------------------------------------------------------- training

def _letterbox_batch(gray: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W] grey -> [B, 3, size, size] letterboxed RGB (the synthetic
    camera is 640x480: scale 1, bottom padding, as `yolox.letterbox` for
    this geometry)."""
    b, h, w = gray.shape
    if max(h, w) != size:
        # this pad-only path holds only when the letterbox scale is 1; any
        # other camera would part from yolox.letterbox's resize and from
        # the pixel-space targets of build_targets
        raise ValueError(
            f"_letterbox_batch requires max(h, w) == {size} (scale-1 "
            f"letterbox); got {h}x{w} — resize the training images or "
            f"generalize this function first")
    img = F.pad(gray, (0, size - w, 0, size - h), value=PAD_VAL)
    return img[:, None].expand(b, 3, size, size)


def lr_schedule(n_steps: int, lr_peak: float = 1e-3
                ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr_peak, W, n_steps,
    lr_peak 1e-2), W = min(100, n_steps // 10 + 1): the learning rate of
    the update after `step` updates. It starts at 0, so the first update
    moves nothing (the weight decay is scaled by it too)."""
    warm = min(100, n_steps // 10 + 1)
    decay = n_steps - warm
    if decay <= 0:
        raise ValueError(f"n_steps = {n_steps} leaves no decay steps")
    alpha = 1e-2

    def lr(step: int) -> float:
        if step < warm:
            return lr_peak * min(max(step, 0), warm) / warm
        c = min(step - warm, decay)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return lr_peak * ((1.0 - alpha) * cos + alpha)
    return lr


def _leaves(tree: Dict) -> List[torch.Tensor]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def make_optimizer(params: Dict, n_steps: int, lr_peak: float = 1e-3):
    """(AdamW, LambdaLR) over every parameter of the tree, which is made to
    require gradients. The group's base rate is 1 and the schedule gives
    the rate itself; step the scheduler after `optimizer.step()`."""
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=WEIGHT_DECAY)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule(n_steps,
                                                               lr_peak))
    return opt, sched


def draw_batch(generator: torch.Generator, n_images: int, batch: int,
               size: int = yolox.INPUT_SIZE) -> Dict[str, torch.Tensor]:
    """A step's random draws, on the generator's device: the batch's image
    indices [B], contrast factors a [B, 1, 1, 1] ~ U(0.8, 1.2), brightness
    shifts [B, 1, 1, 1] ~ U(-0.1, 0.1) and the pixel noise [B, 3, size,
    size] ~ N(0, 1) (NCHW; the JAX package draws it NHWC)."""
    dev = generator.device
    kw = dict(generator=generator, device=dev)
    return {"idx": torch.randint(0, n_images, (batch,), **kw),
            "a": 0.8 + 0.4 * torch.rand((batch, 1, 1, 1), **kw),
            "b": -0.1 + 0.2 * torch.rand((batch, 1, 1, 1), **kw),
            "noise": torch.randn((batch, 3, size, size), **kw)}


def loss_fn(raw: torch.Tensor, pos: torch.Tensor, cls: torch.Tensor,
            reg: torch.Tensor, n_classes: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """raw [B, A, 5 + C] -> (loss, {"obj", "cls", "reg"}), each term over
    the number of positive cells."""
    posf = pos.float()
    npos = torch.clamp(posf.sum(), min=1.0)
    l_obj = F.binary_cross_entropy_with_logits(raw[..., 4], posf,
                                               reduction="sum")
    # the class head: plain BCE at 2x weight (a focal term starved the
    # gradient and collapsed the head in the JAX package's training)
    cls1h = F.one_hot(cls, n_classes).float()
    bce = F.binary_cross_entropy_with_logits(raw[..., 5:], cls1h,
                                             reduction="none")
    l_cls = (bce.sum(-1) * posf).sum()
    l_reg = ((raw[..., 0:4] - reg).abs().sum(-1) * posf).sum()
    return ((l_obj + l_cls + 5.0 * l_reg) / npos,
            {"obj": l_obj / npos, "cls": l_cls / npos, "reg": l_reg / npos})


def train_step(params: Dict, opt, sched, data: Dict[str, torch.Tensor],
               draws: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One deterministic update of `params` in place: the batch `draws`
    selects, photometric jitter, the loss and its gradient, the clip, the
    AdamW step, the schedule's step. Returns the loss and its terms
    (detached, on the device)."""
    depth_mult, n_classes = yolox.infer_arch(params)
    idx = draws["idx"]
    imgs = _letterbox_batch(data["gray"][idx], yolox.INPUT_SIZE)
    imgs = torch.clamp(imgs * draws["a"] + draws["b"]
                       + 0.01 * draws["noise"], 0.0, 1.3)
    raw = yolox.yolox_forward_batch(params, imgs, depth_mult)
    loss, aux = loss_fn(raw, data["pos"][idx], data["cls"][idx],
                        data["reg"][idx], n_classes)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    torch.nn.utils.clip_grad_norm_(opt.param_groups[0]["params"], CLIP_NORM)
    opt.step()
    sched.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


@torch.no_grad()
def evaluate(params: Dict, depth_mult: int, n_classes: int,
             grays: Sequence[np.ndarray], boxes: Sequence[np.ndarray],
             iou_thresh: float = 0.4) -> Dict[str, float]:
    """Box recall and class accuracy of the decoded detections against the
    ground truth, on the device of `params`."""
    dev = params["stem"]["conv"]["w"].device
    n_gt = n_hit = n_cls = n_det = 0
    for g, gt in zip(grays, boxes):
        x, scale = yolox.letterbox(torch.as_tensor(
            np.asarray(g, np.float32), device=dev)[..., None].repeat(1, 1, 3))
        det = yolox.decode_and_nms(
            yolox.yolox_forward(params, x, depth_mult), scale,
            n_classes=n_classes).cpu().numpy()
        det = det[det[:, 5] > 0]
        n_det += len(det)
        for b in gt:
            n_gt += 1
            if len(det) == 0:
                continue
            ix0 = np.maximum(det[:, 1], b[1])
            iy0 = np.maximum(det[:, 2], b[2])
            ix1 = np.minimum(det[:, 1] + det[:, 3], b[1] + b[3])
            iy1 = np.minimum(det[:, 2] + det[:, 4], b[2] + b[4])
            inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
            union = det[:, 3] * det[:, 4] + b[3] * b[4] - inter
            iou = inter / np.maximum(union, 1e-9)
            j = int(np.argmax(iou))
            if iou[j] >= iou_thresh:
                n_hit += 1
                n_cls += int(det[j, 0]) == int(b[0])
    return {"recall": n_hit / max(n_gt, 1),
            "cls_acc": n_cls / max(n_hit, 1),
            "dets_per_img": n_det / max(len(grays), 1)}


def _detached(tree: Dict) -> Dict:
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


def train(train_seqs, val_seq, *, n_classes: int = 8,
          width_mult: float = 0.25, depth_mult: int = 1, batch: int = 8,
          n_steps: int = 1200, seed: int = 0, log=print,
          device: DeviceLike = None) -> Tuple[Dict, Dict[str, float]]:
    """A full training run on `device` (`cuda` unless named); returns (the
    trained parameter tree, held-out metrics with the run's timing). The
    initial weights are drawn on the CPU from `seed`, the same on every
    device; the batch draws on the device from `seed + 1`."""
    device = resolve_device(device)
    data_h = build_dataset(train_seqs, n_classes)
    log(f"dataset: {data_h['gray'].shape[0]} images "
        f"(pos cells/img {data_h['pos'].sum(1).mean():.1f})")
    data = dataset_to_device(data_h, device)
    n_images = data_h["gray"].shape[0]
    del data_h

    g_init = torch.Generator().manual_seed(seed)
    params = yolox.init_params(g_init, depth_mult=depth_mult,
                               width_mult=width_mult, n_classes=n_classes,
                               device=device)
    opt, sched = make_optimizer(params, n_steps)
    g_draw = torch.Generator(device=device).manual_seed(seed + 1)

    t0 = time.perf_counter()
    for i in range(n_steps):
        loss, aux = train_step(params, opt, sched, data,
                               draw_batch(g_draw, n_images, batch))
        if i % 100 == 0 or i == n_steps - 1:
            log(f"step {i:5d} loss {float(loss):8.3f} "
                f"obj {float(aux['obj']):7.3f} cls {float(aux['cls']):6.3f} "
                f"reg {float(aux['reg']):6.3f} "
                f"[{time.perf_counter() - t0:.0f}s]")
    train_s = time.perf_counter() - t0
    params = _detached(params)
    m = evaluate(params, depth_mult, n_classes,
                 [f.gray for f in val_seq.frames],
                 [f.boxes for f in val_seq.frames])
    m.update(train_s=train_s, ms_per_step=train_s / n_steps * 1e3)
    log(f"held-out: recall {m['recall']:.3f} cls_acc {m['cls_acc']:.3f} "
        f"dets/img {m['dets_per_img']:.1f}")
    return params, m
