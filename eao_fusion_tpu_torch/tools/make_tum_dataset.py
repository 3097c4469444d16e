"""Write a synthetic ground-truthed sequence as an on-disk TUM dataset (port
of `tools/make_tum_dataset.py`, the same layout).

The layout the reference's pipeline reads (`ros_test/` message flow,
`data/rgb_*.txt` lists) and the CLI `eao_fusion_tpu_torch.apps.run_tum`
reads: 8-bit RGB PNGs and 16-bit depth PNGs with `rgb.txt` / `depth.txt`,
`groundtruth.txt` (TUM Twc), offline detections `boxes/<ts>.txt` (rows
`class x y w h score`, the `data/yolo_txts` format of `src/Tracking.cc:
476-524`), a rectified right eye `right/` + `right.txt` for the stereo
lane, and a constant-gravity `accelerometer.txt` for the IMU alignment.
The PNGs come from `encode_png`, stdlib `zlib` and `struct` only.

Run:  python -m eao_fusion_tpu_torch.tools.make_tum_dataset OUT_DIR
          [n_frames] [seed] [style] [--cache-dir DIR]
Then: python -m eao_fusion_tpu_torch.apps.run_tum OUT_DIR \\
          --boxes OUT_DIR/boxes --gt OUT_DIR/groundtruth.txt --out traj.txt
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from eao_fusion_tpu_torch.io import synthetic
from eao_fusion_tpu_torch.ops import lie

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def encode_png(a: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of an 8-bit grey [H, W] or RGB [H, W, 3] (uint8) or a
    16-bit grey [H, W] (uint16) image: no filter, one zlib stream."""
    a = np.asarray(a)
    if a.dtype == np.uint8 and a.ndim == 2:
        color, depth = 0, 8
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        color, depth = 2, 8
    elif a.dtype == np.uint16 and a.ndim == 2:
        color, depth = 0, 16
        a = a.astype(">u2")                       # PNG samples are big-endian
    else:
        raise ValueError(f"no PNG encoding for {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (_PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)


def write_dataset(out_dir: str, seq: synthetic.SyntheticSequence,
                  right: Optional[np.ndarray] = None,
                  depth_factor: float = 5000.0) -> None:
    """Write `seq` (and, if given, its right-eye greys [T, H, W]) as a TUM
    dataset under `out_dir`."""
    subs = ("rgb", "depth", "boxes") + (("right",) if right is not None
                                         else ())
    for sub in subs:
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    lines = {"rgb.txt": [], "depth.txt": [], "right.txt": [],
             "groundtruth.txt": []}
    for i, f in enumerate(seq.frames):
        ts = f"{f.timestamp:.6f}"
        g8 = np.clip(np.round(f.gray * 255), 0, 255).astype(np.uint8)
        _write(os.path.join(out_dir, "rgb", f"{ts}.png"),
               encode_png(np.stack([g8] * 3, axis=-1)))
        d16 = np.clip(np.round(f.depth * depth_factor), 0,
                      65535).astype(np.uint16)
        _write(os.path.join(out_dir, "depth", f"{ts}.png"), encode_png(d16))
        if right is not None:
            r8 = np.clip(np.round(right[i] * 255), 0, 255).astype(np.uint8)
            _write(os.path.join(out_dir, "right", f"{ts}.png"),
                   encode_png(r8))
            lines["right.txt"].append(f"{ts} right/{ts}.png")
        with open(os.path.join(out_dir, "boxes", f"{ts}.txt"), "w") as fh:
            for b in f.boxes:
                fh.write(" ".join(str(float(v)) for v in b) + "\n")
        lines["rgb.txt"].append(f"{ts} rgb/{ts}.png")
        lines["depth.txt"].append(f"{ts} depth/{ts}.png")
        twc = lie.se3_inverse(torch.from_numpy(
            np.asarray(f.tcw, np.float32))).numpy()
        qw, qx, qy, qz = twc[0], twc[1], twc[2], twc[3]
        tx, ty, tz = twc[4], twc[5], twc[6]
        lines["groundtruth.txt"].append(
            f"{ts} {tx} {ty} {tz} {qx} {qy} {qz} {qw}")
    for name, rows in lines.items():
        if rows:
            with open(os.path.join(out_dir, name), "w") as fh:
                fh.write("\n".join(rows) + "\n")

    # constant gravity along -y at 100 Hz (the D435i convention of the
    # gravity alignment, `message_flow.cc:270-308`)
    t_end = seq.frames[-1].timestamp
    with open(os.path.join(out_dir, "accelerometer.txt"), "w") as fh:
        fh.write("# t ax ay az\n")
        for k in range(int(t_end * 100) + 2):
            fh.write(f"{k / 100:.6f} 0.05 -9.78 0.12\n")


def main(out_dir: str, n_frames: int = 20, seed: int = 0,
         style: str = "arc", depth_factor: float = 5000.0,
         cache_dir: Optional[str] = None) -> None:
    """Render (or read from `cache_dir`) the sequence and its right eye on
    the host and write the dataset."""
    seq = synthetic.generate_sequence(n_frames=n_frames, seed=seed,
                                      style=style, cache_dir=cache_dir)
    right = synthetic.render_right_images(seq, seed=seed,
                                          cache_dir=cache_dir)
    write_dataset(out_dir, seq, right, depth_factor)
    print(f"wrote {len(seq.frames)}-frame TUM dataset -> {out_dir}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("n_frames", nargs="?", type=int, default=20)
    ap.add_argument("seed", nargs="?", type=int, default=0)
    ap.add_argument("style", nargs="?", default="arc")
    ap.add_argument("--cache-dir", default=None,
                    help="render cache of io/synthetic.generate_sequence")
    a = ap.parse_args()
    main(a.out_dir, a.n_frames, a.seed, a.style, cache_dir=a.cache_dir)
