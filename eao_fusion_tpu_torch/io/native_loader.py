"""ctypes bindings to the native host runtime `native/eao_host.cc` (port of
`eao_fusion_tpu/io/native_loader.py`).

The data plane of the engine: a C++ pthread prefetcher decodes TUM PNG
frames (its own zlib-based decoder, no OpenCV) into float buffers while
the card computes, with the reference's FIFO / latest-wins queue semantics
(`ros_test/src/message_flow.cc:217-268`).

The shared library is built at first use with `g++` and the flags of
`native/Makefile` into `build/native/` beside the package (git-ignored),
under a name that carries a hash of the source, so an edited source is
rebuilt. A failed build raises with the compiler's output, and a frame
that fails to decode raises: no frame is passed over quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "eao_host.cc"
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's CXXFLAGS and LDLIBS
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared"]
LD_LIBS = ["-lz", "-lpthread"]

_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libeao_host_{tag}.so"


def build() -> Path:
    """Compile `native/eao_host.cc` unless its library is there; returns
    the library's path. Raises RuntimeError with the compiler's output."""
    out = lib_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) to build the native "
                           "frame loader")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           *LD_LIBS], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    pint = ctypes.POINTER(ctypes.c_int)
    lib.eao_prefetcher_create.restype = ctypes.c_void_p
    lib.eao_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int]
    lib.eao_prefetcher_next.restype = ctypes.c_int64
    lib.eao_prefetcher_next.argtypes = [
        ctypes.c_void_p, f32, f32, ctypes.POINTER(ctypes.c_double), pint,
        pint, ctypes.c_int64]
    lib.eao_prefetcher_destroy.restype = None
    lib.eao_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.eao_decode_png.restype = ctypes.c_int
    lib.eao_decode_png.argtypes = [u8, ctypes.c_int64, u8, ctypes.c_int64,
                                   pint, pint, pint, pint]
    _lib = lib
    return lib


def decode_png(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode a PNG byte string (8-bit grey or RGB, 16-bit grey; not
    interlaced) with the native decoder. Returns (array [H, W(, C)],
    channels, bit depth); 16-bit samples come back as uint16."""
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros(64 * 1024 * 1024, np.uint8)
    w, h, c, bd = (ctypes.c_int() for _ in range(4))
    rc = lib.eao_decode_png(buf, len(buf), out, out.size, ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(c),
                            ctypes.byref(bd))
    if rc != 0:
        raise ValueError(f"png decode failed rc={rc}")
    W, H, C, BD = w.value, h.value, c.value, bd.value
    arr = out[:H * W * C * (BD // 8)]
    if BD == 16:
        arr = arr.reshape(-1, 2)
        arr = (arr[:, 0].astype(np.uint16) << 8) | arr[:, 1]   # big-endian
    arr = arr.reshape((H, W, C) if C > 1 else (H, W))
    return arr, C, BD


class FramePrefetcher:
    """Iterate (index, timestamp, gray [H, W] f32 in [0, 1], depth [H, W]
    f32 metres or None) while a native thread decodes the next frames
    (FIFO: `capacity` frames ahead; `latest_wins`: only the newest). Close
    it, or use it in a `with` block, to stop the thread."""

    def __init__(self, rgb_paths: List[str],
                 depth_paths: Optional[List[str]] = None,
                 timestamps: Optional[List[float]] = None,
                 width: int = 640, height: int = 480,
                 depth_factor: float = 5000.0, latest_wins: bool = False,
                 capacity: int = 4):
        lib = library()
        self._lib = lib
        self._w, self._h = width, height
        n = len(rgb_paths)
        rgb_arr = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
        dep_arr = ((ctypes.c_char_p * n)(*[p.encode() for p in depth_paths])
                   if depth_paths else None)
        ts_arr = (ctypes.c_double * n)(*(timestamps or [0.0] * n))
        # the native thread reads these arrays until it is destroyed
        self._keep = [rgb_arr, dep_arr, ts_arr]
        self._has_depth = bool(depth_paths)
        self._handle = lib.eao_prefetcher_create(
            rgb_arr, dep_arr, ts_arr, n, depth_factor,
            1 if latest_wins else 0, capacity)

    def __iter__(self) -> Iterator[Tuple[int, float, np.ndarray,
                                         Optional[np.ndarray]]]:
        gray = np.zeros(self._h * self._w, np.float32)
        depth = np.zeros(self._h * self._w, np.float32)
        while True:
            ts = ctypes.c_double()
            w = ctypes.c_int()
            h = ctypes.c_int()
            idx = self._lib.eao_prefetcher_next(
                self._handle, gray, depth, ctypes.byref(ts),
                ctypes.byref(w), ctypes.byref(h), gray.size)
            if idx == -1:
                return
            if idx == -2:
                raise ValueError(
                    "a frame failed to read or decode, or is larger than "
                    f"{self._w}x{self._h}")
            n = h.value * w.value
            g = gray[:n].reshape(h.value, w.value).copy()
            d = (depth[:n].reshape(h.value, w.value).copy()
                 if self._has_depth else None)
            yield int(idx), float(ts.value), g, d

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.eao_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "FramePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
