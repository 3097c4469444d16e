"""Build, load and count the hand-written CUDA kernels of the port.

Each source in `csrc/` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, loaded with `ctypes`. The build
runs at first use (or from `build_all`, which starts one `nvcc` per source
at once) into `build/kernels/` beside the package; a library's file name
carries a hash of its source, so an edited source is rebuilt. Nothing here
runs when the module is imported, so the CPU tests import it freely.

Every wrapper launches through `launch`, which enters the tensors' card
(a ctypes call is outside PyTorch's device guard, so a launch would go to
the calling thread's current card, and a new thread starts on card 0),
hands the launcher that card's current stream, raises on a CUDA error and
adds one to `launches[<kernel>]`; nothing else counts. `reset_launches()`
sets the counts to 0. Building, loading and launching are safe across
threads (the data-parallel evaluator runs a System in each).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

# library name -> source file in csrc/
SOURCES = {"pose_opt": "pose_opt.cu", "ba_edge": "ba_edge.cu",
           "chol_solve": "chol_solve.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

launches: Dict[str, int] = {"pose_opt": 0, "ba_edge_full": 0,
                            "ba_edge_chi2": 0, "chol_solve": 0}

_loaded: Dict[str, ctypes.CDLL] = {}
# one build-and-load at a time: two threads asking for a missing library
# would otherwise both start nvcc; reentrant, since `library` builds
# through `build_all`
_build_lock = threading.RLock()
_count_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (argtypes) of each library's entry points
SIGNATURES = {
    "pose_opt": {
        "pose_opt_launch": [_P, _P, _P, _P, _P, _P, _I,    # pose0, PoseObs, M
                            _P, _P, _P, _I,                # PlaneObs, Q
                            _F, _F, _F, _F, _F,            # fx fy cx cy bf
                            _I, _I, _F, _F, _F, _F, _F,    # schedule, gates
                            _P, _P, _P, _P, _P],           # outs, stream
    },
    "ba_edge": {
        # BaEdgeArgs*, cam_pose, pt_xyz, active, stream
        "ba_edge_full_launch": [_P, _P, _P, _P, _P],
        # BaEdgeArgs*, cam_pose, pt_xyz, active, out_sum, out_edges, stream
        "ba_edge_chi2_launch": [_P, _P, _P, _P, _P, _P, _P],
        "ba_edge_args_size": [],
        "ba_edge_threads": [],
        "ba_edge_max_cameras": [],
    },
    "chol_solve": {
        "chol_solve_launch": [_P, _P, _P, _I, _I, _P],     # M b x D smem stream
    },
}


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """Call the C launcher `fn(*args, stream)` on `device` with that card's
    current stream, raise if it returns a CUDA error, and add one to the
    launch count of `kernel`."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, fn.__name__)
    with _count_lock:
        launches[kernel] += 1


def lib_path(name: str) -> Path:
    """Where the library `name` is built, keyed by its source's hash."""
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return exe


def build_all(names: List[str] = None) -> Dict[str, float]:
    """Compile every missing library, one `nvcc` per source, all started
    together. Returns {name: seconds} for the libraries it built; raises
    with the compiler's output if one fails. `-Xptxas -v` output (registers,
    shared memory, spills) is kept in `build/kernels/<lib>.log`."""
    with _build_lock:
        return _build(list(SOURCES) if names is None else names)


def _build(names: List[str]) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    times = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{out.stem}.log").write_bytes(log)
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        lib = _loaded.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (`cudaGetLastError`)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Validate a tensor handed to a kernel: dtype, shape, contiguous, on a
    CUDA device."""
    require_layout(t, name, dtype, shape)
    require_device(t, name)


def require_layout(t: torch.Tensor, name: str, dtype: torch.dtype,
                   shape) -> None:
    """Raise unless `t` has this dtype and shape and is contiguous."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_device(t: torch.Tensor, name: str,
                   device: torch.device = None) -> None:
    """Raise unless `t` lies on a CUDA device (on `device`, if given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
