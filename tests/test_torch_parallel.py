"""The port's multi-process initialization, mesh and data-parallel
evaluation: the EAO_* spec and the no-op without it (the twins of
tests/test_parallel_eval.py:49-62), a 2-process group formed by
`ensure_initialized` over TCP and over a file store, the mesh's dim names
and sizes, `summarize` against the JAX string, `evaluate_sequences` in
threads against a serial run, and the kernel library's build lock under
two threads."""

import ctypes
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.parallel import eval as JE
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.io import synthetic as TS
from eao_fusion_tpu_torch.parallel import eval as TE
from eao_fusion_tpu_torch.parallel import multihost
import torch_dist_worker as W


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once); put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_multihost_noop_without_env(monkeypatch):
    monkeypatch.delenv("EAO_MULTIHOST", raising=False)
    monkeypatch.delenv("EAO_COORDINATOR", raising=False)
    assert multihost.ensure_initialized() is False
    assert multihost.is_primary()
    assert multihost.global_device_count() == 1


def test_multihost_spec_from_env(monkeypatch):
    monkeypatch.setenv("EAO_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("EAO_NUM_PROCESSES", "4")
    monkeypatch.setenv("EAO_PROCESS_ID", "2")
    spec = multihost.MultihostSpec.from_env()
    assert spec.coordinator_address == "10.0.0.1:1234"
    assert spec.num_processes == 4 and spec.process_id == 2
    assert spec.backend is None


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Two 2-process groups formed by `ensure_initialized` from the EAO_*
    variables, one over TCP and one over a file store, at once:
    {"tcp"|"file": [what rank 0 saw, what rank 1 saw]}."""
    dirs = {k: tmp_path_factory.mktemp(f"mh_{k}") for k in ("tcp", "file")}
    coord = {"tcp": f"localhost:{_free_port()}",
             "file": f"file://{dirs['file'] / 'store'}"}
    handles = {k: W.start_ranks(W.job_multihost, 2, dirs[k],
                                dict(coordinator=coord[k]), group=False)
               for k in dirs}
    out = {}
    for k, h in handles.items():
        W.join_ranks(h)
        out[k] = [json.loads((dirs[k] / f"multihost_{r}.json").read_text())
                  for r in range(2)]
    return out


@pytest.mark.parametrize("kind", ["tcp", "file"])
def test_two_process_group_from_env(groups, kind):
    """World 2 on the CPU's gloo, formed once (a second call is a no-op
    that reports the same group), `is_primary` only on rank 0."""
    seen = groups[kind]
    for r, s in enumerate(seen):
        assert s["formed"] and s["again"]
        assert s["world"] == 2 and s["devices"] == 2
        assert s["backend"] == "gloo"
        assert s["primary"] == (r == 0)


def test_make_mesh_names_and_sizes(groups):
    """("lm", "kf") over the group: 2 x 1 by default, each rank its own
    ``lm`` coordinate; 1 x 2 when asked."""
    for r, s in enumerate(groups["tcp"]):
        assert s["mesh_names"] == ["lm", "kf"]
        assert s["mesh_shape"] == [2, 1]
        assert s["lm_size"] == 2 and s["lm_rank"] == r
        assert s["mesh2_shape"] == [1, 2] and s["kf_rank"] == r


def test_summarize_matches_jax():
    rows = [("arc12", 12, 7, 0, 0.00412, 0.0011, "cuda:0"),
            ("fwd15-long-sequence-name", 15, 9, 1, 0.0123456, 0.0021,
             "cuda:1")]
    got = TE.summarize([TE.SequenceResult(*r) for r in rows])
    ref = JE.summarize([JE.SequenceResult(*r) for r in rows])
    assert got == ref


def _cfg():
    """tests/test_parallel_eval.py's configuration."""
    return TC.SystemConfig(
        orb=TC.ORBConfig(n_features=400, max_keypoints=512),
        capacity=TC.MapCapacity(max_keyframes=32, max_points=4096),
        use_planes=False, use_objects=False)


def _loader(n, seed):
    def make():
        return TS.generate_sequence(n_frames=n, seed=seed, style="arc",
                                    cache_dir=synthetic.DEFAULT_CACHE)
    return make


def test_parallel_evaluation_matches_serial():
    """Two cached arcs evaluated in two threads on the CPU give the serial
    runs' keyframe counts and ATE within 1e-6 (the JAX test's bound), each
    ATE < 2 cm."""
    seqs = [("arc8", _loader(8, 0)), ("arc14s3", _loader(14, 3))]
    cfg = _cfg()
    par = TE.evaluate_sequences(seqs, cfg, devices=["cpu", "cpu"])
    ser = [TE._run_one(mk, name, cfg, "cpu") for name, mk in seqs]
    assert [r.name for r in par] == ["arc8", "arc14s3"]
    for rp, rs in zip(par, ser):
        assert rp.n_frames == rs.n_frames and rp.device == "cpu"
        assert rp.n_keyframes == rs.n_keyframes
        np.testing.assert_allclose(rp.ate_rmse, rs.ate_rmse, atol=1e-6)
        assert rp.ate_rmse < 0.02, (rp.name, rp.ate_rmse)
    print(TE.summarize(par))


def test_evaluation_needs_a_card_or_named_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.evaluate_sequences([("arc8", _loader(8, 0))], _cfg())


def test_library_build_is_serialized(monkeypatch, tmp_path):
    """Two threads ask for a library that is not built: one nvcc runs (the
    other thread waits for it and loads the same library), and its
    temporary output is keyed by process and thread."""
    active, peak, cmds = [0], [0], []
    lock = threading.Lock()

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            self.cmd = cmd
            self.returncode = 0
            cmds.append(cmd)

        def communicate(self):
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.3)
            out = self.cmd[self.cmd.index("-o") + 1]
            with open(out, "wb") as f:
                f.write(b"lib")
            with lock:
                active[0] -= 1
            return b"", None

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    got, idents = [], []

    def ask():
        idents.append(threading.get_ident())
        got.append(kernels.library("chol_solve"))

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert len(cmds) == 1 and peak[0] == 1
    assert len(got) == 2 and got[0] is got[1]
    tmp = cmds[0][cmds[0].index("-o") + 1]
    assert any(tmp.endswith(f".{os.getpid()}.{i}.tmp") for i in idents)
    assert kernels.lib_path("chol_solve").exists()
