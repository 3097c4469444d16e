"""The port's distributed layer with one rank per card, on the CPU:
`apps/dryrun_multicard` (the counterpart of `dryrun_multichip`) on 2 gloo
CPU ranks, on a perturbed GBA problem and the cached arc's frames: its
distributed GBA against the JAX package's `distributed_bundle_adjust` on 2
of the conftest's 8 CPU devices, and its sharded step against the port's
unsharded step; the backend and the rank
-> card mapping with a patched card count (`LOCAL_RANK`,
`LOCAL_WORLD_SIZE`); and the repairs that let a System, a rank or a
kernel launch work on a card other than the thread's current one (an
indexed device everywhere, every launch inside `torch.cuda.device`, in
`kernels.launch`).
The card-only twins are in tests/test_torch_multicard_gpu.py."""

import json
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu.config import SolverConfig as JSolverConfig
from eao_fusion_tpu.io import synthetic as JSyn
from eao_fusion_tpu.parallel import dist_ba as JD
from eao_fusion_tpu.parallel import mesh as JM
from eao_fusion_tpu.solvers import ba as JB
import eao_fusion_tpu_torch as port
from eao_fusion_tpu_torch import kernels
from eao_fusion_tpu_torch.apps import dryrun_multicard as DM
from eao_fusion_tpu_torch.io import synthetic as TSyn
from eao_fusion_tpu_torch.parallel import dist_ba, multihost, sharded_step
from eao_fusion_tpu_torch.pipeline import steady
import torch_dist_worker as W

CARDS = 2
N_FRAMES = 4


def perturbed_problem() -> dict:
    """The JAX function's GBA problem started away from its optimum: the
    points moved by 2 cm, the free cameras by 1 cm and about 0.5 degrees,
    the free plane's offset by 2 cm, and 0.5 px of noise on every
    observation."""
    a = DM.dist_ba_problem(CARDS)
    r = np.random.default_rng(3)
    noise = lambda k, sd: (a[k] + r.normal(0, sd, a[k].shape)).astype(
        np.float32)
    a["prob_pt_xyz"] = noise("prob_pt_xyz", 0.02)
    a["prob_obs_uv"] = noise("prob_obs_uv", 0.5)
    cams = a["prob_cam_pose"].copy()
    free = ~a["prob_cam_fixed"]
    q = cams[free, :4] + r.normal(0, 0.004, (free.sum(), 4))
    cams[free, :4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    cams[free, 4:7] += r.normal(0, 0.01, (free.sum(), 3))
    a["prob_cam_pose"] = cams.astype(np.float32)
    a["pf_pl_coeff"] = a["pf_pl_coeff"] + np.float32([0, 0, 0, 0.02])
    return a


def arc_frames(cfg):
    """The first N_FRAMES frames of the cached seed-0 arc at half size
    (every second pixel; the step's camera is the arc's at half size),
    their boxes scaled to match and padded to max_objects_2d rows."""
    seq = TSyn.generate_sequence(n_frames=16, seed=0, style="arc",
                                 cache_dir=JSyn.DEFAULT_CACHE)
    out = []
    for f in seq.frames[:N_FRAMES]:
        boxes = np.zeros((cfg.objects.max_objects_2d, 6), np.float32)
        b = np.asarray(f.boxes, np.float32)[:len(boxes)]
        boxes[:len(b)] = b
        boxes[:, 1:5] *= 0.5
        out.append((np.ascontiguousarray(f.gray[::2, ::2]),
                    np.ascontiguousarray(f.depth[::2, ::2]), boxes,
                    float(f.timestamp)))
    return out


@pytest.fixture(scope="module")
def dryrun():
    """`dryrun_multicard.run(2, "cpu")` on the perturbed problem and the
    arc's frames, started in a thread of its own (the ranks are spawned
    processes), so that a test's own work overlaps it; the fixture's value
    is (problem, frames, a function that waits for the result)."""
    problem, frames = perturbed_problem(), arc_frames(DM.step_config())
    box = {}

    def work():
        try:
            box["got"] = DM.run(CARDS, "cpu", timeout=120.0, quiet=True,
                                problem=problem, frames=frames)
        except BaseException as e:            # raised in the test
            box["exc"] = e

    t = threading.Thread(target=work)
    t.start()

    def result():
        t.join()
        if "exc" in box:
            raise box["exc"]
        return box["got"]
    yield problem, frames, result
    t.join()


def test_dist_ba_matches_jax(dryrun):
    """The perturbed problem through JAX's distributed GBA on a 2-device lm
    mesh (while the ranks run), and through the dry run's 2 gloo ranks:
    poses, points and the plane within 1e-3, chi2 within 1e-3 relative;
    and the GBA did work: the points moved by 5 mm on the mean, and each
    free camera moved (a GBA that returned its input would fail)."""
    a, _, result = dryrun
    prob = JB.BAProblem(**{k[5:]: jnp.asarray(v) for k, v in a.items()
                           if k.startswith("prob_")})
    pf = JB.PlaneFreeBlock(**{k[3:]: jnp.asarray(v) for k, v in a.items()
                              if k.startswith("pf_")})
    mesh = JM.make_mesh(n_landmark=CARDS, devices=jax.devices()[:CARDS])
    ref = JD.distributed_bundle_adjust(prob, mesh, plane_free=pf, cam=DM.CAM,
                                       cfg=JSolverConfig(), n_iters1=1,
                                       n_iters=2)
    got = result()
    assert got["backend"] == "gloo"
    assert [r["device"] for r in got["ranks"]] == ["cpu"] * CARDS
    out = got["dist_ba"]
    for k in ("cam_pose", "pt_xyz", "pl_coeff"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(ref, k)),
                                   atol=1e-3, err_msg=k)
    c_ref = float(ref.chi2)
    assert abs(got["chi2"] - c_ref) <= 1e-3 * abs(c_ref)
    moved = lambda k: np.abs(out[k] - a[f"prob_{k}"]).max(axis=-1)
    assert moved("pt_xyz").mean() > 5e-3
    assert (moved("cam_pose")[~a["prob_cam_fixed"]] > 1e-3).all()


def test_sharded_step_matches_unsharded_bits(dryrun):
    """The arc's first frame starts the map through a System, and the next
    three go through the port's unsharded `slam_step` here and through the
    sharded step on the 2 ranks' 1 x 2 mesh: the same keyframe decisions
    and inlier counts, and the same bits in the pose, the tracked points
    and every field of the gathered map and object table. Every step
    inserts a keyframe and its points."""
    _, frames, result = dryrun
    cfg = DM.step_config()
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # as the ranks
    try:
        st = DM.warm_state(cfg, "cpu", frames[0])
        kfi, inl = [], []
        for gray, depth, boxes, ts in frames[1:]:
            st, diag = steady.slam_step(
                st, torch.as_tensor(gray), torch.as_tensor(depth),
                torch.as_tensor(boxes), ts, cfg=cfg, kf_every=1)
            kfi.append(bool(diag["kf_inserted"]))
            inl.append(int(diag["n_inliers"]))
    finally:
        torch.set_num_threads(n)
    ref = DM.state_record(st)
    assert kfi == [True] * (N_FRAMES - 1)
    assert int(ref["map.next_kf"]) == N_FRAMES
    assert int(ref["map.pt_valid"].sum()) > 256
    got = result()
    assert got["mesh"] == [1, 2] and got["pt_blocks"] == 1
    sh = got["sharded"]
    assert sh["kf_inserted"].tolist() == kfi
    assert sh["n_inliers"].tolist() == inl
    differ = [k for k in ref if not np.array_equal(
        np.asarray(sh[k]).reshape(-1).view(np.uint8),
        np.asarray(ref[k]).reshape(-1).view(np.uint8))]
    assert not differ, differ


def test_too_few_cards_raise(monkeypatch):
    """Asking for more ranks than cards raises before a rank is spawned:
    ranks never share a card in the dry run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 cards"):
        DM.run(2, "cuda")
    with pytest.raises(ValueError):
        DM.run(0, "cpu")


@pytest.fixture
def four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    return monkeypatch


@pytest.mark.parametrize("world, local_world, backend", [
    (4, None, "nccl"), (2, None, "nccl"), (8, None, "gloo"),
    (8, 4, "nccl"), (8, 8, "gloo")])
def test_default_backend(four_cards, world, local_world, backend):
    """On a host with 4 cards: NCCL while every rank of the host has a card
    of its own (the host's ranks from LOCAL_WORLD_SIZE where a launcher
    sets it), else gloo."""
    if local_world is not None:
        four_cards.setenv("LOCAL_WORLD_SIZE", str(local_world))
    assert multihost._default_backend(world) == backend


def test_rank_device_honours_local_rank(four_cards):
    """Rank r on cuda:r; with LOCAL_RANK (a launcher over several hosts)
    the rank within its host picks the card, not the global rank."""
    assert [multihost._rank_device(r) for r in range(4)] == [
        torch.device("cuda", r) for r in range(4)]
    assert multihost._rank_device(5) == torch.device("cuda", 1)
    four_cards.setenv("LOCAL_RANK", "2")
    assert multihost._rank_device(5) == torch.device("cuda", 2)


def test_devices_are_indexed(monkeypatch):
    """A System's device (`resolve_device`) and a rank's device
    (`multihost.local_device`) name their card: `cuda` alone means the
    current card of the thread that asks, and a new thread starts on card
    0, so the GBA thread, the evaluator's threads and the serving ranks
    enter the indexed card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert port.resolve_device(None) == torch.device("cuda", 2)
    assert port.resolve_device("cuda") == torch.device("cuda", 2)
    assert port.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert port.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(multihost, "_device", None)
    assert multihost.local_device() == torch.device("cuda", 2)
    monkeypatch.setattr(multihost, "_device", torch.device("cuda", 3))
    cuda_mesh = types.SimpleNamespace(device_type="cuda")
    # the serving rank's buffers and the sharded step's blocks: the card
    # the rank joined with, whatever the asking thread's current card
    assert dist_ba._mesh_device(cuda_mesh) == torch.device("cuda", 3)
    assert sharded_step._device(cuda_mesh) == torch.device("cuda", 3)
    cpu_mesh = types.SimpleNamespace(device_type="cpu")
    assert dist_ba._mesh_device(cpu_mesh) == torch.device("cpu")


@pytest.mark.parametrize("kernel", sorted(kernels.launches))
@pytest.mark.parametrize("err", [0, 700])
def test_launch_enters_the_card(monkeypatch, kernel, err):
    """`kernels.launch` calls the launcher inside `torch.cuda.device(<the
    tensors' card>)` with that card's current stream last: a ctypes call
    is outside PyTorch's device guard, so a launch from a thread on card 0
    with tensors on another card went wrong (on four H100s, K1 on cuda:3
    returned a wrong pose and K2 faulted the context). It counts a launch
    that returned no error, and raises on one that did."""
    card = torch.device("cuda", 3)
    entered = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.append(None)

    def current_stream(device):
        assert entered == [card] and device == card
        return types.SimpleNamespace(cuda_stream=1234)

    def fake_launch(*args):
        assert entered == [card]
        calls.append(args)
        return err
    fake_launch.__name__ = f"{kernel}_launch"
    calls = []
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    kernels.reset_launches()
    if err:
        with pytest.raises(RuntimeError, match=f"{kernel}_launch: CUDA "
                                               f"error {err}"):
            kernels.launch(kernel, fake_launch, card, 11, None, 2.5)
    else:
        kernels.launch(kernel, fake_launch, card, 11, None, 2.5)
    assert calls == [(11, None, 2.5, 1234)]
    assert entered == [card, None]
    assert kernels.launches == {k: int(k == kernel and not err)
                                for k in kernels.launches}
    kernels.reset_launches()


FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    for _ in range(64):            # 4 MiB in 64 writes, 2 ms apart
        f.write(bytes(65536))
        f.flush()
        time.sleep(0.002)
"""


def test_ranks_build_the_kernels_at_once(tmp_path):
    """Four ranks whose first use builds `build/kernels/` at the same
    moment (the dry run's and the multi-card phases' ranks): each compiles
    into a temporary file of its own and renames it into place, so every
    rank finds the whole library and no temporary file is left."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    build = tmp_path / "kernels"
    W.join_ranks(W.start_ranks(
        W.job_build_kernels, 4, tmp_path,
        {"bin": str(bin_dir), "build_dir": str(build),
         "start": time.time() + 5.0}, group=False), timeout=120.0)
    got = [json.load(open(tmp_path / f"built_{r}.json"))
           for r in range(4)]
    assert all(g["size"] == 64 * 65536 for g in got), got
    assert any(g["compiled"] for g in got)
    assert [p.name for p in build.iterdir()
            if not p.name.endswith(".log")] == [
        p.name for p in build.glob("libchol_solve_*.so")]
    assert len(list(build.glob("*.so"))) == 1
