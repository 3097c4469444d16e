"""The port on cards other than card 0, held to the one-card results (the
card-only twins of tests/test_torch_multicard.py). Torch only, no JAX.
Every test is marked `gpu` and skips inside itself with fewer than two
cards:

    python3 -m pytest -m gpu tests/test_torch_multicard_gpu.py -s

  * K1-K4 on the last card against their plain versions at phases 3-5's
    shapes of `chip_smoke.py`, the test process staying on card 0 (the
    wrappers enter their tensors' card), K4 on card 0 first and then from
    four threads at once (its launcher's shared-memory opt-in holds per
    card);
  * a System on cuda:1, in a fresh process that never selects a card,
    over the 20-frame seed-0 arc with planes on (phase 7's configuration):
    phase 7's ATE bits and launch counts, and nothing allocated on card 0;
  * a GBA on that System's loop-closer thread: nothing on card 0, and the
    bits of the same GBA in a fresh process on cuda:0;
  * the distributed GBA on 2 NCCL ranks, one card each, within 1e-5 of 2
    gloo ranks sharing card 0.
"""

import functools
import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as W

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]
# phase 7 of chip_smoke.py on one card (`phase_planes_path`, on this
# tree and on its parent's, PERF.md §5); 0.33266156753885706 cm and 38 /
# 70 / 114 / 70 before the planes' float64 refit
PHASE7_ATE_CM = 0.33458211063523746
PHASE7_LAUNCHES = {"pose_opt": 38, "ba_edge_full": 69, "ba_edge_chi2": 113,
                   "chol_solve": 69}


def _cards(n: int = 2) -> int:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} cards, found {have}")
    return have


@functools.lru_cache(maxsize=None)
def _smoke():
    """chip_smoke.py, loaded from its file (its problem builders)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernels_on_the_last_card():
    n = _cards()
    from eao_fusion_tpu_torch import kernels
    from eao_fusion_tpu_torch.config import SolverConfig
    from eao_fusion_tpu_torch.solvers import ba_edge, pose_opt
    cs = _smoke()
    last = torch.device("cuda", n - 1)
    cfg = SolverConfig()
    torch.cuda.set_device(0)

    # K4 at D = 192 (local BA's system on the last card, and a random SPD
    # matrix) and D = 72, on card 0 first and then on the last card;
    # phase 5's check: within 1e-4 of the plain version and of a float64
    # solve of the symmetric matrix of M's lower triangle
    systems = [cs.schur_system(last), cs.spd_problem(192, 192, 1e3, "cpu"),
               cs.spd_problem(72, 72, 1e3, "cpu"),
               cs.spd_problem(288, 288, 1e3, "cpu")]
    for dev in (torch.device("cuda", 0), last):
        for M, b in systems:
            n0 = kernels.launches["chol_solve"]
            cs._chol_check(f"on {dev}", M.to(dev), b.to(dev))
            assert kernels.launches["chol_solve"] == n0 + 1
    # K4 of several sizes from four threads at once, on both cards: the
    # launcher's opt-in is set once per card at the largest size, so no
    # thread's launch lowers it under another's
    errors = []

    def solve_many(dev, D):
        try:
            M, b = cs.spd_problem(D, D, 1e3, "cpu")
            for _ in range(8):
                cs._chol_check(f"D = {D} on {dev}", M.to(dev), b.to(dev))
        except Exception as e:
            errors.append(e)
    threads = [threading.Thread(target=solve_many, args=(dev, D))
               for dev in (torch.device("cuda", 0), last) for D in (72, 288)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors

    # K1 with no planes and with the main path's eight plane slots
    pose0, obs, pobs = cs.pose_problem(np.random.default_rng(7), last)
    for planes in (None, pobs["8 slots, 3 unmatched"]):
        ref = pose_opt.optimize_pose_plain(pose0, obs, planes, cam=cs.CAM,
                                           cfg=cfg)
        ker = pose_opt.optimize_pose_cuda(pose0, obs, planes, cam=cs.CAM,
                                          cfg=cfg)
        assert ker.pose.device == last
        assert cs.pose_err(ref.pose, ker.pose) < 1e-3
        assert float((ref.inliers == ker.inliers).float().mean()) > 0.995
        assert abs(int(ref.n_inliers) - int(ker.n_inliers)) <= 5

    # K2 and K3 through the binding local BA makes, phase 4's window
    x, active = cs.edge_problem(np.random.default_rng(11), last)
    kw = dict(cam=cs.CAM, chi2_mono=cfg.chi2_mono,
              chi2_stereo=cfg.chi2_stereo)
    Pw = x.pt_xyz.shape[0]
    tgt = torch.where(active > 0, x.obs_pt, Pw).to(torch.int32)
    edges = ba_edge.EdgePass(x, tgt, **kw)
    args = (x.cam_pose, x.pt_xyz, active)
    ref = ba_edge.edge_sums_plain(x, active, tgt, **kw)
    for a, k, dim in zip(ref, edges.full(*args), (0, 0, 1)):
        assert k.device == last
        scale = a.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        assert float(((a - k).abs() / scale).max()) < 1e-4
    terms = ba_edge.edge_pass_chi2_plain(x, active, **kw)[0]
    assert abs(edges.chi2_sum(*args).item() - terms.sum().item()) <= \
        1e-5 * terms.abs().sum().item()
    ref3 = ba_edge.edge_pass_chi2_plain(x, active, **kw)
    ker3 = edges.chi2_edges(*args)
    for a, k in zip(ref3[:2], ker3[:2]):
        assert float(((a - k).abs() / a.abs().clamp(min=1.0)).max()) < 1e-3
    assert torch.equal(ref3[2], ker3[2])
    assert torch.cuda.current_device() == 0


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """Phase 7's run and a GBA of its map, each in a fresh process that
    never selects a card: the System on cuda:1, then on cuda:0. Returns
    {card index: the job's npz}."""
    _cards()
    from eao_fusion_tpu_torch.config import tum_fr3_config
    from eao_fusion_tpu_torch.io import synthetic
    tmp = tmp_path_factory.mktemp("systems")
    cfg = tum_fr3_config(use_objects=False, use_loop_closing=False)
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc",
                                      camera=cfg.camera)
    np.savez(tmp / "arc.npz", gray=np.stack([f.gray for f in seq.frames]),
             depth=np.stack([f.depth for f in seq.frames]),
             ts=np.array([f.timestamp for f in seq.frames]),
             tcw=seq.gt_tcw())
    out = {}
    for card in (1, 0):
        W.join_ranks(W.start_ranks(W.job_system_on_card, 1, tmp,
                                   {"cfg": cfg, "device": f"cuda:{card}"},
                                   group=False), timeout=600.0)
        out[card] = dict(np.load(tmp / f"system_{card}.npz"))
    return out


def test_system_on_card_1(systems):
    """Phase 7's ATE bits and launches on cuda:1, and nothing of the System
    allocated on card 0, the process's current card."""
    r = systems[1]
    assert float(r["ate_cm"]) == PHASE7_ATE_CM
    assert json.loads(str(r["launches"])) == PHASE7_LAUNCHES
    assert int(r["current_device"]) == 0
    mem = r["memory_allocated"]
    assert mem[0] == 0 and mem[1] > 0, mem.tolist()


def test_gba_thread_on_card_1(systems):
    """The loop closer's GBA thread of the System on cuda:1 starts on card
    0 and enters cuda:1: nothing allocated on card 0, and the merged map
    has the bits of the same GBA on cuda:0."""
    one, zero = systems[1], systems[0]
    assert bool(one["merged"]) and bool(zero["merged"])
    assert one["memory_allocated"][0] == 0
    assert float(zero["ate_cm"]) == float(one["ate_cm"])
    fields = [k for k in zero if k.startswith("map.")]
    assert fields
    differ = [k for k in fields if not np.array_equal(
        one[k].reshape(-1).view(np.uint8), zero[k].reshape(-1).view(np.uint8))]
    assert not differ, differ


def test_nccl_dist_ba_matches_gloo(tmp_path):
    """`dryrun_multicard`'s GBA problem with the points perturbed and 0.5 px
    of noise, over 2 NCCL ranks on cuda:0 and cuda:1 against 2
    gloo ranks sharing cuda:0: poses, points and chi2 within 1e-5
    (relative for points and chi2; float64 reduces in another order)."""
    _cards()
    from eao_fusion_tpu_torch.apps import dryrun_multicard as DM
    a = DM.dist_ba_problem(8)                 # 256 points
    r = np.random.default_rng(3)
    a["prob_pt_xyz"] = (a["prob_pt_xyz"]
                        + r.normal(0, 0.02, a["prob_pt_xyz"].shape)
                        ).astype(np.float32)
    a["prob_obs_uv"] = (a["prob_obs_uv"]
                        + r.normal(0, 0.5, a["prob_obs_uv"].shape)
                        ).astype(np.float32)
    np.savez(tmp_path / "noisy.npz", **a)
    base = dict(name="noisy", cam=list(DM.CAM), n_iters1=3, n_iters=3)
    runs = {"gloo": ["cuda:0", "cuda:0"], "nccl": ["cuda:0", "cuda:1"]}
    for backend, devices in runs.items():
        W.join_ranks(W.start_ranks(
            W.job_dist_ba_cards, 2, tmp_path,
            dict(base, backend=backend, devices=devices, tag=backend),
            group=False), timeout=300.0)
    g = dict(np.load(tmp_path / "noisy_gloo.npz"))
    c = dict(np.load(tmp_path / "noisy_nccl.npz"))
    assert np.abs(c["cam_pose"] - g["cam_pose"]).max() < 1e-5
    assert (np.abs(c["pt_xyz"] - g["pt_xyz"])
            / np.maximum(np.abs(g["pt_xyz"]), 1.0)).max() < 1e-5
    assert abs(float(c["chi2"]) - float(g["chi2"])) <= \
        1e-5 * abs(float(g["chi2"]))
    assert np.abs(c["pl_coeff"] - g["pl_coeff"]).max() < 1e-5
