"""The sync-free forms that let local mapping run as CUDA graphs
(`utils/graphs`), on the CPU: the LM phase with its carry on the device
against the host loop, bit for bit; `put_last` against the masked
assignment it replaces; fusion with gated-out neighbours and a repeated
loser against the JAX package; and the whole step with its stages
replayed as a CUDA graph replays them (the tensors of the first call)
against the step run afresh, keyframe by keyframe."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eao_fusion_tpu.config import MapCapacity, ORBConfig, SystemConfig
from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu.pipeline import local_mapping as JLM
from eao_fusion_tpu.pipeline.system import System as JSystem
from eao_fusion_tpu_torch import config as TC
from eao_fusion_tpu_torch.mapping import map_state as TMS
from eao_fusion_tpu_torch.ops.scatter import put_last
from eao_fusion_tpu_torch.pipeline import local_mapping as TLM
from eao_fusion_tpu_torch.solvers import ba as TB
from eao_fusion_tpu_torch.utils import graphs

FTOL = 1e-3


# ---------------------------------------------------------------- LM phase

def _lm_case(kind: str):
    """(x0, cost, step, iters) of a small least-squares problem whose host
    loop stops after two stalls, rejects steps, or meets a non-finite
    cost. `step(x, lam)` reads lam as a float32 tensor, so that the host
    loop's float and the device carry give the same bits."""
    r = np.random.default_rng({"stalls": 0, "rejects": 1, "nonfinite": 2}[kind])
    A = torch.from_numpy(r.normal(size=(12, 4)).astype(np.float32))
    b = torch.from_numpy(r.normal(size=12).astype(np.float32))
    x0 = torch.from_numpy(r.normal(size=4).astype(np.float32)) * 3.0

    def resid(x):
        res = A @ x - b
        return res + 0.3 * torch.sin(3.0 * x).repeat(3) if kind != "stalls" \
            else res

    def cost(x):
        res = resid(x)
        return torch.sum(res * res)

    def step(x, lam):
        lam = torch.as_tensor(lam, dtype=torch.float32)
        g = A.T @ resid(x)
        H = A.T @ A + lam * torch.eye(4)
        dx = torch.linalg.solve(H, g)
        if kind == "rejects":
            dx = dx * 4.0                       # overshoots until lam grows
        if kind == "nonfinite":
            dx = dx / (lam - 1e-3)              # inf at the first damping
        return x - dx

    return x0, cost, step, 12


def _host_costs(x0, cost, step, iters):
    """The host loop's answer and its candidates' costs, in order."""
    seen = []

    def counted(st):
        c = cost(st[0])
        seen.append(float(c))
        return c
    out = TB._lm_phase((x0,), counted, lambda st, lam: (step(st[0], lam),),
                       iters, 1e-3, FTOL)
    return out[0], seen


class _Replayed(graphs.Workspace):
    """A workspace whose stages, at every call after their first, run the
    closure of their first call: what a CUDA graph replays, the work on
    the tensors it was captured with (a stage that reads a tensor of its
    call in place of the workspace's reads the first call's). As on a
    card, every LM iteration runs and the fields are cloned out."""

    def __init__(self, device):
        super().__init__(device)
        self.graphs_on = True

    def run(self, name, fn):
        self._graphs.setdefault(name, fn)()


@pytest.mark.parametrize("replayed", [False, True])
@pytest.mark.parametrize("kind", ["stalls", "rejects", "nonfinite"])
def test_lm_phase_on_the_device_matches_the_host_loop(kind, replayed):
    """`_lm_phase_device` gives the host loop's state, bit for bit: with
    the loop left once done (the CPU's) and with every iteration run,
    masked once done, its stages replayed (a card's); and each problem
    does what it is named for."""
    x0, cost, step, iters = _lm_case(kind)
    want, costs = _host_costs(x0, cost, step, iters)
    cur, rejected = costs[0], 0
    for c in costs[1:]:
        if c < cur and np.isfinite(c):
            cur = c
        else:
            rejected += 1
    if kind == "stalls":
        assert len(costs) - 1 < iters           # two stalls ended it early
    elif kind == "rejects":
        assert rejected >= 1
    else:
        assert not np.isfinite(costs[1])

    ws = (_Replayed if replayed else graphs.Workspace)("cpu")
    steps = []

    def dev_step(st, lam):
        steps.append(1)
        return (ws.put("cand", step(st[0], lam)),)
    state = (ws.put("x", x0),)
    TB._lm_phase_device(ws, state, lambda st: ws.put("c", cost(st[0])),
                        dev_step, iters, 1e-3, FTOL)
    assert torch.equal(state[0], want)
    assert len(steps) == (iters if replayed else len(costs) - 1)
    if len(costs) - 1 < iters:
        assert bool(ws.lm_done)


# ---------------------------------------------------------------- put_last

def _put_masked(out, idx, vals):
    """The masked form `put_last` had: its mask indexing reads the host."""
    idx = idx.long()
    pos = torch.arange(idx.shape[0])
    last = torch.full((out.shape[0],), -1, dtype=torch.int64).scatter_reduce(
        0, idx, pos, "amax")
    keep = last[idx] == pos
    out[idx[keep]] = vals[keep]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_put_last_matches_the_masked_form(seed):
    """Equal indices (most of them repeat), rows of a table and entries of
    a redirect with a spare slot, and no update at all."""
    r = np.random.default_rng(seed)
    out = torch.from_numpy(r.normal(size=(50, 3)).astype(np.float32))
    idx = torch.from_numpy(r.choice(r.choice(50, 9, replace=False), 300))
    vals = torch.from_numpy(r.normal(size=(300, 3)).astype(np.float32))
    assert torch.equal(put_last(out.clone(), idx, vals),
                       _put_masked(out.clone(), idx, vals))
    ident = torch.arange(65)
    lose = torch.from_numpy(np.where(r.random(200) < 0.5,
                                     r.integers(0, 8, 200), 64))
    win = torch.where(lose < 64, torch.from_numpy(r.integers(8, 64, 200)),
                      64)
    got = put_last(ident.clone(), lose, win)
    assert torch.equal(got, _put_masked(ident.clone(), lose, win))
    assert int(got[64]) == 64
    empty = torch.zeros(0, dtype=torch.int64)
    assert torch.equal(put_last(out.clone(), empty, vals[:0]), out)


# ------------------------------------------------------------------ fusion

def _cfgs():
    kw = dict(use_planes=False, use_objects=False, use_loop_closing=False)
    j = SystemConfig(orb=ORBConfig(n_features=500, max_keypoints=512),
                     capacity=MapCapacity(max_keyframes=64, max_points=4096),
                     **kw)
    t = TC.SystemConfig(orb=TC.ORBConfig(n_features=500, max_keypoints=512),
                        capacity=TC.MapCapacity(max_keyframes=64,
                                                max_points=4096), **kw)
    return j, t


@pytest.fixture(scope="module")
def warm():
    """The JAX System's map after 6 frames of the seed-0 arc (rendered
    here and kept in memory only), as numpy arrays, and its MapState
    type."""
    jcfg, _ = _cfgs()
    seq = synthetic.generate_sequence(n_frames=20, seed=0, style="arc")
    s = JSystem(jcfg)
    for f in seq.frames[:6]:
        s.process_frame(f.gray, f.depth, f.timestamp)
    assert s.n_keyframes >= 3
    return jax.tree.map(np.asarray, s.map)._asdict(), type(s.map)


def _with_duplicates(d: dict, slot: int, n: int = 40) -> dict:
    """The map with n points that the new keyframe `slot` shares with an
    older keyframe split in two: the new keyframe observes a copy in a
    free slot. Fusion merges each copy back from both directions of every
    pair that passes the gate (a loser repeated across pairs)."""
    d = {k: v.copy() for k, v in d.items()}
    kf_pt, valid = d["kf_pt_idx"], d["kf_valid"]
    own = kf_pt[slot][kf_pt[slot] >= 0]
    others = kf_pt[valid & (np.arange(len(valid)) != slot)]
    shared = np.intersect1d(own, others[others >= 0])[:n]
    base = int(d["next_pt"])
    for i, p in enumerate(shared):
        q = base + i
        for k in d:
            if k.startswith("pt_"):
                d[k][q] = d[k][p]
        kf_pt[slot][kf_pt[slot] == p] = q
        d["obs_ind"][slot, p] = False
        d["obs_ind"][slot, q] = True
    d["next_pt"] = np.asarray(base + len(shared), d["next_pt"].dtype)
    return d, np.arange(base, base + len(shared))


def test_fuse_with_gated_out_neighbours_and_repeated_losers_matches_jax(warm):
    """A young map (few keyframes, so most of the 10 neighbour slots fail
    the gate and run masked) with duplicated points: the port's fusion
    gives the JAX package's observations, validity and indicator exactly,
    and merges the copies."""
    jcfg, tcfg = _cfgs()
    d0, jmap = warm
    slot = int(d0["next_kf"]) - 1
    d, copies = _with_duplicates(d0, slot)
    assert len(copies) >= 10
    Z = (d["obs_ind"] & d["kf_valid"][:, None]).astype(np.float32)
    covis = Z @ Z.T
    gate = (covis[slot] > 15) & d["kf_valid"]
    gate[slot] = False
    assert 1 <= gate.sum() < tcfg.capacity.fuse_neighbors

    mj = JLM.fuse_neighbors(jmap(**{k: jnp.asarray(v) for k, v in
                                    d.items()}), jnp.int32(slot), cfg=jcfg)
    mt = TLM.fuse_neighbors(TMS.from_numpy(d, "cpu"), slot, cfg=tcfg)
    for k in ("kf_pt_idx", "pt_valid", "obs_ind"):
        np.testing.assert_array_equal(getattr(mt, k).numpy(),
                                      np.asarray(getattr(mj, k)), err_msg=k)
    merged = ~mt.pt_valid.numpy()[copies]
    assert merged.sum() >= len(copies) // 2


# ------------------------------------------------- stages as graphs replay

def test_stages_replayed_from_the_first_keyframe_match_fresh_steps(
        warm, monkeypatch):
    """Keyframes of a young map, each stepped twice: afresh, and as on a
    card, through workspaces kept across keyframes whose stages replay
    their first call (every fusion pair and LM iteration run, masked,
    the fields cloned out): the three newest keyframe slots of the map,
    then the newest on the map with duplicated points. Every map field
    and local BA's answer are the same bits."""
    _, tcfg = _cfgs()
    d0, _ = warm
    slot = int(d0["next_kf"]) - 1
    bundle_adjust = TLM.ba.bundle_adjust_coo
    kept, answers = {}, []
    replayed = lambda key, device: kept.setdefault(key, _Replayed(device))

    def spy(prob, plane_block=None, **kw):
        res = bundle_adjust(prob, plane_block, **kw)
        answers.append(res)
        return res

    monkeypatch.setattr(TLM.ba, "bundle_adjust_coo", spy)
    maps = [(d0, slot - i) for i in range(3)]
    maps.append((_with_duplicates(d0, slot)[0], slot))
    for d, k in maps:
        m = TMS.from_numpy(d, "cpu")
        fresh = TLM.local_mapping_step(m, k, cfg=tcfg)
        with monkeypatch.context() as mp:
            mp.setattr(graphs, "workspace", replayed)
            mp.setattr(graphs, "enabled", lambda device: True)
            out = TLM.local_mapping_step(m, k, cfg=tcfg)
        res_r, res_f = answers.pop(), answers.pop()
        for f in TMS.MapState._fields:
            assert torch.equal(getattr(out, f), getattr(fresh, f)), (k, f)
        for f, a, b in zip(res_r._fields, res_r[:4], res_f[:4]):
            assert torch.equal(a, b), (k, f)
    assert len(kept) == 2
