"""The port's counterpart of tests/test_weakscale_guards.py for
`parallel/dist_ba.py`: the inputs of the weak-scaling model of the
distributed GBA at the production shape (C = 256 keyframes, P = 16384
points, N = 1024 keypoint slots; test_ba.make_ba_problem's problem with
sampled observations, as the JAX file builds it).

(a) the observation partition's balance over 8 ranks; (b) the all-reduce
payload of an LM iteration, every call of `dist_ba._all_sum` counted in a
1-rank gloo group (a spawned process, tests/torch_dist_worker.py): the
camera system and its rhs, exactly (36 C^2 + 6 C) float64 values, one value
for each chi2, and the point table once a solve; (c) in place of XLA's FLOP
count, which torch has no counterpart of, each rank's observation count at
8 ranks against 1 rank's."""

import json
import os

import numpy as np
import pytest
import torch

from eao_fusion_tpu_torch.parallel import dist_ba
from eao_fusion_tpu_torch.solvers import ba as TB
from test_ba import CAM, make_ba_problem
import torch_dist_worker as W

C, P_PTS, N = 256, 16384, 1024


def _problem(n_cams, n_pts, n_slots):
    prob, _, _ = make_ba_problem(np.random.default_rng(0), n_cams=n_cams,
                                 n_pts=n_pts, n_slots=n_slots, noise_px=0.3,
                                 sample_obs=True)
    return TB.BAProblem(*(torch.as_tensor(np.array(getattr(prob, k)))
                          for k in TB.BAProblem._fields))


@pytest.fixture(scope="module")
def production():
    return _problem(C, P_PTS, N)


def _valid_per_rank(prob, n):
    return dist_ba.partition_observations(prob, n).valid.sum(1).numpy()


def test_partition_balance(production):
    """(a) Over 8 ranks the busiest holds at most 1.02 times the mean
    observation count, and no observation is lost."""
    per = _valid_per_rank(production, 8)
    assert per.max() / per.mean() <= 1.02, per
    assert per.sum() == int(production.obs_valid.sum())


def test_per_rank_work_scales(production):
    """(c) Each of 8 ranks computes residuals and Jacobians for at most a
    sixth of the observations that 1 rank does (the JAX guard's FLOP ratio
    of at least 6)."""
    one = _valid_per_rank(production, 1)
    eight = _valid_per_rank(production, 8)
    assert one.shape == (1,) and eight.shape == (8,)
    assert eight.max() * 6 <= one[0], (eight, one)


@pytest.mark.parametrize("n_cams,n_pts,n_slots,n_iters", [
    pytest.param(C, P_PTS, N, 1, id="production"),
    pytest.param(16, 1024, 256, 2, id="small")])
def test_allreduce_payload_matches_model(tmp_path, n_cams, n_pts, n_slots,
                                         n_iters):
    """(b) The calls of `_all_sum` in one phase of `n_iters` LM iterations,
    in order: the first chi2 (one float64), then per iteration the camera
    system S with its rhs, exactly (36 C^2 + 6 C) float64 values
    (18,886,656 bytes at C = 256), and the candidate's chi2 (one float64);
    last the point table, P x 3 float32 (196,608 bytes at P = 16384).
    Nothing else crosses the ranks."""
    W.save_problem(tmp_path / "prob.npz", _problem(n_cams, n_pts, n_slots))
    W.join_ranks(W.start_ranks(W.job_allreduce_payload, 1, tmp_path,
                               dict(name="prob", cam=list(CAM),
                                    n_iters=n_iters)))
    calls = [tuple(c) for c in json.load(open(tmp_path
                                              / "prob_payload.json"))]
    s_values = 36 * n_cams ** 2 + 6 * n_cams
    chi2 = ("torch.float64", 1, 8)
    system = ("torch.float64", s_values, 8 * s_values)
    points = ("torch.float32", 3 * n_pts, 12 * n_pts)
    assert calls == [chi2] + [system, chi2] * n_iters + [points], calls
    if n_cams == C:
        assert system[2] == 18_886_656 and points[2] == 196_608
