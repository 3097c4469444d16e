"""Each kernel's cost function against counts by hand at the
configurations' shapes (M = 1024 keypoint slots, Q = 8 plane slots, 4
rounds; C = 32 window cameras, Pw = 2048 points, E = 8192 edges; D = 192),
and the launch-argument readers on arguments laid out as the port's
wrappers lay them out."""

import ctypes

import pytest

from benchmark.costs import (_edge, ba_edge_chi2, ba_edge_full, chol_solve,
                             pose_opt)
from benchmark.harness import peaks


def test_pose_opt():
    args = [0] * 27
    args[6], args[10], args[16] = 1024, 8, 4
    sh = pose_opt.shapes(args)
    assert sh == dict(M=1024, Q=8, rounds=4)
    nbytes, flops = pose_opt.cost(sh)
    # pose 28 in; 1024 x (12 + 8 + 4 + 4 + 1); 8 x (16 + 16 + 1); pose 28,
    # 1024 inlier bytes, n_inliers and chi2 8 out
    assert nbytes == 28 + 29696 + 264 + 28 + 1024 + 8
    # 1024 x (4 x 320 + 5 x 40) + 8 x (4 x 200 + 5 x 30)
    assert flops == 1024 * 1480 + 8 * 950


class _Args(ctypes.Structure):
    _fields_ = ([(f"p{i}", ctypes.c_void_p) for i in range(15)]
                + [(n, ctypes.c_int) for n in ("C", "Pw", "E")]
                + [(f"f{i}", ctypes.c_float) for i in range(7)])


@pytest.fixture
def edge_args():
    a = _Args(C=32, Pw=2048, E=8192)
    return a, ctypes.addressof(a)


def test_ba_edge_full(edge_args):
    _, addr = edge_args
    sh = ba_edge_full.shapes([addr, 0, 0, 0])
    assert sh == dict(C=32, Pw=2048, E=8192)
    nbytes, flops = ba_edge_full.cost(sh)
    # cameras 32 x 28, points 2048 x 12, flags 32 x 4; per edge 28 in, 4
    # target, 72 of Y out; sums (32 x 42 + 2048 x 12) x 4 out
    assert nbytes == 896 + 24576 + 128 + 8192 * 104 + 103680
    assert flops == 8192 * 654


def test_ba_edge_chi2(edge_args):
    _, addr = edge_args
    summed = ba_edge_chi2.shapes([addr, 0, 0, 0, 1234, None])
    per_edge = ba_edge_chi2.shapes([addr, 0, 0, 0, None, 5678])
    assert summed["summed"] and not per_edge["summed"]
    assert ba_edge_chi2.cost(summed) == (896 + 24576 + 8192 * 28 + 4,
                                         8192 * 91)
    assert ba_edge_chi2.cost(per_edge) == (896 + 24576 + 8192 * 40,
                                           8192 * 90)


def test_edge_reader_refuses_what_is_not_a_size():
    a = _Args(C=0, Pw=2048, E=8192)
    assert _edge.read(ctypes.addressof(a)) is None
    assert ba_edge_full.shapes([ctypes.addressof(a)]) is None


def test_chol_solve():
    sh = chol_solve.shapes([0, 0, 0, 192, 99000])
    nbytes, flops = chol_solve.cost(sh)
    assert nbytes == 4 * (192 * 193 // 2 + 2 * 192)
    assert flops == 192 ** 3 / 3 + 2 * 192 ** 2


def test_bounds():
    # K1 at its shapes is bound by its operations, K2 by its bytes
    nb, fl = pose_opt.cost(dict(M=1024, Q=8, rounds=4))
    assert peaks.bound_s(nb, fl) == fl / peaks.F32_FLOP_PER_S
    nb, fl = ba_edge_full.cost(dict(C=32, Pw=2048, E=8192))
    assert peaks.bound_s(nb, fl) == nb / peaks.HBM_BYTES_PER_S
    assert abs(peaks.bound_s(nb, fl) - 2.929e-7) < 1e-9
