"""K1, `csrc/pose_opt.cu`: one frame's pose solve in one launch.

Launch arguments (`solvers/pose_opt.optimize_pose_cuda`): pose0, the five
observation pointers, M, the three plane pointers, Q, fx fy cx cy bf, the
rounds, the iterations a round, five gates, four output pointers.

Bytes: the pose in; per observation slot pts_w, uv, uright, 1/σ² (7
floats) and valid (1 byte); per plane slot plane_w, meas_c (8 floats) and
valid; out the pose, the inlier bytes, n_inliers and chi2. Operations: a
Gauss-Newton iteration is 320 a point observation (projection, residual,
Huber weight, 3x6 Jacobian, the 21 + 6 sums) and 200 a plane slot; a chi2
pass 40 and 30. The early exit can end a round after one iteration, and
what a call ran is not visible at its launch, so the count is that least
schedule: one iteration and one chi2 pass a round, and the final chi2
pass. The share it gives is a floor."""

TRACE_NAME = "pose_opt_kernel"
OBS_ITER, OBS_CHI2 = 320, 40
PLANE_ITER, PLANE_CHI2 = 200, 30


def shapes(args) -> dict:
    return dict(M=int(args[6]), Q=int(args[10]), rounds=int(args[16]))


def cost(sh: dict):
    M, Q, rounds = sh["M"], sh["Q"], sh["rounds"]
    nbytes = 7 * 4 + M * 29 + Q * 33 + 7 * 4 + M + 8
    flops = (M * (OBS_ITER * rounds + OBS_CHI2 * (rounds + 1))
             + Q * (PLANE_ITER * rounds + PLANE_CHI2 * (rounds + 1)))
    return nbytes, flops
