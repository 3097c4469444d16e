"""K1's share of its roofline over the traced span (`solvers/pose_opt.py`
-> `csrc/pose_opt.cu`): Σ bound / Σ device time, the bound counted in
`benchmark/costs/pose_opt.py` from each launch's shapes."""

from benchmark.harness import roofline


def read(run: dict):
    return roofline.share_pct(run, ("pose_opt",))
