"""The local-BA kernels' share of their roofline over the traced span:
K2, K3 and K4 together (`solvers/ba_edge.py`, `solvers/chol.py` ->
`csrc/ba_edge.cu`, `csrc/chol_solve.cu`), Σ bound / Σ device time, the
bounds counted in `benchmark/costs/` from each launch's shapes."""

from benchmark.harness import roofline


def read(run: dict):
    return roofline.share_pct(run, ("ba_edge_full", "ba_edge_chi2",
                                    "chol_solve"))
