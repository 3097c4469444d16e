"""K3, `csrc/ba_edge.cu` `ba_edge_chi2_kernel`: the robust chi2 of every
edge, summed (the LM accept test; the sum pointer, the launch's fifth
argument, is set) or written per edge (robust, raw, behind: the outlier
gate). Bytes: the cameras, the points and each edge's inputs, and one
float out, or three an edge. Operations: 90 an edge, one more for the
sum."""

from . import _edge as a

TRACE_NAME = "ba_edge_chi2_kernel"


def shapes(args):
    s = a.read(int(args[0]))
    if s is None:
        return None
    return dict(zip(("C", "Pw", "E"), s), summed=args[4] is not None)


def cost(sh: dict):
    C, Pw, E = sh["C"], sh["Pw"], sh["E"]
    base = a.cams_pts_bytes(C, Pw)
    if sh["summed"]:
        return base + E * a.EDGE_IN + 4, E * 91
    return base + E * (a.EDGE_IN + 3 * 4), E * 90
