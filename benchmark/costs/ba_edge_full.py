"""K2, `csrc/ba_edge.cu` `ba_edge_full_kernel`: one LM iteration's edge
pass and its per-camera and per-point sums.

Bytes: the cameras, the points and the free-camera flags; per edge its
inputs, the point target and the 18 floats of Y out; the [C, 42] and
[Pw, 12] sums out. The bind-time sort orders are a permutation of the
indices counted here, so the bound leaves them out. Operations: 600 an
edge (camera rotation, projection, Huber, 3x9 Jacobian, 63 Gram entries
and 9 right-hand sides) and 54 for its adds into the sums."""

from . import _edge as a

TRACE_NAME = "ba_edge_full_kernel"


def shapes(args):
    s = a.read(int(args[0]))
    return None if s is None else dict(zip(("C", "Pw", "E"), s))


def cost(sh: dict):
    C, Pw, E = sh["C"], sh["Pw"], sh["E"]
    nbytes = (a.cams_pts_bytes(C, Pw) + C * 4 + E * (a.EDGE_IN + 4 + 18 * 4)
              + (C * 42 + Pw * 12) * 4)
    return nbytes, E * (600 + 54)
