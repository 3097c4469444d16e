"""The edge-problem sizes that K2 and K3 are given: `BaEdgeArgs` of
`csrc/ba_edge.cu`, passed by address as a launch's first argument, holds
15 pointers and then C, Pw and E (int32)."""

import ctypes

_OFFSET = 15 * ctypes.sizeof(ctypes.c_void_p)


def read(addr: int):
    """(C, Pw, E) at the struct's address, or None where they are not
    sizes (a layout this reader does not know)."""
    C, Pw, E = (ctypes.c_int.from_address(addr + _OFFSET + 4 * i).value
                for i in range(3))
    if not (1 <= C <= 4096 and 1 <= Pw <= 1 << 24 and 1 <= E <= 1 << 26):
        return None
    return C, Pw, E


# bytes an edge brings in: camera and point index, uv, ur, 1/σ², active
EDGE_IN = 4 + 4 + 8 + 4 + 4 + 4


def cams_pts_bytes(C: int, Pw: int) -> int:
    return C * 7 * 4 + Pw * 3 * 4
