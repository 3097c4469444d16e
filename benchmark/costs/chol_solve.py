"""K4, `csrc/chol_solve.cu`: the Cholesky solve of the reduced camera
system. Launch arguments: M, rhs, x, D, the shared-memory bytes. Bytes:
M's lower triangle and b in, x out. Operations: the factorisation's D³/3
and the two triangular solves' 2D²."""

TRACE_NAME = "chol_solve_kernel"


def shapes(args) -> dict:
    return dict(D=int(args[3]))


def cost(sh: dict):
    D = sh["D"]
    return 4 * (D * (D + 1) // 2 + 2 * D), D ** 3 / 3 + 2 * D * D
