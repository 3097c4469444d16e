"""Which of the distributed GBA's tensor ops give other bits when their
batch is split in two, on the card: each op on a full batch against the
same op on its two halves (put back together), random float32 data at the
full-width GBA's sizes (E = 7872 observations, P = 16384 points, 6·C =
1536 camera rows). An op that differs makes the GBA's result depend on the
number of ranks.

    python3 dev/torch_shard_invariance.py [--device cuda]
"""

import argparse
import json

import torch


def split_cat(fn, out_dim, xs, dims):
    """fn on the two halves of every x (x split along its dim),
    concatenated along out_dim."""
    n = xs[0].shape[dims[0]]
    a = fn(*(x.narrow(d, 0, n // 2) for x, d in zip(xs, dims)))
    b = fn(*(x.narrow(d, n // 2, n - n // 2) for x, d in zip(xs, dims)))
    return torch.cat([a, b], out_dim)


def explicit3(a, b):
    """Σ_j a[..., j] b[..., j] over a last axis of 3, as three products and
    two adds (elementwise kernels, the same bits for any batch)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    g = torch.Generator(device="cpu").manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g).to(dev)
    E, P, X = 7872, 16384, 1536
    R, pw, dproj, dxc = r(E, 3, 3), r(E, 3), r(E, 3, 3), r(E, 3, 6)
    J, w = r(E, 3, 6), r(E)
    A2, H, t = r(X, P, 3), r(P, 3, 3), r(P, 3)
    dc = r(X)
    # name: (fn, inputs, the dim each is split along, the output's dim)
    ops = {
        "einsum eij,ej->ei (E)": (lambda R, p: torch.einsum(
            "eij,ej->ei", R, p), (R, pw), (0, 0), 0),
        "bmm dproj @ dxc (E)": (lambda a, b: a @ b, (dproj, dxc), (0, 0), 0),
        "einsum eri,e,erj->eij (E)": (lambda j, w: torch.einsum(
            "eri,e,erj->eij", j, w, j), (J, w), (0, 0), 0),
        "explicit eri,e,erj->eij (E)": (lambda j, w: explicit3(
            (j * w[:, None, None]).transpose(1, 2)[:, :, None, :],
            j.transpose(1, 2)[:, None, :, :]), (J, w), (0, 0), 0),
        "einsum xpj,pjk->xpk (P)": (lambda a, h: torch.einsum(
            "xpj,pjk->xpk", a, h), (A2, H), (1, 0), 1),
        "explicit xpj,pjk->xpk (P)": (lambda a, h: explicit3(
            a[:, :, None, :], h.transpose(1, 2)[None]), (A2, H), (1, 0), 1),
        "einsum pij,pj->pi (P)": (lambda h, t: torch.einsum(
            "pij,pj->pi", h, t), (H, t), (0, 0), 0),
        "explicit pij,pj->pi (P)": (lambda h, t: explicit3(
            h, t[:, None, :]), (H, t), (0, 0), 0),
        "gemv dc @ A2 f32 (P)": (lambda a: (dc @ a.reshape(X, -1)).reshape(
            -1, 3), (A2,), (1,), 0),
        "gemv dc @ A2 f64 (P)": (lambda a: (dc.double() @ a.reshape(
            X, -1).double()).float().reshape(-1, 3), (A2,), (1,), 0),
    }
    out = {}
    for name, (fn, xs, dims, out_dim) in ops.items():
        full = fn(*xs)
        halves = split_cat(fn, out_dim, xs, dims)
        out[name] = {"differ": (full != halves).sum().item(),
                     "of": full.numel(),
                     "max_abs": (full - halves).abs().max().item()}
    # the f64 sum of the shards' f64 GEMMs against the f64 GEMM of all
    AH = r(X, P * 3)
    S = (AH.double() @ A2.reshape(X, -1).double().T)
    S2 = (AH[:, :P * 3 // 2].double() @ A2.reshape(X, -1)[
        :, :P * 3 // 2].double().T) + (AH[:, P * 3 // 2:].double()
                                       @ A2.reshape(X, -1)[
                                           :, P * 3 // 2:].double().T)
    out["f64 gemm, shards summed, rounded to f32"] = {
        "differ": (S.float() != S2.float()).sum().item(), "of": S.numel()}
    print(json.dumps({"device": str(dev), **(
        {"name": torch.cuda.get_device_name(0)} if dev.type == "cuda"
        else {}), "ops": out}, indent=1))


if __name__ == "__main__":
    main()
