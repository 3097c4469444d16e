"""Find where two runs of the port in one process part, in two ways.

`trace` (the default) runs the workload twice under a TorchDispatchMode
that reduces every aten operation's output on its device to one checksum
(its bits, position-weighted). The first run keeps the sequence of
(operation, checksum); the second compares as it goes and stops at the
first operation whose name or output checksum differs, printing it with
the Python stack that called it and whether its inputs (tensors and
scalars) had the same checksums in both runs: if they had, the operation
itself gave other bits; if not, an input came from outside the aten
operations. Allocations (`empty` and its kin) are not compared, since
their contents are whatever the allocator hands out: each run fills them
with a value of its own (0, then 77), so that a read of memory nothing
wrote shows where it is read. Views are not compared either; their bits
are checked where an operation reads them. The hand-written kernels are
not aten operations: an output one of them writes shows at the first
operation that reads it. Three untraced frames come first, so that what
the port caches at first use exists in both runs. The check synchronizes
the card after every operation, so it cannot see a result that depends on
how threads race inside one operation; `scatters` looks for those.

`scatters` runs the workload once and counts, by the port's call site,
the scatters whose result depends on the order in which equal indices
are applied: an assignment (`index_put_` without accumulation, `scatter`
with a source) that writes one index twice with different values (on the
card, whichever thread writes last wins), and a float scatter-add
(`index_add_`, `scatter_add_`, `scatter_reduce` sum, accumulating
`index_put_`) of non-integer values into one index twice (a float sum
depends on its order). A site that parks masked entries in a sink row
the caller then drops is listed too; read each site.

The workload is the endurance contract's input (`chip_smoke.py` phase
25a: the tour's first 506 frames into 24 keyframe slots, loop closing on,
no GBA) through `process_frame`, cut to `--frames` (160 by default);
`--fr3` takes the fr3-scale configuration (`dev/torch_run_fr3_scale.
scale_cfg`: planes, objects with the renderer's boxes) instead;
`--kidnap` takes the kidnap contract's (`chip_smoke.py` phase 31a: the
240-frame corridor at 320x240 into 24 keyframe slots, then the kidnap
and the return, 312 frames in all by default).

    python3 dev/torch_op_trace.py [--frames 160] [--fr3 | --kidnap]
    python dev/torch_op_trace.py --mode scatters --device cpu --frames 160
    python dev/torch_op_trace.py --mode scatters --device cpu --kidnap

Runs on the card unless `--device cpu` is given. The port only: no JAX.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(*parts):
    path = os.path.join(ROOT, *parts)
    spec = importlib.util.spec_from_file_location(
        "_trace_" + os.path.splitext(parts[-1])[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(x):
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _flat(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _flat(v)
    else:
        yield x


def _site() -> str:
    """The innermost frame of the port's package on the stack."""
    st = [ln for ln in traceback.format_stack(limit=40)
          if "eao_fusion_tpu_torch" in ln]
    return st[-1].strip().split("\n")[0] if st else "?"


class Parted(Exception):
    """The second run's first operation that differs from the first's."""


def make_tracer():
    """The `trace` mode's TorchDispatchMode class (torch imported here, not
    when the module is)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    allocs = {aten.empty.memory_format, aten.empty_strided.default,
              aten.new_empty.default, aten.new_empty_strided.default,
              aten.empty_like.default}
    # a resize keeps the old bits and adds unwritten ones: not compared
    unchecked = {aten.resize_.default}
    weights = {}

    def checksum(t) -> int:
        """One int of a tensor's bits (order-sensitive), or of a scalar."""
        if not isinstance(t, torch.Tensor):
            return hash(t) if isinstance(t, (int, float, bool)) else 0
        if t.numel() == 0:
            return 0
        x = t.detach().contiguous().reshape(-1)
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[x.element_size()]
        b = x.view(bits).to(torch.int64)
        key = (b.numel(), x.device)
        if key not in weights:
            w = torch.arange(1, b.numel() + 1, dtype=torch.int64,
                             device=x.device)
            weights[key] = (w * 2654435761) % 1000003 + 1
        # int64 sums wrap the same way in any order
        return int(((b % 1000000007) * weights[key]).sum())

    class Tracer(TorchDispatchMode):
        """Records (op, output checksums, input checksums) per aten call;
        with `ref`, compares and raises `Parted` at the first op whose
        name or outputs differ. Allocations are filled with `poison`."""

        def __init__(self, ref=None, poison=0):
            super().__init__()
            self.rows, self.ref, self.parted = [], ref, None
            self.poison = poison

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in allocs:
                if out.numel():
                    out.fill_(bool(self.poison) if out.dtype == torch.bool
                              else self.poison)
                return out
            if func in unchecked or any(
                    r.alias_info is not None and not r.alias_info.is_write
                    for r in func._schema.returns):
                return out
            ins = [checksum(a) for a in _flat(args)]
            row = (str(func), [checksum(o) for o in _flat(out)], ins)
            i = len(self.rows)
            self.rows.append(row)
            if self.ref is not None and self.parted is None:
                want = self.ref[i] if i < len(self.ref) else None
                if want is None or want[:2] != row[:2]:
                    self.parted = dict(
                        index=i, op=row[0], outputs=row[1],
                        first_run=None if want is None else list(want),
                        same_inputs=want is not None and want[2] == ins,
                        input_shapes=[list(a.shape) for a in _flat(args)
                                      if isinstance(a, torch.Tensor)],
                        stack=[ln for ln in traceback.format_stack(
                            limit=40)[:-1] if "site-packages" not in ln
                            and "torch_op_trace" not in ln][-12:])
                    raise Parted(self.parted)
            return out

    return Tracer


def make_scatter_check():
    """The `scatters` mode's TorchDispatchMode class; its `hits` counts
    (kind, call site)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    puts = {aten.index_put_.default, aten.index_put.default,
            aten._index_put_impl_.default}
    adds = {aten.index_add_.default, aten.index_add.default,
            aten.scatter_add_.default, aten.scatter_add.default}
    sets = {aten.scatter_.src, aten.scatter.src}
    reduces = {aten.scatter_reduce_.two, aten.scatter_reduce.two}

    def repeats(lin) -> bool:
        return lin.numel() > 1 and bool(
            (torch.unique(lin, return_counts=True)[1] > 1).any())

    def fractional(v) -> bool:
        return v.is_floating_point() and bool((v != v.round()).any())

    def put_index(shape, indices):
        """The flat index of each update of an advanced-index put, or None
        for a mask index of more than one axis."""
        lin = None
        for d, i in enumerate(indices):
            if i is None:
                continue
            if i.dtype == torch.bool:
                if i.dim() != 1:
                    return None
                i = torch.nonzero(i).reshape(-1)
            i = i.long() % shape[d]
            lin = i if lin is None else lin * shape[d] + i
        return None if lin is None else lin.reshape(-1)

    class Check(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.hits = collections.Counter()

        def hit(self, kind):
            self.hits[(kind, _site())] += 1

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in puts:
                table, indices, vals = args[:3]
                acc = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                               False)
                lin = put_index(table.shape, indices)
                if lin is not None and repeats(lin):
                    nd = sum(i is not None for i in indices)
                    v = vals.expand((lin.numel(),) + tuple(table.shape[nd:]))
                    v = v.reshape(lin.numel(), -1)
                    if acc:
                        if fractional(v):
                            self.hit("float accumulate into equal indices")
                    else:
                        o = torch.argsort(lin, stable=True)
                        ls, vs = lin[o], v[o]
                        if bool(((ls[1:] == ls[:-1])
                                 & (vs[1:] != vs[:-1]).any(1)).any()):
                            self.hit("assignment, equal indices, values "
                                     "differ")
            elif func in adds:
                table, _, index, src = args[:4]
                if table.is_floating_point() and repeats(index.reshape(-1)) \
                        and fractional(src):
                    self.hit("float add into equal indices")
            elif func in reduces:
                table, _, index, src, how = args[:5]
                if how in ("sum", "mean", "prod") and \
                        table.is_floating_point() and fractional(src):
                    self.hit(f"float scatter_reduce {how}")
            elif func in sets:
                _, dim, index, src = args[:4]
                if src.shape == index.shape:
                    i = index.movedim(dim, -1).reshape(-1, index.shape[dim])
                    s = src.movedim(dim, -1).reshape(-1, index.shape[dim])
                    o = torch.argsort(i, dim=1, stable=True)
                    ii, ss = torch.gather(i, 1, o), torch.gather(s, 1, o)
                    if bool(((ii[:, 1:] == ii[:, :-1])
                             & (ss[:, 1:] != ss[:, :-1])).any()):
                        self.hit("scatter, equal indices, values differ")
            return func(*args, **kwargs)

    return Check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("trace", "scatters"), default="trace")
    ap.add_argument("--frames", type=int, default=None)
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--fr3", action="store_true")
    group.add_argument("--kidnap", action="store_true")
    ap.add_argument("--lap-frames", type=int, default=625)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cache-dir",
                    default=os.path.join(ROOT, "build", "synth_cache"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from eao_fusion_tpu_torch.pipeline.system import System
    R = _module("dev", "torch_run_fr3_scale.py")
    C = _module("tests", "torch_contracts.py")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    if args.kidnap:
        from eao_fusion_tpu_torch.io import synthetic
        corridor = synthetic.render_sequences(
            [C.EXPLORATION_SPEC], cache_dir=args.cache_dir)[0]
        seq = C.kidnap_sequence(corridor, back=C.BACK_EXPLORATION)
        cfg = C.exploration_cfg()
        workload = "kidnap"
    else:
        seq = R.render_tour(args.lap_frames, args.cache_dir)
        cfg = R.scale_cfg() if args.fr3 else C.endurance_cfg()
        workload = "fr3" if args.fr3 else "endurance"

    def run(mode, frames):
        s = System(cfg, device=dev)
        t0 = time.perf_counter()
        n = 0
        try:
            with mode:
                for f in frames:
                    s.process_frame(f.gray, f.depth, f.timestamp,
                                    boxes=f.boxes if args.fr3 else None)
                    n += 1
        except Parted:
            pass
        return n, time.perf_counter() - t0

    frames = seq.frames[:args.frames or (None if args.kidnap else 160)]
    out = dict(mode=args.mode, workload=workload, frames=len(frames),
               device=str(dev))
    if args.mode == "scatters":
        check = make_scatter_check()()
        run(check, frames)
        out["sites"] = [dict(kind=k, site=s, calls=n)
                        for (k, s), n in check.hits.most_common()]
    else:
        Tracer = make_tracer()
        run(Tracer(), frames[:3])      # what the port caches at first use
        first = Tracer()
        _, t1 = run(first, frames)
        print(f"run 1: {len(first.rows)} operations, {t1:.1f} s",
              file=sys.stderr, flush=True)
        second = Tracer([tuple(r) for r in first.rows], poison=77)
        n2, t2 = run(second, frames)
        out.update(operations=len(first.rows), seconds=[t1, t2],
                   parted_at_frame=n2 if second.parted else None,
                   parted=second.parted)
        if second.parted:
            print("".join(second.parted["stack"]), file=sys.stderr)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
