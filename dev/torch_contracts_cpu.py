"""The contracts of `chip_smoke.py` phases 25, 28 and 29 on the CPU:
endurance, exploration, crowded retrieval, forward and depth-noise
odometry, from the same definitions (tests/torch_contracts.py,
tests/torch_retrieval_harness.py). Their inputs are not in the renderer's
cache, so they have no `slow` twin; this gives their values on the CPU
(PERF.md §6, "Port, CPU") and finds a wrong path before a chip call.
Times from it are CPU times, not the card's.

    python dev/torch_contracts_cpu.py [--cache-dir DIR] [contract ...]

Contracts: endurance, exploration, crowded_retrieval, odometry (all by
default). The noiseless inputs render in one pool of 8 processes into
DIR (build/synth_cache by default); the 506-frame endurance run takes
about 5 minutes on 4 threads. Exits non-zero if a bound is missed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CONTRACTS = ("endurance", "exploration", "crowded_retrieval", "odometry")


def drive(cfg, seq):
    from eao_fusion_tpu_torch.pipeline.system import System
    s = System(cfg, device="cpu")
    for f in seq.frames:
        s.process_frame(f.gray, f.depth, f.timestamp)
    return s


def main(argv) -> int:
    import torch

    from eao_fusion_tpu_torch.io import synthetic
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache-dir", default=cs.SYNTH_CACHE)
    ap.add_argument("contracts", nargs="*")
    args = ap.parse_args(argv)
    names = args.contracts or list(CONTRACTS)
    if set(names) - set(CONTRACTS):
        ap.error(f"contracts are {', '.join(CONTRACTS)}")
    torch.set_num_threads(4)
    C = cs._tests_module("torch_contracts")
    H = cs._tests_module("torch_retrieval_harness")
    specs = {"endurance": [C.ENDURANCE_SPEC],
             "exploration": [C.EXPLORATION_SPEC],
             "odometry": [C.FORWARD_SPEC],
             "crowded_retrieval": H.scene_specs()}
    seqs = synthetic.render_sequences(
        [spec for n in names for spec in specs[n]], workers=8,
        cache_dir=args.cache_dir)
    for name in names:
        t = time.perf_counter()
        mine, seqs = seqs[:len(specs[name])], seqs[len(specs[name]):]
        if name == "endurance":
            s = drive(C.endurance_cfg(), mine[0])
            out = dict(C.check_endurance(s, mine[0]), **C.occupancy(s),
                       bow_rows_checked=C.check_bow_rows(s))
        elif name == "exploration":
            s = drive(C.exploration_cfg(), mine[0])
            out = dict(C.check_exploration(s, mine[0]), **C.occupancy(s),
                       bow_rows_checked=C.check_bow_rows(s))
        elif name == "crowded_retrieval":
            out = H.measure_retrieval(H.build_retrieval_db(mine))
            H.check_floors(out)
        else:
            arc = C.depth_noise_arc()
            out = {tag: C.check_odometry(drive(C.odometry_cfg(), q), q, b)
                   for tag, q, b in (("forward", mine[0], 0.03),
                                     ("depth noise", arc, 0.05))}
        out["cpu_wall_s"] = time.perf_counter() - t
        cs.log(f"{name} (CPU): " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
