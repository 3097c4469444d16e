"""Run `chip_smoke.py`'s distributed phases alone on the card: the kernels'
build, phase 12 (the loop cell, whose first closure gives the GBA
problem), then phases 20-23 (the distributed GBA, the loop cell with
gba_mesh_devices = 2, data-parallel evaluation, the vocabulary trainer).

    python3 dev/torch_dist_phases.py

About a third of `chip_smoke.py`'s time; exits non-zero if a phase fails.
"""

import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from eao_fusion_tpu_torch import kernels
    try:
        t0 = time.perf_counter()
        kernels.build_all()
        loop_out, problem = cs.phase_loop()
        cs.phase_dist_ba(problem, cs._loop_cfg())
        cs.phase_loop_mesh(loop_out)
        cs.phase_eval()
        cs.phase_vocab()
    except Exception:
        traceback.print_exc()
        return 1
    cs.log(f"distributed phases: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
