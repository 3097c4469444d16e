"""Run `chip_smoke.py`'s phase 24 alone on the card: the kernels' build,
then the map-sharded steady step (the unsharded step, 2 and 4 gloo ranks
sharing the card, 1 NCCL rank, all on the same handed-over state).

    python3 dev/torch_sharded_phase.py

Exits non-zero if the phase fails; its JSON line is the phase's record.
"""

import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from eao_fusion_tpu_torch import kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cs.log(smi)
    try:
        t0 = time.perf_counter()
        kernels.build_all()
        cs.phase_sharded_step(smi.splitlines()[0] if smi else "")
    except Exception:
        traceback.print_exc()
        return 1
    cs.log(f"phase 24: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
