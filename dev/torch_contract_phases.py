"""Run `chip_smoke.py`'s phases 25-29 alone on the card: the kernels'
build, the pooled render of their inputs, then the JAX package's long-run
and sensor-robustness contracts (lifecycle, compaction and culling, the
nuisance suite, crowded retrieval, odometry).

    python3 dev/torch_contract_phases.py [phase ...]

With names (`lifecycle`, `compaction_culling`, `nuisance`,
`crowded_retrieval`, `odometry`) it runs only those, in that order.
Exits non-zero if a phase fails.
"""

import os
import subprocess
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

PHASES = ("lifecycle", "compaction_culling", "nuisance",
          "crowded_retrieval", "odometry")


def main(names) -> int:
    from eao_fusion_tpu_torch import kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    smi_line = smi.splitlines()[0] if smi else ""
    cs.log(smi_line)
    t0 = time.perf_counter()
    try:
        kernels.build_all()
        for name in names or PHASES:
            getattr(cs, f"phase_{name}")(smi_line)
    except Exception:
        traceback.print_exc()
        return 1
    cs.log(f"phases {', '.join(names or PHASES)}: "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
