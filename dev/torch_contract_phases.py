"""Run `chip_smoke.py`'s phases 25-29 and 31 alone on the card: the
kernels' build, the pooled render of their inputs, then the JAX package's
long-run and sensor-robustness contracts (lifecycle, compaction and
culling, the nuisance suite, crowded retrieval, odometry) and the kidnap
contract (phase 31, which drives on phase 25b's System).

    python3 dev/torch_contract_phases.py [phase ...]

With names (`lifecycle`, `compaction_culling`, `nuisance`,
`crowded_retrieval`, `odometry`, `kidnap`) it runs only those, in that
order; `kidnap` without `lifecycle` runs phase 25b's exploration first.
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
          "crowded_retrieval", "odometry", "kidnap")


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
        handed = {}
        for name in [p for p in PHASES if p in (names or PHASES)]:
            if name == "lifecycle":
                cs.phase_lifecycle(smi_line, keep=handed)
            elif name == "kidnap":
                s = handed.pop("exploration", None)
                cs.phase_kidnap(smi_line, s,
                                None if s is None else cs._contract_inputs())
            else:
                getattr(cs, f"phase_{name}")(smi_line)
    except Exception:
        traceback.print_exc()
        return 1
    cs.log(f"phases {', '.join(names or PHASES)}: "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
