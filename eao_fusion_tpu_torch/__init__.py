"""PyTorch / CUDA port of the object-level SLAM engine `eao_fusion_tpu`.

Each module mirrors the JAX module at the same relative path. The JAX
package is the reference; this package imports `torch`, numpy and scipy only.

Solver math stays in full f32 (the JAX package pins its matmul precision
in `eao_fusion_tpu/ops/precision.py`): TF32 is switched off for matmuls
and cuDNN on import.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the current card unless the
    caller names another. A card is always indexed (`cuda` becomes
    `cuda:{current}`), so that every thread that works for the entry point
    can enter it: a new thread starts on card 0. With no card present and
    no device named this raises; there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
