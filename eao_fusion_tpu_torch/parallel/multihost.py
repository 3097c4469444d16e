"""Multi-process initialization for the distributed global BA (port of
`eao_fusion_tpu/parallel/multihost.py`).

JAX forms one process group per host and lets XLA pick the transport. A
`torch.distributed` group has one process per device instead, and needs
its backend named: `nccl` when each rank has a card of its own, `gloo`
for ranks on the CPU and for several ranks that share one card (NCCL
refuses two ranks on one device; gloo's collectives on CUDA tensors copy
through the host). Rank r works on `cuda:{LOCAL_RANK}` where a launcher
sets `LOCAL_RANK` (the rank within its host), else on
`cuda:{r % device_count}`, unless the spec names its device.

The same `EAO_*` variables describe the group: `EAO_COORDINATOR`
("host:port", or an init URL such as "file:///path/store"),
`EAO_NUM_PROCESSES`, `EAO_PROCESS_ID`. Without them (or without
`EAO_MULTIHOST=1`, which reads torchrun's `MASTER_ADDR` / `RANK`
variables instead) `ensure_initialized` does nothing, so every entry
point may call it.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from eao_fusion_tpu_torch import resolve_device

# a rank that dies fails its peers' collectives after this long instead of
# hanging them; generous, since gloo moves a full-width GBA's 18.9 MB
# camera system through the host on every LM iteration (16 ms on an H100's
# host) and a serving rank waits for the next stage as long as the System
# runs between two GBAs
TIMEOUT_S = 600.0


@dataclass(frozen=True)
class MultihostSpec:
    """Explicit process-group description."""
    coordinator_address: Optional[str] = None   # "host:port" or a URL
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    backend: Optional[str] = None   # "nccl" / "gloo"; None: _default_backend
    device: Optional[str] = None    # this rank's device; None: _rank_device

    @staticmethod
    def from_env() -> "MultihostSpec":
        """Read the EAO_* variables."""
        return MultihostSpec(
            coordinator_address=os.environ.get("EAO_COORDINATOR"),
            num_processes=_int_env("EAO_NUM_PROCESSES"),
            process_id=_int_env("EAO_PROCESS_ID"),
        )


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def _default_backend(num_processes: int) -> str:
    """`nccl` when every rank of this host has a card of its own, else
    `gloo`. The host's ranks: `LOCAL_WORLD_SIZE` where a launcher sets it,
    else all `num_processes`."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local = _int_env("LOCAL_WORLD_SIZE") or num_processes
    return "nccl" if n >= max(local, 1) else "gloo"


def _rank_device(rank: int) -> torch.device:
    """The device of rank `rank`: `cuda:{LOCAL_RANK}` where a launcher sets
    it (the global rank counts the ranks of every host), else
    `cuda:{rank % device_count}`; the CPU on a machine without a card."""
    if torch.cuda.is_available():
        local = _int_env("LOCAL_RANK")
        return torch.device("cuda", (rank if local is None else local)
                            % torch.cuda.device_count())
    return torch.device("cpu")


# the device `ensure_initialized` selected for this process's rank
_device: Optional[torch.device] = None


def local_device() -> torch.device:
    """This process's device in the group: the one `ensure_initialized`
    selected (the spec's, or `_rank_device`), else the current card, else
    the CPU. Indexed, so that a thread other than the one that formed the
    group (a new thread starts on card 0) can enter it."""
    if _device is not None:
        return _device
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def ensure_initialized(spec: Optional[MultihostSpec] = None) -> bool:
    """Bring up the `torch.distributed` process group once.

    Returns True when a group of more than one process is active after the
    call, False for a plain single-process run (a no-op then). On a
    machine with a card each rank selects its device first: the spec's,
    else `_rank_device`."""
    global _device
    if dist.is_initialized():
        return dist.get_world_size() > 1
    spec = spec if spec is not None else MultihostSpec.from_env()
    explicit = spec.coordinator_address is not None
    auto = os.environ.get("EAO_MULTIHOST", "0") == "1"
    if not (explicit or auto):
        return False
    if explicit:
        coord = spec.coordinator_address
        init = coord if "://" in coord else f"tcp://{coord}"
        world, rank = spec.num_processes, spec.process_id
        if world is None or rank is None:
            raise ValueError("EAO_COORDINATOR needs EAO_NUM_PROCESSES and "
                             "EAO_PROCESS_ID")
    else:
        init = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    backend = spec.backend or _default_backend(world)
    dev = (resolve_device(spec.device) if spec.device is not None
           else _rank_device(rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _device = dev
    dist.init_process_group(
        backend=backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the process that owns host-side orchestration (the System,
    I/O, logging): rank 0, or a process without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_device_count() -> int:
    """The devices of the group: its world size (one device per rank); 1
    without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1
