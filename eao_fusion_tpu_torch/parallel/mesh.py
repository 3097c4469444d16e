"""Device mesh of the map-sharding layer (port of
`eao_fusion_tpu/parallel/mesh.py`).

Axes:
  * ``lm``  (landmark): map points are sharded here; the Schur-complement
    reduction of the distributed GBA is an all-reduce over it.
  * ``kf``  (keyframe): the map-sharded steady step
    (`parallel/sharded_step.py`) splits the keyframe tables here.

The mesh is a `torch.distributed` `DeviceMesh` over the ranks of the
initialized process group (one device per rank), built collectively:
every rank calls `make_mesh` with the same arguments.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh(n_landmark: Optional[int] = None, n_kf: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """An (n_landmark, n_kf) mesh with dims ("lm", "kf") over the first
    n_landmark * n_kf ranks; n_landmark defaults to the world size over
    n_kf, the device type to `cuda` where there is a card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (multihost.ensure_initialized)")
    world = dist.get_world_size()
    if n_landmark is None:
        n_landmark = world // n_kf
    if n_landmark * n_kf > world or n_landmark < 1:
        raise ValueError(f"a {n_landmark} x {n_kf} mesh does not fit a "
                         f"group of {world} ranks")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    ranks = torch.arange(n_landmark * n_kf).reshape(n_landmark, n_kf)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("lm", "kf"))


def landmark_sharding(mesh: DeviceMesh):
    """Placements of a table sharded along its first axis over ``lm``."""
    return (Shard(0),)


def replicated(mesh: DeviceMesh):
    """Placements of a table every rank holds whole."""
    return (Replicate(),)
