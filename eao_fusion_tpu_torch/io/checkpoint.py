"""Map checkpoint and resume, in the JAX package's npz format
(`eao_fusion_tpu/io/checkpoint.py`): the same keys ("map.<field>",
"objects.<field>", "track.<field>", "track.last_feats.<field>"), the same
numpy dtypes and the same `meta` JSON, so that a map saved by one package
loads into the other.

The reference's `SaveMap/LoadMap` is an unimplemented TODO
(`include/System.h:115-117`). The whole SLAM state is three NamedTuples of
tensors (MapState, TrackState, ObjectTable), so a checkpoint is a flat npz
of their fields and a resume is exact.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from eao_fusion_tpu_torch.types import to_numpy, to_tensor


def _flatten(prefix: str, tree) -> Dict[str, np.ndarray]:
    return {f"{prefix}.{k}": to_numpy(v) for k, v in tree._asdict().items()}


def save_state(path: str, system) -> None:
    """Write a `pipeline.system.System`'s state; an in-flight global BA is
    merged first."""
    system._poll_gba(blocking=True)
    payload: Dict[str, Any] = {}
    payload.update(_flatten("map", system.map))
    payload.update(_flatten("objects", system.objects))
    ts = system.track._asdict()
    feats = ts.pop("last_feats")
    for k, v in ts.items():
        payload[f"track.{k}"] = to_numpy(v)
    payload.update(_flatten("track.last_feats", feats))
    payload["meta"] = np.frombuffer(json.dumps({
        "frame_id": system.frame_id,
        "n_keyframes": system.n_keyframes,
        "timestamps": system.timestamps,
        "trajectory": [np.asarray(p).tolist() for p in system.trajectory],
    }).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_state(path: str, system) -> None:
    """Restore into a System built with the same configuration. The
    System is reset first (`System.reset`: whatever belonged to the old
    map goes); a field the file lacks (added after it was written) keeps
    its freshly initialized value, and a field of another shape raises
    before anything changes. Restored frames keep their recorded poses
    under `trajectory_tcw(corrected=True)`."""
    def fields(prefix, template):
        return {f"{prefix}.{k}": tuple(v.shape)
                for k, v in template._asdict().items()}

    track = system.track._asdict()
    shapes = {**fields("map", system.map),
              **fields("objects", system.objects),
              **fields("track.last_feats", track.pop("last_feats")),
              **{f"track.{k}": tuple(v.shape) for k, v in track.items()}}
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k in shapes}
        meta = json.loads(bytes(z["meta"]).decode())
    for name in system.track._fields:
        if name != "last_feats" and f"track.{name}" not in arrays:
            raise KeyError(f"{path}: no track.{name}")
    for k, a in arrays.items():
        if tuple(a.shape) != shapes[k]:
            raise ValueError(f"{path}: {k} has shape {a.shape}, the "
                             f"System {shapes[k]}")

    system.reset()
    device = system.device

    def unflatten(prefix, template):
        return type(template)(**{
            name: (to_tensor(arrays[f"{prefix}.{name}"], device)
                   if f"{prefix}.{name}" in arrays else old)
            for name, old in template._asdict().items()})

    m = unflatten("map", system.map)
    system.map = m
    system.objects = unflatten("objects", system.objects)
    system.track = unflatten("track", system.track)._replace(
        last_feats=unflatten("track.last_feats", system.track.last_feats))
    system.frame_id = meta["frame_id"]
    system.n_keyframes = meta["n_keyframes"]
    system.next_kf_hint = int(m.next_kf)
    system.timestamps = meta["timestamps"]
    system.trajectory = [np.array(p, np.float32) for p in meta["trajectory"]]
    # the JAX package restores no reference keyframes here, so its
    # corrected trajectory pairs restored frames with later frames' refs
    system._traj_refs = [(-1, raw) for raw in system.trajectory]
    if system.loop_closer is not None:
        for k in range(int(m.next_kf)):
            if bool(m.kf_valid[k]):
                system.loop_closer.add_keyframe_bow(m, k)
