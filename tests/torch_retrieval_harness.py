"""Crowded-map retrieval harness of the port (the counterpart of
tests/retrieval_harness.py, on the port's extractor and vocabulary).

A 256-keyframe BoW database over 8 scenes (closed 360-degree spins, seeds
100-107, 40 frames each, alternating blocky and voronoi textures): every
fifth frame is a query, the other 32 of a scene fill the database. It
measures what loop and relocalization retrieval deliver at the trained
vocabulary's size: precision@1, recall@5, the recall of the reference's
0.8 x max-common-words gate (`src/KeyFrameDatabase.cc:119`) and the word
statistics, the keys and definitions of `retrieval_harness.measure_
retrieval`.

Imports torch and the port only, never JAX: `chip_smoke.py` phase 28
builds the database on the card from the scenes of `scene_specs`, which
it renders in one pool (`synthetic.render_sequences`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch


class RetrievalDB(NamedTuple):
    bow_db: np.ndarray       # [K, W] L1-normalized tf-idf bow vectors
    db_scene: np.ndarray     # [K] scene id per database keyframe
    db_yaw: np.ndarray       # [K] viewpoint yaw (rad) within its scene
    q_bow: np.ndarray        # [Q, W]
    q_scene: np.ndarray      # [Q]
    q_yaw: np.ndarray        # [Q]
    words_per_frame: np.ndarray  # [K] distinct words per database frame


def _frame_yaw(tcw: np.ndarray) -> float:
    """Viewpoint yaw of a camera given its world->camera pose [qwxyz, t]."""
    from eao_fusion_tpu_torch.ops import lie
    R = lie.quat_to_rotmat(torch.as_tensor(tcw[:4], dtype=torch.float32))
    # the optical axis in world coordinates: R^T @ [0, 0, 1]
    z = R.numpy().T @ np.array([0.0, 0.0, 1.0])
    return float(np.arctan2(z[0], z[2]))


def yaw_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


def scene_specs() -> List[dict]:
    """The `render_sequences` specs of the 8 scenes: seeds 100-107, 40
    frames of a spin each, blocky and voronoi textures in turn, 640x480."""
    return [dict(n_frames=40, seed=100 + s, style="spin",
                 texture="blocky" if s % 2 == 0 else "voronoi")
            for s in range(8)]


def build_retrieval_db(seqs, device="cpu",
                       db_per_scene: int = 32) -> RetrievalDB:
    """Extract and score the rendered scenes `seqs` (of `scene_specs`)
    with `SystemConfig()`'s ORB settings and `data/vocab.npz` on
    `device`; `db_per_scene` frames of each fill the database, the others
    are queries."""
    from eao_fusion_tpu_torch.config import SystemConfig
    from eao_fusion_tpu_torch.frontend import extractor
    from eao_fusion_tpu_torch.mapping import vocabulary

    vocab = vocabulary.Vocabulary.load(device=device)
    cfg = SystemConfig()
    frames_per_scene = len(seqs[0].frames)
    q_every = frames_per_scene // (frames_per_scene - db_per_scene)

    db_v, db_s, db_y, q_v, q_s, q_y, wpf = [], [], [], [], [], [], []
    for s, seq in enumerate(seqs):
        for i, f in enumerate(seq.frames):
            feats = extractor.extract_features(
                torch.as_tensor(f.gray, device=device),
                torch.as_tensor(f.depth, device=device),
                orb_cfg=cfg.orb, cam_cfg=cfg.camera)
            v = vocabulary.bow_vector(vocab, feats.desc_pm1,
                                      feats.valid).cpu().numpy()
            yaw = _frame_yaw(f.tcw)
            if i % q_every == q_every - 1:
                q_v.append(v); q_s.append(s); q_y.append(yaw)
            else:
                db_v.append(v); db_s.append(s); db_y.append(yaw)
                wpf.append(int((v > 0).sum()))
    return RetrievalDB(
        bow_db=np.stack(db_v), db_scene=np.array(db_s),
        db_yaw=np.array(db_y), q_bow=np.stack(q_v),
        q_scene=np.array(q_s), q_yaw=np.array(q_y),
        words_per_frame=np.array(wpf))


def measure_retrieval(db: RetrievalDB, yaw_th: float = 0.6,
                      device="cpu") -> Dict:
    """Score every query against the whole database with the port's
    `l1_scores` on `device`; a database frame is a true revisit of a
    query iff it is of the same scene and its yaw is within `yaw_th` rad."""
    from eao_fusion_tpu_torch.mapping import vocabulary

    K = db.bow_db.shape[0]
    bow = torch.as_tensor(db.bow_db, device=device)
    ok = torch.ones(K, dtype=torch.bool, device=device)
    scores = np.stack([
        vocabulary.l1_scores(torch.as_tensor(q, device=device), bow,
                             ok).cpu().numpy()
        for q in db.q_bow])                              # [Q, K]
    same_scene = db.q_scene[:, None] == db.db_scene[None, :]
    near = yaw_dist(db.q_yaw[:, None], db.db_yaw[None, :]) < yaw_th
    positive = same_scene & near                         # [Q, K]
    assert positive.any(axis=1).all(), "every query needs >=1 true revisit"

    order = np.argsort(-scores, axis=1)
    top1 = order[:, 0]
    p_at_1 = float(positive[np.arange(len(top1)), top1].mean())
    top5 = order[:, :5]
    r_at_5 = float(np.take_along_axis(positive, top5, axis=1)
                   .any(axis=1).mean())

    # the reference's relocalization gate: common words >= 0.8 x the most
    q_ind = (db.q_bow > 0).astype(np.float32)
    db_ind = (db.bow_db > 0).astype(np.float32)
    common = q_ind @ db_ind.T                            # [Q, K]
    gate = common > 0.8 * common.max(axis=1, keepdims=True)
    gate_recall = float((gate & positive).any(axis=1).mean())
    gate_size = float(gate.sum(axis=1).mean())

    # word collisions over the whole database
    used = (db.bow_db > 0).any(axis=0)
    occ = db_ind.sum(axis=0)                             # frames per word
    p = occ / max(occ.sum(), 1e-9)
    ent = float(-(p[p > 0] * np.log2(p[p > 0])).sum())
    return {
        "n_db": int(K), "n_queries": int(len(db.q_bow)),
        "precision_at_1": round(p_at_1, 4),
        "recall_at_5": round(r_at_5, 4),
        "word_gate_recall": round(gate_recall, 4),
        "word_gate_mean_candidates": round(gate_size, 1),
        "words_used_frac": round(float(used.mean()), 4),
        "mean_words_per_frame": round(float(db.words_per_frame.mean()), 1),
        "word_usage_entropy_bits": round(ent, 2),
        "max_entropy_bits": round(float(np.log2(max(used.sum(), 1))), 2),
    }


def check_floors(m: Dict) -> None:
    """The floors of tests/test_retrieval_stress.py."""
    assert m["n_db"] == 256, m
    assert m["precision_at_1"] >= 0.90, m
    assert m["recall_at_5"] >= 0.95, m
    assert m["word_gate_recall"] >= 0.90, m
    assert m["words_used_frac"] >= 0.5, m
    assert m["word_usage_entropy_bits"] >= 0.8 * m["max_entropy_bits"], m
