"""The port's crowded-map retrieval harness (tests/torch_retrieval_harness.py)
against the JAX package's (tests/retrieval_harness.py): `measure_retrieval`
on one small BoW set drawn with numpy gives the same dict, key for key.
The crowded 256-keyframe database itself is built on the card
(`chip_smoke.py` phase 28): its scenes are not in the render cache."""

import numpy as np

import retrieval_harness as J
import torch_retrieval_harness as T


def _bow(r, W, ring, scenes, yaws):
    """L1-normalized tf-idf-like rows: a frame draws most of its words
    from a window of its scene's word ring centred at its yaw, so nearby
    views of one scene share words and retrieval has structure to find."""
    out = np.zeros((len(scenes), W), np.float32)
    for i, (s, yaw) in enumerate(zip(scenes, yaws)):
        c = int((yaw + np.pi) / (2 * np.pi) * len(ring[s]))
        own = ring[s][(c + np.arange(-15, 15)) % len(ring[s])]
        own = r.choice(own, 8, replace=False)
        other = r.choice(W, 24, replace=False)
        out[i, own] = r.random(8).astype(np.float32) + 0.1
        out[i, other] += r.random(24).astype(np.float32)
    return out / out.sum(axis=1, keepdims=True)


def _db(seed=0, n_scenes=4, per_scene=16, q_per_scene=4, W=512):
    r = np.random.default_rng(seed)
    ring = [r.choice(W, 120, replace=False) for _ in range(n_scenes)]
    db_scene = np.repeat(np.arange(n_scenes), per_scene)
    q_scene = np.repeat(np.arange(n_scenes), q_per_scene)
    db_yaw = np.tile(np.linspace(-np.pi, np.pi, per_scene, endpoint=False),
                     n_scenes)
    q_yaw = db_yaw.reshape(n_scenes, per_scene)[:, ::per_scene
                                                // q_per_scene].ravel() + 0.1
    bow_db = _bow(r, W, ring, db_scene, db_yaw)
    q_bow = _bow(r, W, ring, q_scene, q_yaw)
    return dict(bow_db=bow_db, db_scene=db_scene, db_yaw=db_yaw,
                q_bow=q_bow, q_scene=q_scene, q_yaw=q_yaw,
                words_per_frame=(bow_db > 0).sum(axis=1))


def test_measure_retrieval_matches_jax_harness():
    d = _db()
    mj = J.measure_retrieval(J.RetrievalDB(**d))
    mt = T.measure_retrieval(T.RetrievalDB(**d))
    assert set(mt) == set(mj)
    for k in mj:
        assert mt[k] == mj[k], (k, mt[k], mj[k])
    # the set is not degenerate: retrieval finds revisits, not all of them
    assert 0.0 < mt["precision_at_1"] and mt["n_db"] == 64
    assert mt["word_gate_recall"] < 1.0 or mt["recall_at_5"] < 1.0
