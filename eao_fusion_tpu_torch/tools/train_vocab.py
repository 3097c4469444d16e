"""Train the flat ORB vocabulary by Hamming-space k-means with the port
(port of `tools/train_vocab.py`, the same scenes, draws and defaults).

    python -m eao_fusion_tpu_torch.tools.train_vocab [--words 8192]
        [--iters 15] [--styles arc forward spin] [--textures blocky
        aperiodic] [--seeds 100 101 102 103] [--frames 8]
        [--out data/vocab.npz] [--device cuda] [--cache-dir DIR]

Gathers ±1 descriptors from synthetic scenes (styles x textures x seeds)
with the port's renderer and extractor, runs k-means with majority-vote
centroid updates (`kmeans_words`), computes idf weights over per-image
word occurrence (`idf_weights`) and writes the npz that
`mapping/vocabulary.Vocabulary.load` reads. The assignment product runs on
the device; the similarities of ±1 vectors are integers, exact in
float32, so ties break to the first word as in the JAX tool, and the
centroid updates and the draws (numpy `default_rng(0)`) are the JAX
tool's, on the host. Prints one JSON line with the run's times last.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Sequence

import numpy as np
import torch

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "vocab.npz")


def gather_descriptors(styles: Sequence[str] = ("arc", "forward", "spin"),
                       textures: Sequence[str] = ("blocky", "aperiodic"),
                       seeds: Sequence[int] = (100, 101, 102, 103),
                       n_frames: int = 8, device=None,
                       cache_dir=None) -> List[np.ndarray]:
    """The valid ±1 descriptors [D_i, 256] int8 of every frame of every
    (style, texture, seed) scene, in that order (the JAX tool's mix:
    3 x 2 x 4 scenes of 8 frames, ~190k descriptors)."""
    from eao_fusion_tpu_torch import resolve_device
    from eao_fusion_tpu_torch.config import SystemConfig
    from eao_fusion_tpu_torch.frontend import extractor
    from eao_fusion_tpu_torch.io import synthetic

    dev = resolve_device(device)
    cfg = SystemConfig()
    descs = []
    for style in styles:
        for tex in textures:
            for seed in seeds:
                seq = synthetic.generate_sequence(
                    n_frames=n_frames, seed=seed, style=style, texture=tex,
                    cache_dir=cache_dir)
                for f in seq.frames:
                    feats = extractor.extract_features(
                        torch.as_tensor(f.gray, device=dev),
                        torch.as_tensor(f.depth, device=dev),
                        orb_cfg=cfg.orb, cam_cfg=cfg.camera)
                    descs.append(feats.desc_pm1[feats.valid].cpu().numpy())
    return descs


def _assign(X: torch.Tensor, C: np.ndarray) -> torch.Tensor:
    """Similarities [D, W] of the ±1 descriptors X to the words C."""
    return X @ torch.as_tensor(C, device=X.device).T


def kmeans_words(X: np.ndarray, n_words: int, iters: int,
                 rng: np.random.Generator, device="cpu",
                 log=print) -> np.ndarray:
    """Hamming k-means of the ±1 descriptors X [D, 256]: initial words
    drawn without replacement, then `iters` rounds of nearest-word
    assignment (the largest ±1 product, first index on ties) and a
    majority vote per word (a zero sum gives -1); an empty word is
    re-seeded from a random descriptor. Returns the words [W, 256]
    float32 ±1."""
    X = np.asarray(X, np.float32)
    Xd = torch.as_tensor(X, device=device)
    C = X[rng.choice(len(X), n_words, replace=False)]
    for it in range(iters):
        sim = _assign(Xd, C)
        assign = torch.argmax(sim, dim=1).cpu().numpy()
        sums = np.zeros((n_words, X.shape[1]), np.float32)
        np.add.at(sums, assign, X)
        counts = np.bincount(assign, minlength=n_words)
        C = np.where(sums > 0, 1.0, -1.0).astype(np.float32)
        empty = counts == 0
        C[empty] = X[rng.choice(len(X), int(empty.sum()))]
        log(f"iter {it}: mean-sim {float(sim.amax(dim=1).mean()):.1f} "
            f"empty {int(empty.sum())}")
    return C


def idf_weights(descs: Sequence[np.ndarray], C: np.ndarray,
                device="cpu") -> np.ndarray:
    """log(n_images / document frequency) of each word, each image's
    descriptors assigned to their nearest words; a word in no image
    counts once."""
    df = np.zeros(C.shape[0], np.float64)
    for d in descs:
        sim = _assign(torch.as_tensor(np.asarray(d, np.float32),
                                      device=device), C)
        df[np.unique(torch.argmax(sim, dim=1).cpu().numpy())] += 1
    return np.log(len(descs) / np.maximum(df, 1.0)).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--words", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--styles", nargs="+", default=["arc", "forward",
                                                    "spin"])
    ap.add_argument("--textures", nargs="+", default=["blocky",
                                                      "aperiodic"])
    ap.add_argument("--seeds", nargs="+", type=int,
                    default=[100, 101, 102, 103])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="default: the card")
    ap.add_argument("--cache-dir", default=None,
                    help="render cache of the synthetic scenes")
    a = ap.parse_args(argv)

    from eao_fusion_tpu_torch import resolve_device
    dev = resolve_device(a.device)
    t0 = time.perf_counter()
    descs = gather_descriptors(a.styles, a.textures, a.seeds, a.frames,
                               device=dev, cache_dir=a.cache_dir)
    t1 = time.perf_counter()
    X = np.concatenate(descs).astype(np.float32)
    print(f"training {a.words} words on {len(X)} descriptors", flush=True)
    C = kmeans_words(X, a.words, a.iters, np.random.default_rng(0),
                     device=dev)
    idf = idf_weights(descs, C, device=dev)
    t2 = time.perf_counter()
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    np.savez_compressed(a.out, words=C.astype(np.int8), idf=idf)
    out = {"out": a.out, "words": a.words, "iters": a.iters,
           "descriptors": int(len(X)), "images": len(descs),
           "device": str(dev), "gather_s": t1 - t0, "train_s": t2 - t1}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
