"""The port's vocabulary trainer against the JAX tool: `kmeans_words` and
`idf_weights` against `tools/train_vocab.py`'s loop on the same
descriptors (the port's extractor on the cached 8-frame seed-0 arc; 256
words, 5 iterations), the JAX side run through its `main` with
`gather_descriptors` and `np.savez_compressed` replaced; and the port's
command line into a temporary file. The shipped `data/vocab.npz` is
left as it was."""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

from eao_fusion_tpu.io import synthetic
from eao_fusion_tpu_torch.mapping import vocabulary
from eao_fusion_tpu_torch.tools import train_vocab as TV

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHIPPED = ROOT / "data" / "vocab.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch ops on one CPU thread (tier-1 runs six test
    files at once); put back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def descs():
    return TV.gather_descriptors(("arc",), ("blocky",), (0,), n_frames=8,
                                 device="cpu",
                                 cache_dir=synthetic.DEFAULT_CACHE)


def test_kmeans_and_idf_match_jax_tool(descs, monkeypatch):
    """The same words, exactly, and idf within 1e-6."""
    import tools.train_vocab as JT
    before = _digest(SHIPPED)
    saved = {}
    monkeypatch.setattr(JT, "gather_descriptors", lambda: descs)
    monkeypatch.setattr(JT.np, "savez_compressed",
                        lambda path, **kw: saved.update(kw))
    JT.main(256, 5)
    X = np.concatenate(descs).astype(np.float32)
    assert len(descs) == 8 and len(X) > 4000
    words = TV.kmeans_words(X, 256, 5, np.random.default_rng(0),
                            log=lambda *a: None)
    idf = TV.idf_weights(descs, words)
    np.testing.assert_array_equal(words.astype(np.int8), saved["words"])
    np.testing.assert_allclose(idf, saved["idf"], atol=1e-6)
    assert _digest(SHIPPED) == before


def test_command_line_writes_a_loadable_vocabulary(tmp_path, capsys):
    """Three frames of the cached arc, 64 words, 2 iterations, written to
    --out: the vocabulary loader reads it back; nothing else is written."""
    before = _digest(SHIPPED)
    out = tmp_path / "v.npz"
    res = TV.main(["--words", "64", "--iters", "2", "--styles", "arc",
                   "--textures", "blocky", "--seeds", "0", "--frames", "3",
                   "--device", "cpu", "--cache-dir", synthetic.DEFAULT_CACHE,
                   "--out", str(out)])
    v = vocabulary.Vocabulary.load(str(out))
    assert v.n_words == 64 and res["images"] == 3
    assert set(np.unique(v.words.numpy())) <= {-1, 1}
    assert np.isfinite(v.idf.numpy()).all() and (v.idf.numpy() >= 0).all()
    assert _digest(SHIPPED) == before
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")
