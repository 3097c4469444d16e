"""Nothing the harness, its drivers, metric readers or the reference load
is JAX or the JAX package, by whole top-level names (the port,
`eao_fusion_tpu_torch`, passes); the reference loads nothing of the port
either, nor do the kinds of check and the scenes until a run installs
them. Each import runs in a fresh interpreter."""

import subprocess
import sys

from benchmark.harness import core

FORBIDDEN = ("jax", "jaxlib", "flax", "eao_fusion_tpu")

HARNESS = """
import benchmark.run, benchmark.drivers.chunked
import benchmark.harness.check, benchmark.harness.stream
import benchmark.harness.trace, benchmark.harness.roofline
import pkgutil, importlib, benchmark.metrics, benchmark.costs
for pkg in (benchmark.metrics, benchmark.costs):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(pkg.__name__ + "." + m.name)
import eao_fusion_tpu_torch.pipeline.system
"""
REFERENCE = """
import benchmark.reference.pose, benchmark.reference.local_ba
import benchmark.reference.features, benchmark.reference.planes
import benchmark.reference.objects, benchmark.reference.lie
import benchmark.gen.synthetic, benchmark.gen.render_torch
import pkgutil, importlib, benchmark.checks, benchmark.gen.scenes
for pkg in (benchmark.checks, benchmark.gen.scenes):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(pkg.__name__ + "." + m.name)
"""


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(core.ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    top = _loaded(HARNESS)
    assert "eao_fusion_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def test_reference_loads_neither_jax_nor_the_port():
    top = _loaded(REFERENCE)
    assert not top & (set(FORBIDDEN) | {"eao_fusion_tpu_torch"})


def test_whole_name_check():
    assert core.FORBIDDEN == FORBIDDEN
    import types
    saved = dict(sys.modules)
    try:
        sys.modules["eao_fusion_tpu_torch_probe"] = types.ModuleType("x")
        assert "eao_fusion_tpu_torch_probe" not in core.forbidden_loaded()
        sys.modules["eao_fusion_tpu.probe"] = types.ModuleType("y")
        assert "eao_fusion_tpu.probe" in core.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
