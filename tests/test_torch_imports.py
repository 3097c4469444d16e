"""The port stands alone: no module of `eao_fusion_tpu_torch`, and not
`chip_smoke.py`, imports JAX or the JAX package (checked on the import
statements themselves, since comments name their JAX counterparts)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "eao_fusion_tpu")
FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "eao_fusion_tpu_torch").rglob("*.py")) + [
        "chip_smoke.py"]


def _imported(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", FILES)
def test_no_jax_imports(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_checker_tells_the_packages_apart():
    assert _forbidden("eao_fusion_tpu.ops.lie")
    assert _forbidden("jax.numpy")
    assert not _forbidden("eao_fusion_tpu_torch.ops.lie")
    assert len(FILES) > 20
