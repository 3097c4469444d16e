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


# the I/O, CLI and training modules: checked like every other port file
IO_CLI_TRAINING = [f"eao_fusion_tpu_torch/{p}" for p in (
    "io/tum.py", "io/imu.py", "io/checkpoint.py", "io/native_loader.py",
    "io/synthetic.py", "utils/profiling.py", "utils/viz.py",
    "frontend/yolox.py", "frontend/yolox_train.py",
    "tools/make_tum_dataset.py", "tools/train_yolox.py", "apps/run_tum.py")]
# libraries the card's machine lacks: imported only inside the functions
# that need them, never when a module is imported
OPTIONAL = ("matplotlib", "PIL")


def test_io_cli_and_training_modules_are_checked():
    assert set(IO_CLI_TRAINING) <= set(FILES)


@pytest.mark.parametrize("path", FILES)
def test_optional_libraries_load_lazily(path):
    tree = ast.parse((ROOT / path).read_text())
    top = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            top += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            top.append(node.module)
    bad = [n for n in top if n.split(".")[0] in OPTIONAL]
    assert not bad, f"{path} imports {bad} at module level"


# the distributed layer and the vocabulary trainer
PARALLEL_AND_VOCAB = [f"eao_fusion_tpu_torch/{p}" for p in (
    "parallel/__init__.py", "parallel/multihost.py", "parallel/mesh.py",
    "parallel/dist_ba.py", "parallel/eval.py", "parallel/sharded_step.py",
    "tools/train_vocab.py")]


def test_parallel_and_vocab_modules_are_checked():
    assert set(PARALLEL_AND_VOCAB) <= set(FILES)


# the JAX package's modules that have no port file at the same path, and
# what stands in for each
REPLACED = {
    "ops/precision.py": "the precision rule: float32 solver math, TF32 off",
    "solvers/pose_opt_pallas.py": "csrc/pose_opt.cu",
    "solvers/ba_edge_pallas.py": "csrc/ba_edge.cu",
    "solvers/chol_pallas.py": "csrc/chol_solve.cu",
}


def test_every_jax_module_has_its_port():
    """The port has a file for every module of the JAX package, at the
    same relative path, but for the four that are replaced: the Pallas
    kernels by the CUDA sources, the `f32_matmuls` decorator by the
    port's precision rule."""
    def modules(pkg):
        return {str(p.relative_to(ROOT / pkg))
                for p in (ROOT / pkg).rglob("*.py")}
    assert (modules("eao_fusion_tpu") - modules("eao_fusion_tpu_torch")
            == set(REPLACED))
    for stand_in in REPLACED.values():
        if stand_in.startswith("csrc/"):
            assert (ROOT / "eao_fusion_tpu_torch" / stand_in).exists()
