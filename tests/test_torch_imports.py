"""The port stands alone: no file of ``action_conditioned_gans_tpu_torch`` and
not ``chip_smoke.py`` imports JAX, Flax, optax, orbax or the JAX package."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "action_conditioned_gans_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "action_conditioned_gans_tpu"}


def port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(files)


def imported_top_levels(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_the_scan_sees_the_whole_port():
    rel = {os.path.relpath(p, REPO) for p in port_files()}
    assert "chip_smoke.py" in rel
    assert "action_conditioned_gans_tpu_torch/ops/kernels/conv.py" in rel
    for module in ("ops/kernels/gn_bwd.py", "models/discriminator.py", "train/losses.py",
                   "train/state.py", "train/rollout.py", "train/step.py",
                   "ops/kernels/norm_act.py", "ops/envelope.py", "data/synthetic.py",
                   "data/pipeline.py", "utils/checkpoint.py", "utils/metrics.py",
                   "train/loop.py", "train/sample.py", "bench.py", "train/augment.py",
                   "aot.py", "ops/kernels/library.py", "utils/images.py", "infer.py", "cli.py",
                   "data/native_tfrecord.py", "data/tfrecord.py", "data/cropping.py",
                   "utils/profiling.py", "utils/trace_report.py", "utils/compile_cache.py",
                   "utils/doctor.py", "parallel/mesh.py", "parallel/dp.py", "parallel/comm.py"):
        assert f"action_conditioned_gans_tpu_torch/{module}" in rel
    assert len(rel) >= 46


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    bad = sorted(set(imported_top_levels(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_the_check_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom action_conditioned_gans_tpu.ops import xla\nimport jax.numpy\n")
    assert set(imported_top_levels(str(f))) & FORBIDDEN == {"action_conditioned_gans_tpu", "jax"}
    f.write_text("from action_conditioned_gans_tpu_torch import ops\n")
    assert not set(imported_top_levels(str(f))) & FORBIDDEN


LAZY = {"tensorflow", "PIL"}


def module_level_imports(path):
    """Top-level names imported by ``path``'s module body, outside any
    function or class (what importing the module imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in tree.body:
        for sub in ast.walk(node) if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) else ():
            if isinstance(sub, ast.Import):
                yield from (alias.name.split(".")[0] for alias in sub.names)
            elif isinstance(sub, ast.ImportFrom) and sub.level == 0 and sub.module:
                yield sub.module.split(".")[0]


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_tensorflow_and_pillow_are_imported_lazily(path):
    """Only the paths that need them import TensorFlow (``source="tfrecord"``)
    and Pillow (JPEG frames): never a module's import."""
    bad = sorted(set(module_level_imports(path)) & LAZY)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad} at module level"


def test_the_lazy_check_sees_a_module_level_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\ntry:\n    import tensorflow as tf\nexcept ImportError:\n    tf = None\n"
                 "def g():\n    from PIL import Image\n")
    assert set(module_level_imports(str(f))) & LAZY == {"tensorflow"}
