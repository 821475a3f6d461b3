"""The port stands alone: no file of `slide_tpu_torch/`, nor `chip_smoke.py`,
imports JAX, flax, optax, PyYAML or anything of the JAX package `slide_tpu`
(the card's machine has no PyYAML)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "slide_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "slide_tpu", "yaml")
# the training slice's modules, which copy JAX-package modules that import
# PyYAML or JAX
TRAINING = ("train/driver.py", "train/checkpoint.py", "train/ema.py",
            "data/synthetic.py", "data/shapenet_psr.py", "data/loader.py")
# the mesh stages' modules, which copy JAX-package modules that import JAX
SAP = ("sap/__init__.py", "sap/dpsr.py", "sap/mirror.py", "sap/refine.py",
       "sap/marching.py", "sap/mesh_sampling.py", "sap/marching_gpu.py")


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_the_port_has_files():
    assert len(FILES) > 15
    for rel in TRAINING + SAP:
        assert REPO / "slide_tpu_torch" / rel in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
