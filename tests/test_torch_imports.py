"""The port stands alone: no file of `slide_tpu_torch/`, nor `chip_smoke.py`,
imports JAX, flax, optax, PyYAML or anything of the JAX package `slide_tpu`
(the card's machine has no PyYAML).  And every test of an uncollected
`tests/torch_<name>_cases.py` module runs: its `tests/test_torch_<name>_<k>.py`
parts import each of its tests exactly once."""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "slide_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "slide_tpu", "yaml")
# the training slice's modules, which copy JAX-package modules that import
# PyYAML or JAX
TRAINING = ("train/driver.py", "train/checkpoint.py", "train/ema.py",
            "data/synthetic.py", "data/shapenet_psr.py", "data/loader.py")
# the autoencoder's modules, which copy JAX-package modules that import JAX
AE = ("nn/pnet.py", "models/encoder.py", "ops/chamfer.py")
# the mesh stages' modules, which copy JAX-package modules that import JAX
SAP = ("sap/__init__.py", "sap/dpsr.py", "sap/mirror.py", "sap/refine.py",
       "sap/marching.py", "sap/mesh_sampling.py", "sap/marching_gpu.py")
# the x0 engine's training, the conditional tasks and the activation dtype,
# which copy JAX-package modules that import JAX
CONDITIONAL = ("diffusion/x0.py", "models/denoiser.py", "eval/generation.py",
               "nn/precision.py")
# the corpus on the device, the data tools, the alternate backbones and
# their voxel ops, which copy JAX-package modules that import JAX or PyYAML
CASES = sorted((REPO / "tests").glob("torch_*_cases.py"))
BACKBONES = ("data/device_corpus.py", "data/tools.py", "data/object_io.py",
             "ops/voxel.py", "models/pvcnn.py", "models/pointwise_net.py",
             "nn/attention.py", "nn/modules.py")
# the command line, the processes and devices, the helpers and the writers,
# which copy JAX-package modules that import JAX
CLI = ("cli/__init__.py", "cli/__main__.py", "cli/main.py", "config.py",
       "parallel/__init__.py", "parallel/multihost.py", "parallel/sharded.py",
       "utils/__init__.py", "utils/checks.py", "utils/logging.py", "utils/model_utils.py",
       "utils/profiling.py", "utils/tree.py", "vis/pcd.py", "vis/plot.py")


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
    assert (REPO / "slide_tpu_torch" / "native" / "marching.cpp").is_file()
    for rel in TRAINING + AE + SAP + CONDITIONAL + BACKBONES + CLI:
        assert REPO / "slide_tpu_torch" / rel in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("cases", CASES, ids=lambda p: p.name)
def test_each_case_is_imported_by_exactly_one_part(cases):
    name = cases.name[len("torch_"):-len("_cases.py")]
    defined = {node.name for node in ast.parse(cases.read_text()).body
               if isinstance(node, ast.FunctionDef) and node.name.startswith("test_")}
    parts = [p for p in (REPO / "tests").glob(f"test_torch_{name}_*.py")
             if re.fullmatch(rf"test_torch_{name}_\d+\.py", p.name)]
    imported = [a.name for part in parts for node in ast.walk(ast.parse(part.read_text()))
                if isinstance(node, ast.ImportFrom) and node.module == cases.stem
                for a in node.names if a.name.startswith("test_")]
    assert defined and parts
    assert sorted(imported) == sorted(defined), (
        f"not run: {sorted(defined - set(imported))}, "
        f"run twice or unknown: {sorted(n for n in set(imported) if imported.count(n) > 1 or n not in defined)}")
