"""The port stands alone: no file under ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``
(the card's machine has no JAX, and the port must not lean on the
reference it is checked against)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_challenge.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_scan_covers_the_port():
    assert len(FILES) > 20
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "pipeline.py", "histogram.py", "sparse.py",
            "algorithms.py", "sketch.py", "segreduce.py", "flash_attention.py",
            "segment_matmul.py", "transformer.py", "layers.py",
            "granite_8b.py", "engine.py", "state.py", "metrics.py",
            "scenarios.py", "faults.py", "checkpoint.py", "recovery.py",
            "serve.py", "optimizer.py", "loop.py", "elastic.py",
            "train.py", "gnn.py", "common_gnn.py", "schnet.py", "pna.py",
            "egnn.py", "graphsage_reddit.py", "sampler.py", "moe.py",
            "recsys.py", "mixtral_8x7b.py", "arctic_480b.py",
            "xdeepfm.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom repro.core import ops\n"
           "import repro_torch\nimportlib.import_module('repro.data')\n")
    found = [m for m in _imported_modules(ast.parse(src))
             if m.split(".")[0] in FORBIDDEN]
    assert found == ["jax.numpy", "repro.core", "repro.data"]
