"""The PyTorch port imports neither jax nor the JAX package: the machine
with the GPU has no jax, and importing sfvp_tpu imports jax."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "sfvp_tpu"}


def _port_files():
    return sorted((ROOT / "sfvp_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_with_jax_blocked():
    """Every module of the port imports in a process where ``import jax``
    and ``import sfvp_tpu`` fail."""
    mods = sorted(
        "sfvp_tpu_torch." + ".".join(p.relative_to(ROOT / "sfvp_tpu_torch")
                                     .with_suffix("").parts)
        for p in (ROOT / "sfvp_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'sfvp_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import sfvp_tpu_torch\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
