"""Nothing the benchmark runs on the card may load JAX or the JAX package,
and the plain reference may load nothing of the program. Module names
are compared by their whole top-level name: ``sfvp_tpu_torch`` is the
program, ``sfvp_tpu`` the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
JAX = {"jax", "jaxlib", "flax", "sfvp_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def benchmark_sources():
    return sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", benchmark_sources(),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & JAX


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert not names & (JAX | {"sfvp_tpu_torch", "portbench"}), path


def test_top_level_names_are_compared_whole():
    assert "sfvp_tpu_torch" not in JAX
    assert not {"sfvp_tpu_torch"} & JAX


def test_loaded_modules_at_run_time():
    """Import every benchmark module, the program's driver and the
    profiler in a fresh interpreter and list what is loaded."""
    mods = [f"portbench.{p.relative_to(HERE).with_suffix('').as_posix()}"
            .replace("/", ".") for p in benchmark_sources()
            if p.name not in ("__init__.py", "run.py", "readings.py")
            and "metrics" not in p.parts]
    code = ("import sys, torch.profiler\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import sfvp_tpu_torch.render.driver, sfvp_tpu_torch.dispatch\n"
            "from portbench.harness import forbidden_modules\n"
            "print(','.join(forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == ""
