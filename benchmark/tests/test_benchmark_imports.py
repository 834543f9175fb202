"""What the benchmark may import, and that it never falls back to the CPU."""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import spec

ROOT = Path(__file__).resolve().parents[2]
SOURCES = sorted(p for p in (ROOT / "benchmark").rglob("*.py")
                 if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "spnerf_tpu"}
# the modules that may drive the program under test: the Siren family's
# program and the model families (whose references live in modules that
# import nothing of the port, checked below)
PROGRAM = ROOT / "benchmark" / "program.py"
FAMILIES = sorted((ROOT / "benchmark" / "families").glob("*.py"))


def top_level_imports(path):
    """Top-level names of every module `path` imports (relative imports
    excluded), compared whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_only_the_program_adapter_imports_the_port(path):
    if path != PROGRAM and path not in FAMILIES:
        assert "spnerf_torch" not in top_level_imports(path)


@pytest.mark.parametrize("path", FAMILIES, ids=lambda p: p.stem)
def test_family_reference_imports_nothing_of_the_port(path):
    """A family's reference is defined in a module that imports neither the
    port nor JAX."""
    family = spec.load_family(path.stem)
    for fn in (family.reference_train, family.reference_eval_rows):
        source = Path(inspect.getsourcefile(fn))
        assert not top_level_imports(source) & (FORBIDDEN | {"spnerf_torch"})


def test_top_level_names_compared_whole():
    """The port's name begins with the JAX package's; only the whole name
    is forbidden."""
    assert "spnerf_torch" not in FORBIDDEN
    assert "spnerf_torch".split(".")[0] != "spnerf_tpu"


def test_run_without_a_card_fails(tmp_path):
    """No CUDA card: a non-zero exit and no result line, never a CPU run."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "flagship.train",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
