"""The port stands alone: src/repro_torch, chip_smoke.py and scripts/
import no jax and nothing of the JAX package (repro), even modules of it
that are pure numpy.  Only the parity tests import both."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
SCRIPTS = sorted((ROOT / "scripts").glob("*.py"))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _assert_no_jax_and_no_reference(path: Path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path}: imports {name}"
        assert top != "repro", f"{path}: imports {name} from the reference"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    _assert_no_jax_and_no_reference(path)


@pytest.mark.parametrize("path", SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_script_imports_no_jax_and_no_reference(path):
    """The port's measurement scripts run on the card's machine, which has
    no jax: they import neither it nor the reference."""
    _assert_no_jax_and_no_reference(path)


def test_importing_the_port_loads_no_jax():
    """Import every module of the port (and chip_smoke) in a fresh
    interpreter: neither jax nor any module of repro gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= len(PORT_FILES) - 1
