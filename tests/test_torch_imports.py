"""The port stands alone: no module of ``pangu_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package, and every port
module imports in a process where JAX cannot be imported at all."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / "pangu_tpu_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "pangu_tpu", "bench", "tests")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_no_jax_or_reference_package_import(rel):
    roots = set(_imported_roots(ROOT / rel))
    assert not roots & set(FORBIDDEN), (rel, sorted(roots & set(FORBIDDEN)))


def test_every_port_module_imports_without_jax():
    modules = [f[:-3].replace(os.sep, ".").removesuffix(".__init__")
               for f in PORT_FILES]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['pangu_tpu'] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    (or on a machine without a card) the script exits nonzero and prints no
    result line."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
