"""The port stands alone: no module of ``pangu_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package, and every port
module imports in a process where JAX cannot be imported at all, nor any of
the optional packages the card's machine lacks (``OPTIONAL``); the serving
command lines and the fine-tuning one run there too."""

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
# imported, where at all, inside the functions that need them
OPTIONAL = ("pandas", "h5py", "matplotlib", "xarray", "tensorboardX", "orbax",
            "onnx", "onnxruntime")


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


def test_the_parallel_modules_and_the_rank_helper_are_covered():
    """The mesh modules are checked like every port module, and the module
    whose functions the tests' spawned ranks run imports no JAX either."""
    assert {"pangu_tpu_torch/parallel/__init__.py",
            "pangu_tpu_torch/parallel/mesh.py",
            "pangu_tpu_torch/parallel/sharding.py",
            "pangu_tpu_torch/parallel/launch.py"} <= set(PORT_FILES)
    roots = set(_imported_roots(ROOT / "tests" / "torch_world.py"))
    assert not roots & {"jax", "jaxlib", "pangu_tpu"}, roots


def test_the_training_command_lines_are_covered():
    """The four command lines of the last slice are checked like every port
    module."""
    assert {f"pangu_tpu_torch/cli/{m}.py" for m in (
        "finetune", "lora_tune", "profile_step", "parity_check")} <= set(
        PORT_FILES)


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


def _run_blocked(body: str, blocked, cwd, timeout=120):
    code = ("import sys\n"
            f"for name in {list(blocked)!r}:\n"
            "    sys.modules[name] = None\n" + body)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_every_port_module_imports_without_optional_packages():
    modules = [f[:-3].replace(os.sep, ".").removesuffix(".__init__")
               for f in PORT_FILES]
    out = _run_blocked("import importlib\n"
                       f"for m in {modules!r}:\n"
                       "    importlib.import_module(m)\n"
                       f"assert not any(sys.modules.get(n) for n in "
                       f"{OPTIONAL!r})\n"
                       "print('ok')\n",
                       ("jax", "pangu_tpu") + OPTIONAL, ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_serving_command_lines_run_without_optional_packages(tmp_path):
    """convert_weights, evaluate and inference (token space) at TINY on the
    CPU with every optional package and JAX unimportable."""
    args = ["--device", "cpu", "--tiny", "--synthetic", "--limit", "1",
            "--set", f"output_path={tmp_path}",
            "--set", "data.test_start=20150106",
            "--set", "data.test_end=20150109"]
    body = (f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import torch\n"
            "from pangu_tpu_torch.cli import convert_weights, evaluate, inference\n"
            "from pangu_tpu_torch.config import TINY\n"
            "from pangu_tpu_torch.models import convert, pangu\n"
            "p = pangu.init_params(torch.Generator().manual_seed(0), TINY, "
            "device='cpu')\n"
            f"pth = {str(tmp_path / 'w.pth')!r}\n"
            "torch.save(convert.export_torch_state_dict(p, TINY), pth)\n"
            "assert convert_weights.main(['--tiny', '--device', 'cpu', "
            f"'--input', pth, '--output', {str(tmp_path / 'w.pt')!r}]) == 0\n"
            f"assert evaluate.main({args!r} + ['--no-viz', '--pretrained', "
            f"{str(tmp_path / 'w.pt')!r}]) == 0\n"
            f"assert inference.main({args!r} + ['--horizon', '48', "
            "'--token-space', '--type_net', 'inf']) == 0\n"
            "print('ok')\n")
    out = _run_blocked(body, ("jax", "pangu_tpu") + OPTIONAL, tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    for run in ("pangu_tpu/24", "inf/48"):
        assert len(os.listdir(tmp_path / run / "csv")) == 12


def test_fine_tuning_runs_without_optional_packages(tmp_path):
    """finetune ``--smoke`` at TINY on the CPU with every optional package
    and JAX unimportable (no tensorboardX: the writer is a stub)."""
    args = ["--device", "cpu", "--tiny", "--synthetic", "--smoke",
            "--set", f"output_path={tmp_path}",
            "--set", "data.test_start=20150106",
            "--set", "data.test_end=20150107", "--set", "data.num_workers=1"]
    body = (f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import torch\n"
            "torch.set_num_threads(1)   # beside the other test workers\n"
            "from pangu_tpu_torch.cli import finetune\n"
            f"assert finetune.main({args!r} + ['--type_net', 'ft']) == 0\n"

            "print('ok')\n")
    out = _run_blocked(body, ("jax", "pangu_tpu") + OPTIONAL, tmp_path,
                       timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
    assert len(os.listdir(tmp_path / "ft" / "24" / "test" / "csv")) == 12


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
