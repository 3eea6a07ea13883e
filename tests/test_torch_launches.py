"""Every kernel launch of the port goes through one helper,
``pangu_tpu_torch/_build.py::launch_stream``: it checks that the launch's
tensors lie on one CUDA device, makes that device current around the launch
and hands the entry its stream.  Scanned from the sources: no module reads a
stream (``current_stream(``) anywhere else, and every call of a C entry that
launches (the names in ``_build._SIGNATURES``) sits inside a ``with
_build.launch_stream(...)`` block; the helper's refusals run on the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from pangu_tpu_torch import _build

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "pangu_tpu_torch").rglob("*.py"))


def _parents(tree):
    parent = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parent[child] = node
    return parent


def _enclosing(node, parent):
    while node in parent:
        node = parent[node]
        yield node


def _is_launch_stream(expr):
    return (isinstance(expr, ast.Call)
            and getattr(expr.func, "attr", getattr(expr.func, "id", None))
            == "launch_stream")


def test_no_stream_is_read_outside_the_helper():
    found = []
    for path in PORT_FILES:
        text = path.read_text()
        tree = ast.parse(text, filename=str(path))
        parent = _parents(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "current_stream"):
                where = [n.name for n in _enclosing(node, parent)
                         if isinstance(n, ast.FunctionDef)]
                found.append((path.name, where))
        assert text.count("current_stream(") == sum(
            1 for name, _ in found if name == path.name), path
    assert found == [("_build.py", ["launch_stream"])], found


def test_every_launch_is_inside_launch_stream():
    entries = set(_build._SIGNATURES)
    launches, outside = 0, []
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        parent = _parents(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) in entries):
                launches += 1
                guarded = any(
                    isinstance(n, ast.With)
                    and any(_is_launch_stream(i.context_expr) for i in n.items)
                    for n in _enclosing(node, parent))
                if not guarded:
                    outside.append(f"{path.name}:{node.lineno}")
    # 19 wrappers launch, each through one call of its entry (18 kernels
    # and the bf16 recovery backward's relayout pass alone)
    assert launches == 19 and not outside, (launches, outside)


@pytest.mark.parametrize("tensors", [
    (torch.zeros(2),),
    (torch.zeros(2), None),
    (torch.zeros(2), torch.zeros(2, device="meta")),
    (None,),
], ids=["cpu", "cpu-and-none", "two-devices", "no-tensor"])
def test_launch_stream_refuses_tensors_not_on_one_cuda_device(tensors):
    with pytest.raises(ValueError, match="one CUDA device"):
        with _build.launch_stream(*tensors):
            pass
