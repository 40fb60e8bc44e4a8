"""Nothing under perfbench/ imports jax or memex_tpu (whole top-level
names: the port's name begins with memex_tpu), and the reference imports
nothing of the program."""

import ast
import os

import pytest

from perfbench.common import FORBIDDEN

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _files(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_files()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_or_memex_tpu(path):
    bad = {m for m in _imports(path) if m in FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(_files("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_is_plain(path):
    mods = set(_imports(path))
    assert mods <= {"torch", "numpy", "math", "__future__"}, mods


def test_whole_name_comparison():
    from perfbench.common import forbidden_modules
    import sys

    sys.modules["memex_tpu_torch_probe_only"] = object()
    try:
        assert "memex_tpu_torch_probe_only" not in forbidden_modules()
    finally:
        del sys.modules["memex_tpu_torch_probe_only"]
    sys.modules["memex_tpu.probe"] = object()
    try:
        assert forbidden_modules() == ["memex_tpu.probe"]
    finally:
        del sys.modules["memex_tpu.probe"]
