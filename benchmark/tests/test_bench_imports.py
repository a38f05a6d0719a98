"""No module of ``benchmark/`` imports JAX, jaxlib, flax, optax or the JAX
package (``mbd_tpu``), top-level names compared whole (``mbd_tpu_torch``
begins with ``mbd_tpu`` and is allowed); the reference imports nothing of
the program (``mbd_tpu_torch``) either. Shown twice: by the import
statements of every file, and by what importing every module loads."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mbd_tpu"}


def _files(sub=""):
    for base, _, names in os.walk(os.path.join(BENCH, sub)):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def _imported(path):
    """The top-level names a file imports (absolute, or relative resolved
    inside ``benchmark``)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "benchmark"
            elif node.module:
                yield node.module.split(".")[0]


def _module(path):
    rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def test_no_file_imports_jax_or_the_jax_package():
    bad = {os.path.relpath(p, ROOT): sorted(set(_imported(p)) & FORBIDDEN)
           for p in _files()}
    assert not {k: v for k, v in bad.items() if v}
    assert "mbd_tpu_torch" in set().union(
        *(set(_imported(p)) for p in _files("harness")))


def test_reference_imports_nothing_of_the_program():
    names = set().union(*(set(_imported(p)) for p in _files("reference")))
    assert not names & (FORBIDDEN | {"mbd_tpu_torch"}), names


PROBE = r"""
import importlib, sys
names = sys.argv[1:]
for name in names:
    importlib.import_module(name)
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("sub, banned", [
    ("", FORBIDDEN), ("reference", FORBIDDEN | {"mbd_tpu_torch"})])
def test_importing_every_module_loads_none(sub, banned):
    modules = [_module(p) for p in _files(sub)
               if not os.path.basename(p).startswith("test_")
               and os.path.basename(p) != "conftest.py"]
    assert len(modules) > 5
    out = subprocess.run([sys.executable, "-c", PROBE, *modules], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(out.stdout.split())
    assert not loaded & banned, loaded & banned
