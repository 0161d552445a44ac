"""The port runs where there is no JAX, no decnet_tpu, no PIL and no cv2:
every module of decnet_tpu_torch, and chip_smoke.py, imports with those
blocked, and no import statement anywhere in them (inside functions too)
names one of them."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "decnet_tpu", "PIL",
          "cv2")


def sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "decnet_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_statement_names_a_banned_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in BANNED, (path, node.lineno, n)


def test_every_module_imports_with_the_reference_blocked():
    script = f"""
import importlib, pkgutil, sys
for name in {BANNED!r}:
    sys.modules[name] = None          # `import name` raises ImportError
sys.path.insert(0, {ROOT!r})
import decnet_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(decnet_tpu_torch.__path__,
                                              "decnet_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
importlib.import_module("chip_smoke")
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 40
