"""The port imports no JAX: every module loads in a fresh interpreter, and
afterwards neither jax, flax, optax nor the JAX package is in sys.modules.
The chip_smoke.py script at the repo root is held to the same rule."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodal_fl_security_tpu")

CHECK = f"""
import importlib, pkgutil, sys
import multimodal_fl_security_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
{{extra}}
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print(len(names), bad)
"""


@pytest.mark.parametrize("extra", ["", "import chip_smoke"])
def test_port_imports_no_jax(extra):
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-c", CHECK.format(extra=extra)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 46  # every module of the slices was imported
    assert bad == "[]", bad
