"""The port stands alone: importing every module of ``vit_torch_tpu_torch``
(and ``chip_smoke``, without running it) pulls in neither JAX nor any
module of the JAX package, nor matplotlib (``utils/plots.py`` imports it
inside its functions: the card's machine has none).  Runs in a fresh
interpreter, since this test process has both loaded."""

import os
import subprocess
import sys
from torch_threads import fit_threads_to_workers

fit_threads_to_workers()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import vit_torch_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    vit_torch_tpu_torch.__path__, "vit_torch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "vit_torch_tpu",
                                    "matplotlib"))
print(len(names), bad)
assert len(names) >= 20, names
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
