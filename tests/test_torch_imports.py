"""The PyTorch port stands alone: importing any of its modules, or
chip_smoke.py, in a fresh interpreter loads neither JAX nor the JAX
package. (Only the parity tests import both.)"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, importlib.util, os, pkgutil, sys
sys.path.insert(0, {repo!r})
import quoracle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    quoracle_tpu_torch.__path__, "quoracle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("quoracle_tpu_torch.utils.calibration",
             "quoracle_tpu_torch.ops.paged_attention",
             "quoracle_tpu_torch.models.quant"):
    assert name in names, name
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join({repo!r}, "chip_smoke.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "quoracle_tpu" or m.startswith("quoracle_tpu."))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=REPO)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 18, out.stdout          # every module was imported
    assert bad.strip() == "[]", out.stdout
