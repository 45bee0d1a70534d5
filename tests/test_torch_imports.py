"""The PyTorch port stands alone: importing any of its modules, or
chip_smoke.py, in a fresh interpreter loads neither JAX nor the JAX
package, nor the libraries the JAX package reads checkpoints with
(``safetensors``, ``tokenizers``, ``transformers``, ``regex``,
``ml_dtypes``), which the card's machine lacks. (Only the parity tests
import them.)"""

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
             "quoracle_tpu_torch.models.quant",
             "quoracle_tpu_torch.models.prefix_cache",
             "quoracle_tpu_torch.utils.cache",
             "quoracle_tpu_torch.models.embeddings",
             "quoracle_tpu_torch.actions.schema",
             "quoracle_tpu_torch.actions.validator",
             "quoracle_tpu_torch.consensus.json_utils",
             "quoracle_tpu_torch.consensus.parser",
             "quoracle_tpu_torch.consensus.rules",
             "quoracle_tpu_torch.consensus.aggregator",
             "quoracle_tpu_torch.consensus.result",
             "quoracle_tpu_torch.consensus.temperature",
             "quoracle_tpu_torch.consensus.quality",
             "quoracle_tpu_torch.consensus.engine",
             "quoracle_tpu_torch.consensus.prompt_builder",
             "quoracle_tpu_torch.governance.capabilities",
             "quoracle_tpu_torch.infra.injection",
             "quoracle_tpu_torch.tools.json_closure",
             "quoracle_tpu_torch.serving.qos",
             "quoracle_tpu_torch.serving.admission",
             "quoracle_tpu_torch.tools.bench_longctx",
             "quoracle_tpu_torch.tools.calibrate_paged",
             "quoracle_tpu_torch.infra.telemetry",
             "quoracle_tpu_torch.infra.resources",
             "quoracle_tpu_torch.serving.slo",
             "quoracle_tpu_torch.models.scheduler",
             "quoracle_tpu_torch.models.speculative",
             "quoracle_tpu_torch.models.safetensors_io",
             "quoracle_tpu_torch.models.loader",
             "quoracle_tpu_torch.models.make_checkpoint",
             "quoracle_tpu_torch.serving.kvtier",
             "quoracle_tpu_torch.serving.handoff",
             "quoracle_tpu_torch.infra.locks",
             "quoracle_tpu_torch.infra.flightrec",
             "quoracle_tpu_torch.infra.fleetobs",
             "quoracle_tpu_torch.infra.costobs",
             "quoracle_tpu_torch.infra.treeobs",
             "quoracle_tpu_torch.infra.introspect"):
    assert name in names, name
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join({repo!r}, "chip_smoke.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
BANNED = ("jax", "jaxlib", "quoracle_tpu", "safetensors", "tokenizers",
          "transformers", "regex", "ml_dtypes")
bad = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=REPO)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 56, out.stdout          # every module was imported
    assert bad.strip() == "[]", out.stdout
