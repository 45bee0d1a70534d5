"""The PyTorch port stands alone: importing any of its modules, or
chip_smoke.py, in a fresh interpreter loads neither JAX nor the JAX
package, nor the libraries the JAX package reads checkpoints with
(``safetensors``, ``tokenizers``, ``transformers``, ``regex``,
``ml_dtypes``), which the card's machine lacks, nor PyYAML or
``jsonschema``, which it lacks too (the port reads manifests and skills
with ``governance/frontmatter.py`` and checks grove schemas with
``governance/jsonschema_lite.py``: the probe loads the shipped groves,
reads and writes a skill and validates a payload to show it), nor
``cryptography``, which it may lack (the persistence vault imports it
when it is given a key). (Only the parity tests import them.)"""

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
             "quoracle_tpu_torch.infra.introspect",
             "quoracle_tpu_torch.utils.normalize",
             "quoracle_tpu_torch.infra.bus",
             "quoracle_tpu_torch.infra.budget",
             "quoracle_tpu_torch.infra.costs",
             "quoracle_tpu_torch.infra.security",
             "quoracle_tpu_torch.context",
             "quoracle_tpu_torch.context.history",
             "quoracle_tpu_torch.context.token_manager",
             "quoracle_tpu_torch.context.lessons",
             "quoracle_tpu_torch.context.reflector",
             "quoracle_tpu_torch.context.condensation",
             "quoracle_tpu_torch.context.context_manager",
             "quoracle_tpu_torch.context.message_builder",
             "quoracle_tpu_torch.context.history_transfer",
             "quoracle_tpu_torch.governance.fields",
             "quoracle_tpu_torch.governance.skills",
             "quoracle_tpu_torch.actions.router",
             "quoracle_tpu_torch.actions.executors",
             "quoracle_tpu_torch.agent",
             "quoracle_tpu_torch.agent.state",
             "quoracle_tpu_torch.agent.registry",
             "quoracle_tpu_torch.agent.core",
             "quoracle_tpu_torch.agent.supervisor",
             "quoracle_tpu_torch.persistence",
             "quoracle_tpu_torch.persistence.db",
             "quoracle_tpu_torch.persistence.store",
             "quoracle_tpu_torch.persistence.tasks",
             "quoracle_tpu_torch.infra.event_history",
             "quoracle_tpu_torch.infra.http",
             "quoracle_tpu_torch.infra.mcp",
             "quoracle_tpu_torch.utils.html_md",
             "quoracle_tpu_torch.models.images",
             "quoracle_tpu_torch.actions.world",
             "quoracle_tpu_torch.runtime",
             "quoracle_tpu_torch.governance.frontmatter",
             "quoracle_tpu_torch.governance.jsonschema_lite",
             "quoracle_tpu_torch.governance.grove",
             "quoracle_tpu_torch.tools.show_prompts",
             "quoracle_tpu_torch.web",
             "quoracle_tpu_torch.web.page",
             "quoracle_tpu_torch.web.views",
             "quoracle_tpu_torch.web.server",
             "quoracle_tpu_torch.cli",
             "quoracle_tpu_torch.chaos",
             "quoracle_tpu_torch.chaos.faults",
             "quoracle_tpu_torch.chaos.invariants",
             "quoracle_tpu_torch.chaos.scenarios",
             "quoracle_tpu_torch.serving.router",
             "quoracle_tpu_torch.serving.cluster",
             "quoracle_tpu_torch.serving.fleet"):
    assert name in names, name
from quoracle_tpu_torch.governance import grove, skills
groves = grove.list_groves(os.path.join({repo!r}, "groves"))
assert [g.name for g in groves] == ["livebench", "mmlu-pro"], groves
enf = grove.GroveEnforcer(groves[1])
assert enf.validate_file_schema(
    os.path.join(enf.workspace_dir(), "runs", "r", "answers", "q.json"),
    '{{"question_id": "q", "answer": "Z"}}').endswith("does not match "
                                                     "'^[A-J]$'")
assert enf.skills_loader().load("mmlu-answerer") is not None
assert skills.parse_skill_md(skills.render_skill_md("a", "b: c", "d")) \
    .description == "b: c"
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join({repo!r}, "chip_smoke.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
BANNED = ("jax", "jaxlib", "quoracle_tpu", "safetensors", "tokenizers",
          "transformers", "regex", "ml_dtypes", "yaml", "jsonschema",
          "cryptography")
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
    assert int(n) >= 110, out.stdout          # every module was imported
    assert bad.strip() == "[]", out.stdout
