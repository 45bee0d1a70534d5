"""Groves: declarative multi-agent environments (GROVE.md manifests).

Parity with the reference's Groves subsystem (reference
lib/quoracle/groves/): Loader parses GROVE.md YAML frontmatter — bootstrap,
topology, governance, confinement, schemas, workspace (loader.ex:12-47);
HardRuleEnforcer applies shell_pattern_block / action_block rules and
path confinement with * and ** globs in strict-vs-warn mode
(hard_rule_enforcer.ex:41-60, README.md:450-486); PathSecurity rejects
traversal and symlink escapes (path_security.ex:14-50); SchemaValidator
runs JSON-Schema validation on file_write payloads matched by path_pattern
(schema_validator.ex, README.md:504-518); TopologyResolver auto-injects
skills/profile/constraints on spawn along declared edges
(README.md:520-545); GovernanceResolver injects governance docs into scoped
agents' prompts; BootstrapResolver pre-fills task creation.

An agent's place in a grove is its *node* (the reference scopes rules by
skill-role names, e.g. ``mmlu-answerer``); the node travels in AgentConfig
and every check takes it explicitly.

The PyTorch port's copy of ``quoracle_tpu/governance/grove.py``. The
manifest is read by the port's YAML-subset reader
(``governance/frontmatter.py``) and file writes are checked by its
JSON-Schema subset (``governance/jsonschema_lite.py``), in place of
PyYAML and ``jsonschema``: the machine that serves the port on the GPU
has neither.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from typing import Any, Optional

from quoracle_tpu_torch.governance import frontmatter, jsonschema_lite
from quoracle_tpu_torch.governance.skills import _FRONTMATTER_RE, SkillsLoader

logger = logging.getLogger(__name__)


class GroveError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HardRule:
    type: str                         # shell_pattern_block | action_block
    message: str = ""
    pattern: Optional[str] = None     # shell_pattern_block
    actions: tuple[str, ...] = ()     # action_block
    scope: tuple[str, ...] = ()       # node names; empty = every node


@dataclasses.dataclass
class TopologyEdge:
    parent: str
    child: str
    auto_inject: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchemaRule:
    name: str
    definition: str                   # path to JSON schema, grove-relative
    path_pattern: str
    validate_on: str = "file_write"


@dataclasses.dataclass
class GroveManifest:
    name: str
    path: str                         # grove directory
    description: str = ""
    version: str = ""
    root_node: Optional[str] = None
    edges: tuple[TopologyEdge, ...] = ()
    hard_rules: tuple[HardRule, ...] = ()
    injections: tuple[dict, ...] = ()
    schemas: tuple[SchemaRule, ...] = ()
    workspace: Optional[str] = None
    confinement: dict = dataclasses.field(default_factory=dict)
    confinement_mode: str = "warn"    # "warn" | "strict"
    bootstrap: dict = dataclasses.field(default_factory=dict)

    @property
    def skills_dir(self) -> str:
        return os.path.join(self.path, "skills")


def load_grove(grove_dir: str) -> GroveManifest:
    """Parse <grove_dir>/GROVE.md (reference loader.ex:12-47)."""
    manifest_path = os.path.join(grove_dir, "GROVE.md")
    try:
        with open(manifest_path) as f:
            text = f.read()
    except OSError as e:
        raise GroveError(f"cannot read {manifest_path}: {e}")
    m = _FRONTMATTER_RE.match(text)
    if not m:
        raise GroveError(f"{manifest_path} has no YAML frontmatter")
    try:
        data = frontmatter.load(m.group(1)) or {}
    except frontmatter.FrontmatterError as e:
        raise GroveError(f"bad YAML in {manifest_path}: {e}")
    if not data.get("name"):
        raise GroveError(f"{manifest_path}: grove needs a name")

    topology = data.get("topology") or {}
    edges = tuple(
        TopologyEdge(parent=e["parent"], child=e["child"],
                     auto_inject=e.get("auto_inject") or {})
        for e in topology.get("edges") or ())
    governance = data.get("governance") or {}
    hard_rules = tuple(
        HardRule(type=r.get("type", ""), message=r.get("message", ""),
                 pattern=r.get("pattern"),
                 actions=tuple(r.get("actions") or ()),
                 scope=tuple(r.get("scope") or ()))
        for r in governance.get("hard_rules") or ())
    schemas = tuple(
        SchemaRule(name=s.get("name", ""), definition=s["definition"],
                   path_pattern=s["path_pattern"],
                   validate_on=s.get("validate_on", "file_write"))
        for s in data.get("schemas") or ())
    return GroveManifest(
        name=str(data["name"]), path=os.path.abspath(grove_dir),
        description=str(data.get("description", "")).strip(),
        version=str(data.get("version", "")),
        root_node=topology.get("root"),
        edges=edges, hard_rules=hard_rules,
        injections=tuple(governance.get("injections") or ()),
        schemas=schemas,
        workspace=data.get("workspace"),
        confinement=data.get("confinement") or {},
        confinement_mode=str(data.get("confinement_mode", "warn")),
        bootstrap=data.get("bootstrap") or {},
    )


def list_groves(groves_dir: str) -> list[GroveManifest]:
    """Scan a directory of groves (reference loader.ex:57 list_groves)."""
    out = []
    if not os.path.isdir(groves_dir):
        return out
    for entry in sorted(os.listdir(groves_dir)):
        full = os.path.join(groves_dir, entry)
        if os.path.isfile(os.path.join(full, "GROVE.md")):
            try:
                out.append(load_grove(full))
            except GroveError:
                logger.warning("skipping malformed grove at %s", full)
    return out


# ---------------------------------------------------------------------------
# Path security (reference path_security.ex:14-50)
# ---------------------------------------------------------------------------

def _expand(p: str) -> str:
    return os.path.abspath(os.path.expanduser(p))


def _resolve_real(path: str) -> str:
    """Resolve symlinks on the deepest existing ancestor so a symlink inside
    an allowed directory cannot smuggle writes outside it."""
    path = _expand(path)
    probe = path
    while not os.path.exists(probe):
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    real_probe = os.path.realpath(probe)
    return os.path.join(real_probe, os.path.relpath(path, probe)) \
        if probe != path else real_probe


def _glob_match(path: str, pattern: str,
                base: Optional[str] = None) -> bool:
    """Glob with ** (any depth) and * (single segment) semantics. A pattern
    ending in ``/**`` also matches the directory itself (a confined node
    must be able to use the root of its allowed tree as a working dir).
    Relative patterns resolve against ``base`` (the grove workspace), never
    the server process CWD."""
    if base and not pattern.startswith(("/", "~")):
        pattern = os.path.join(base, pattern)
    pattern = _expand(pattern)
    regex = ""
    i = 0
    while i < len(pattern):
        if pattern.startswith("/**", i) and i + 3 == len(pattern):
            regex += "(/.*)?"
            i += 3
        elif pattern.startswith("/**/", i):
            # Interior /**/ matches zero or more intermediate directories:
            # a/**/b matches both a/b and a/x/y/b (standard glob semantics).
            regex += "/(.*/)?"
            i += 4
        elif pattern.startswith("**", i):
            regex += ".*"
            i += 2
        elif pattern[i] == "*":
            regex += "[^/]*"
            i += 1
        else:
            regex += re.escape(pattern[i])
            i += 1
    return re.fullmatch(regex, path) is not None


# ---------------------------------------------------------------------------
# Enforcer (reference hard_rule_enforcer.ex + schema_validator.ex)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpawnResolution:
    """What topology auto-injection adds to a spawn (reference
    TopologyResolver.apply_spawn_contract)."""
    node: Optional[str] = None
    skills: tuple[str, ...] = ()
    profile: Optional[str] = None
    constraints: Optional[str] = None
    model_pool: Optional[list[str]] = None
    capability_groups: Optional[list[str]] = None


class GroveEnforcer:
    """Runtime enforcement bound to one manifest. Every check takes the
    agent's node explicitly (no per-agent enforcer objects to keep in sync).
    Returns an error string to block, None to allow. In warn mode
    confinement violations log and pass; hard rules ALWAYS block
    (reference README.md:450-486 — hard rules are absolute, confinement has
    strict/warn)."""

    def __init__(self, manifest: GroveManifest):
        self.manifest = manifest
        self._schema_cache: dict[str, Any] = {}
        # base for relative confinement/schema patterns: the workspace,
        # falling back to the grove directory
        self._pattern_base = (_expand(manifest.workspace)
                              if manifest.workspace else manifest.path)

    # -- hard rules ----------------------------------------------------

    def _rules_for(self, node: Optional[str], rule_type: str):
        for rule in self.manifest.hard_rules:
            if rule.type != rule_type:
                continue
            if rule.scope and (node is None or node not in rule.scope):
                continue
            yield rule

    def check_shell_command(self, command: str,
                            node: Optional[str]) -> Optional[str]:
        for rule in self._rules_for(node, "shell_pattern_block"):
            if rule.pattern and re.search(rule.pattern, command):
                return (f"blocked by grove hard rule: "
                        f"{rule.message or rule.pattern}")
        return None

    def blocked_actions(self, node: Optional[str]) -> set[str]:
        """Feeds AgentConfig.forbidden_actions → capability filtering
        (reference consensus_handler.ex:294-313)."""
        out: set[str] = set()
        for rule in self._rules_for(node, "action_block"):
            out.update(rule.actions)
        return out

    # -- confinement ---------------------------------------------------

    def _confinement_for(self, node: Optional[str]) -> Optional[dict]:
        if node is None:
            return None
        return self.manifest.confinement.get(node)

    def check_file_path(self, path: str, *, write: bool,
                        node: Optional[str]) -> Optional[str]:
        conf = self._confinement_for(node)
        if conf is None:
            return None
        real = _resolve_real(path)
        writable = [p for p in conf.get("paths") or ()]
        readable = writable + [p for p in conf.get("read_only_paths") or ()]
        allowed = writable if write else readable
        if any(_glob_match(real, pat, self._pattern_base)
               for pat in allowed):
            return None
        verb = "write" if write else "read"
        msg = (f"confinement: {verb} of {path!r} is outside the allowed "
               f"paths for node {node!r}")
        if self.manifest.confinement_mode == "strict":
            return msg
        logger.warning("%s (warn mode: allowing)", msg)
        return None

    def check_working_dir(self, path: str,
                          node: Optional[str]) -> Optional[str]:
        conf = self._confinement_for(node)
        if conf is None:
            return None
        return self.check_file_path(path, write=True, node=node)

    # -- schema validation (reference schema_validator.ex) -------------

    def validate_file_schema(self, path: str, content: str) -> Optional[str]:
        real = _resolve_real(path)
        for rule in self.manifest.schemas:
            if rule.validate_on != "file_write":
                continue
            # relative path_patterns resolve against the workspace — never
            # as a floating suffix match anywhere on the filesystem
            if not _glob_match(real, rule.path_pattern, self._pattern_base):
                continue
            try:
                payload = json.loads(content)
            except json.JSONDecodeError as e:
                return f"schema {rule.name}: payload is not JSON ({e})"
            schema = self._schema_cache.get(rule.definition)
            if schema is None:
                try:
                    with open(os.path.join(self.manifest.path,
                                           rule.definition)) as f:
                        schema = json.load(f)
                except (OSError, json.JSONDecodeError) as e:
                    return f"schema {rule.name}: cannot load definition ({e})"
                self._schema_cache[rule.definition] = schema
            try:
                jsonschema_lite.validate(payload, schema)
            except jsonschema_lite.ValidationError as e:
                return f"schema {rule.name}: {e.message}"
        return None

    # -- topology (reference TopologyResolver / SpawnContractResolver) --

    def resolve_spawn(self, parent_node: Optional[str],
                      params: dict) -> SpawnResolution:
        """Find the edge this spawn follows and apply its contract. With one
        outgoing edge the child node is implied; with several, the spawn's
        requested profile/skills pick the edge."""
        if parent_node is None:
            # An agent outside the topology isn't constrained by it.
            return SpawnResolution(node=None)
        edges = [e for e in self.manifest.edges if e.parent == parent_node]
        if not edges:
            # Fail closed: a node with no outgoing edges may not spawn —
            # otherwise its children would escape every node-scoped rule.
            raise GroveError(
                f"grove topology: node {parent_node!r} has no outgoing "
                f"edges; it may not spawn children")
        edge: Optional[TopologyEdge] = None
        if len(edges) == 1:
            edge = edges[0]
        else:
            wanted = set(params.get("skills") or ())
            wanted.add(params.get("profile"))
            for e in edges:
                if e.child in wanted:
                    edge = e
                    break
        if edge is None:
            raise GroveError(
                f"grove topology: node {parent_node!r} has multiple child "
                f"node types ({', '.join(e.child for e in edges)}); name "
                f"one via the spawn profile or skills params")
        inject = edge.auto_inject
        return SpawnResolution(
            node=edge.child,
            skills=tuple(inject.get("skills") or ()),
            profile=inject.get("profile"),
            constraints=inject.get("constraints"),
            model_pool=inject.get("model_pool"),
            capability_groups=inject.get("capability_groups"),
        )

    # -- governance docs (reference GovernanceResolver) -----------------

    def governance_docs_for(self, node: Optional[str]) -> Optional[str]:
        chunks: list[tuple[int, str]] = []
        for inj in self.manifest.injections:
            targets = inj.get("inject_into") or ()
            if targets and (node is None or node not in targets):
                continue
            source = os.path.join(self.manifest.path, inj.get("source", ""))
            try:
                with open(source) as f:
                    text = f.read().strip()
            except OSError:
                logger.warning("governance injection source missing: %s",
                               source)
                continue
            prio = 0 if inj.get("priority") == "high" else 1
            chunks.append((prio, text))
        if not chunks:
            return None
        return "\n\n".join(text for _, text in sorted(chunks,
                                                      key=lambda c: c[0]))

    # -- bootstrap (reference BootstrapResolver) ------------------------

    def bootstrap_fields(self) -> dict:
        """Pre-fill for task creation: file-backed fields are read from the
        grove directory."""
        b = dict(self.manifest.bootstrap)
        for key, target in (("global_context_file", "global_context"),
                            ("task_description_file", "task_description"),
                            ("success_criteria_file", "success_criteria")):
            rel = b.pop(key, None)
            if rel:
                try:
                    with open(os.path.join(self.manifest.path, rel)) as f:
                        b[target] = f.read().strip()
                except OSError:
                    logger.warning("bootstrap file missing: %s", rel)
        return b

    def skills_loader(self, global_dir: Optional[str] = None) -> SkillsLoader:
        return SkillsLoader(global_dir=global_dir,
                            grove_dir=self.manifest.skills_dir)

    def workspace_dir(self) -> Optional[str]:
        if not self.manifest.workspace:
            return None
        return _expand(self.manifest.workspace)
