"""Skills: loadable instruction packages (SKILL.md files).

Parity with the reference's Skills.Loader / Creator (reference
lib/quoracle/skills/loader.ex:22-41,63-70 — SKILL.md = YAML frontmatter +
markdown body; a grove-local skills/ directory shadows the global one;
skills are listed in the system prompt and loaded at runtime via the
learn_skills action, which invalidates the cached system prompt,
reference core.ex:338-341).

The PyTorch port's copy of ``quoracle_tpu/governance/skills.py``. The
frontmatter is read and written by the port's YAML-subset reader
(``governance/frontmatter.py``), in place of PyYAML, which the machine
that serves the port on the GPU does not have.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

from quoracle_tpu_torch.governance import frontmatter

_FRONTMATTER_RE = re.compile(r"\A---\s*\n(.*?)\n---\s*\n?(.*)\Z", re.DOTALL)


class SkillError(ValueError):
    pass


@dataclasses.dataclass
class Skill:
    name: str
    description: str
    content: str
    path: Optional[str] = None
    source: str = "global"          # "global" | "grove"

    def as_dict(self) -> dict:
        return {"name": self.name, "description": self.description,
                "content": self.content}


def parse_skill_md(text: str, path: Optional[str] = None) -> Skill:
    m = _FRONTMATTER_RE.match(text)
    if not m:
        raise SkillError(f"not a SKILL.md (missing frontmatter): {path}")
    try:
        meta = frontmatter.load(m.group(1)) or {}
    except frontmatter.FrontmatterError as e:
        raise SkillError(f"bad frontmatter in {path}: {e}")
    if not isinstance(meta, dict) or not meta.get("name"):
        raise SkillError(f"frontmatter needs a name: {path}")
    return Skill(name=str(meta["name"]),
                 description=str(meta.get("description", "")).strip(),
                 content=m.group(2).strip(), path=path)


def render_skill_md(name: str, description: str, content: str) -> str:
    fm = frontmatter.dump_mapping({"name": name,
                                   "description": description}).strip()
    return f"---\n{fm}\n---\n\n{content.strip()}\n"


class SkillsLoader:
    """Loads skills from a global directory, optionally shadowed by a
    grove-local one (reference loader.ex:63-70: grove skills win on name
    collision). Layout: <dir>/<skill-name>/SKILL.md or <dir>/<name>.md."""

    def __init__(self, global_dir: Optional[str] = None,
                 grove_dir: Optional[str] = None):
        self.global_dir = global_dir
        self.grove_dir = grove_dir

    # ------------------------------------------------------------------

    def _scan_dir(self, directory: Optional[str], source: str) -> dict[str, Skill]:
        found: dict[str, Skill] = {}
        if not directory or not os.path.isdir(directory):
            return found
        for entry in sorted(os.listdir(directory)):
            full = os.path.join(directory, entry)
            candidates = []
            if os.path.isdir(full):
                candidates.append(os.path.join(full, "SKILL.md"))
            elif entry.endswith(".md") and entry != "README.md":
                candidates.append(full)
            for c in candidates:
                if not os.path.isfile(c):
                    continue
                try:
                    with open(c) as f:
                        skill = parse_skill_md(f.read(), path=c)
                    skill.source = source
                    found[skill.name] = skill
                except (SkillError, OSError):
                    continue  # malformed skill files never break listing
        return found

    def all(self) -> dict[str, Skill]:
        skills = self._scan_dir(self.global_dir, "global")
        skills.update(self._scan_dir(self.grove_dir, "grove"))  # shadows
        return skills

    def load(self, name: str) -> Optional[Skill]:
        return self.all().get(name)

    def listing(self) -> list[dict]:
        """name+description dicts for the system prompt's Available Skills
        section."""
        return [{"name": s.name, "description": s.description}
                for s in self.all().values()]

    def search(self, query: str) -> list[Skill]:
        q = query.lower()
        return [s for s in self.all().values()
                if q in s.name.lower() or q in s.description.lower()]

    # ------------------------------------------------------------------

    def create(self, name: str, description: str, content: str) -> Skill:
        """Author a new skill into the global directory (reference
        skills/creator.ex)."""
        if not self.global_dir:
            raise SkillError("no global skills directory configured")
        if not re.fullmatch(r"[A-Za-z0-9_\-]+", name):
            raise SkillError(f"invalid skill name {name!r}")
        skill_dir = os.path.join(self.global_dir, name)
        os.makedirs(skill_dir, exist_ok=True)
        path = os.path.join(skill_dir, "SKILL.md")
        with open(path, "w") as f:
            f.write(render_skill_md(name, description, content))
        return Skill(name=name, description=description,
                     content=content.strip(), path=path)
