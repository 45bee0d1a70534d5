"""Governance layer of the PyTorch port: capability gating, prompt fields,
skills and groves. Profiles are rows of the persistence layer
(``persistence/store.py``, resolved by ``TaskManager.resolve_profile``).
Manifests and skills are read by ``frontmatter.py`` and grove schemas
checked by ``jsonschema_lite.py``, the port's own subsets of PyYAML and
``jsonschema``."""

from quoracle_tpu_torch.governance.capabilities import (  # noqa: F401
    allowed_actions_for_groups, filter_actions, validate_groups,
)
from quoracle_tpu_torch.governance.fields import (  # noqa: F401
    AgentFields, accumulate_constraints, compose_field_prompt,
)
from quoracle_tpu_torch.governance.grove import (  # noqa: F401
    GroveEnforcer, GroveManifest, list_groves, load_grove,
)
from quoracle_tpu_torch.governance.skills import Skill, SkillsLoader  # noqa: F401
