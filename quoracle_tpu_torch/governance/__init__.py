"""Governance layer of the PyTorch port: capability gating, prompt fields
and skills. Profiles are rows of the persistence layer
(``persistence/store.py``, resolved by ``TaskManager.resolve_profile``);
groves are not ported yet (ROADMAP Queue 1 item 9, second bullet)."""

from quoracle_tpu_torch.governance.capabilities import (  # noqa: F401
    allowed_actions_for_groups, filter_actions, validate_groups,
)
from quoracle_tpu_torch.governance.fields import (  # noqa: F401
    AgentFields, accumulate_constraints, compose_field_prompt,
)
from quoracle_tpu_torch.governance.skills import Skill, SkillsLoader  # noqa: F401
