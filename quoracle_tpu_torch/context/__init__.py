"""Context/knowledge layer: token budgeting, message assembly, condensation, ACE.

Sits between the agent runtime and the model runtime (SURVEY.md §1 layer 7):
per-model conversation histories are budgeted with EXACT token counts from
each model's real tokenizer (the reference estimated with tiktoken cl100k +
a 12% safety margin — reference lib/quoracle/agent/token_manager.ex:19-24,
per_model_query.ex:20-24; exact counts shrink that margin to ~2%), assembled
into chat messages in a fixed injection order, and condensed with ACE
reflection when a model's window fills.

The PyTorch port's copy of ``quoracle_tpu/context/``: pure Python but
for ``backend.embed`` (lesson dedupe) and the reflector's queries, which
run through the port's ``TorchBackend`` on the card.
"""

from quoracle_tpu_torch.context.history import AgentContext, HistoryEntry
from quoracle_tpu_torch.context.token_manager import TokenManager
from quoracle_tpu_torch.context.message_builder import build_messages_for_model

__all__ = ["AgentContext", "HistoryEntry", "TokenManager",
           "build_messages_for_model"]
