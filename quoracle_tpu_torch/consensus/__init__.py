"""Consensus pipeline of the PyTorch port: the decision core.

The port's own copy of ``quoracle_tpu/consensus/``: every agent decision
queries a pool of models (``ModelBackend.query``, one batched generate
per pool member on ``TorchBackend``), parses and validates the proposed
actions, clusters them by schema-aware fingerprints (semantic parameters
through the backend's embedder), and either takes the majority action or
runs refinement rounds with temperature descent until one emerges.
"""

from quoracle_tpu_torch.consensus.engine import (  # noqa: F401
    ConsensusEngine, ConsensusOutcome,
)
