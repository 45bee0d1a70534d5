"""Temperature descent across refinement rounds.

Parity with the reference's Consensus.Temperature
(reference lib/quoracle/consensus/temperature.ex:28-98): round 1 samples hot
(exploration — distinct proposals surface disagreement), later rounds cool
linearly toward a floor (convergence). Per-model-family ceilings/floors; the
per-row temperature arrays feed straight into the batched sampler
(models/sampling.py) — the TPU design serves a DIFFERENT temperature per pool
member per round in one generate step.

The PyTorch port's own copy of
``quoracle_tpu/consensus/temperature.py``, line for line but for its
imports, so the parity tests can compare the two packages' outputs
field by field.
"""

from __future__ import annotations

# Families whose APIs accept temperature up to 2.0 in the reference
# (temperature.ex:28-32); kept as data for catalog growth.
_HIGH_CEILING_PREFIXES = ("gpt", "o1", "o3", "o4", "gemini")

_CEILING_HIGH = 2.0
_CEILING_DEFAULT = 1.0
_FLOOR_HIGH = 0.4
_FLOOR_DEFAULT = 0.2


def model_ceiling(model_spec: str) -> float:
    name = model_spec.split(":", 1)[-1].lower()
    if any(name.startswith(p) for p in _HIGH_CEILING_PREFIXES):
        return _CEILING_HIGH
    return _CEILING_DEFAULT


def model_floor(model_spec: str) -> float:
    return _FLOOR_HIGH if model_ceiling(model_spec) == _CEILING_HIGH \
        else _FLOOR_DEFAULT


def temperature_for_round(model_spec: str, round_num: int,
                          max_refinement_rounds: int = 4) -> float:
    """Linear descent ceiling -> floor adapted to the configured round budget
    (reference temperature.ex:84-98). round_num is 1-based; round 1 = initial
    query at the ceiling; the floor is reached at the final refinement round.
    """
    hi, lo = model_ceiling(model_spec), model_floor(model_spec)
    total_rounds = max(1, max_refinement_rounds)
    step = (hi - lo) / total_rounds
    t = hi - step * max(0, round_num - 1)
    return max(lo, round(t, 4))
