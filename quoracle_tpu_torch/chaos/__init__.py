"""Chaos plane of the PyTorch port (port of ``quoracle_tpu/chaos/``):
deterministic fault injection (chaos/faults.py), machine-checked recovery
invariants (chaos/invariants.py), and the scenario harness that drives
the disaggregated stack through scripted storms (chaos/scenarios.py)."""

from quoracle_tpu_torch.chaos.faults import (  # noqa: F401
    CHAOS, ChaosPlane, Fault, FaultPlan, FaultRule, InjectedFault,
    INJECTION_POINTS,
)
