"""Deterministic fleet-workload simulator of the PyTorch port (port of
``quoracle_tpu/sim/``; host code, no device work but the spot checks).

Three parts, one contract:

* :mod:`quoracle_tpu_torch.sim.workload` — a composable, seeded generator of
  traffic traces (diurnal tenant mixes, burst storms, recursive
  agent-tree fan-outs, a long-tail population of mostly-hibernated
  sessions). A trace is a reproducible artifact: pure
  ``sha256(seed:stream:n)`` draws, no wall clock, no ``random``,
  serializable to JSON byte-for-byte.
* :mod:`quoracle_tpu_torch.sim.replay` — a compressed-time replay driver: a
  virtual clock walks the trace event by event against a deterministic
  capacity/tier-ladder model (optionally spot-checking a sampled subset
  through a real ClusterPlane/FabricPlane), recording every outcome
  into a ledger. Same trace, same ledger — bit-identical.
* :mod:`quoracle_tpu_torch.sim.gate` — the chaos invariant catalog extended
  with workload-level postconditions (SLO attainment per class, goodput
  floor, no-silent-loss over the full ledger, hibernation-tier
  conservation, temp-0 spot equality), run as tier-1 scenarios.
* :mod:`quoracle_tpu_torch.sim.calibrate` — measured-profile calibration
  fit the CapacityModel's service-time parameters from a
  recorded chip-economics ledger (infra/costobs.py) and gate the fit on
  the calibrated replay reproducing the measured TTFT distribution.

The simulator is the serving plane's acceptance gate: every later
policy change (adaptive consensus gating, predictive autoscaling,
fabric burn-in) replays the same traces and must keep the same
invariants green.
"""

from quoracle_tpu_torch.sim.workload import (  # noqa: F401
    SimEvent, Trace, WorkloadSpec, generate,
)
from quoracle_tpu_torch.sim.replay import ReplayDriver, SIM  # noqa: F401
from quoracle_tpu_torch.sim.gate import (  # noqa: F401
    SIM_SCENARIOS, run_sim_scenario,
)
# NOTE: the fit entry point stays at quoracle_tpu_torch.sim.calibrate.calibrate —
# re-exporting a name equal to its own submodule would shadow the module
# object on the package.
from quoracle_tpu_torch.sim.calibrate import (  # noqa: F401
    CalibrationReport, fit_capacity, record_profile, ttft_gate,
)
