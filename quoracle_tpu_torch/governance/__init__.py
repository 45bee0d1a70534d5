"""Governance layer of the PyTorch port: capability gating so far
(profiles, groves, skills and prompt fields are not ported yet)."""
