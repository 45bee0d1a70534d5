"""Infra services of the PyTorch port: the NO_EXECUTE wrapping of
untrusted content so far (the bus, telemetry and ledgers are not ported
yet)."""
