"""Infra services of the PyTorch port: the NO_EXECUTE wrapping of
untrusted content, the serving metrics (telemetry.py) and the device
memory headroom signal (resources.py). The bus, tracing and ledgers are
not ported yet."""
