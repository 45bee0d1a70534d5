"""Infra services of the PyTorch port: the NO_EXECUTE wrapping of
untrusted content (injection.py), named locks (locks.py), metrics and
tracing (telemetry.py), the flight recorder (flightrec.py), the fleet,
cost, tree and liveness planes (fleetobs.py, costobs.py, treeobs.py,
introspect.py) and device-memory accounting (resources.py). The event bus
is not ported yet."""
