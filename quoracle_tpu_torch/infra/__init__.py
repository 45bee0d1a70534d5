"""Infra services of the PyTorch port: the NO_EXECUTE wrapping of
untrusted content (injection.py), named locks (locks.py), metrics and
tracing (telemetry.py), the flight recorder (flightrec.py), the fleet,
cost, tree and liveness planes (fleetobs.py, costobs.py, treeobs.py,
introspect.py), device-memory accounting (resources.py), the event bus
(bus.py), escrow and costs (budget.py, costs.py), secrets
(security.py), the UI's event rings (event_history.py) and the world
actions' transports: HTTP with its SSRF guard (http.py) and MCP
(mcp.py)."""
