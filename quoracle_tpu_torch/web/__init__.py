"""Web dashboard: 3-panel live UI + JSON/SSE API over the event bus.

Replaces the reference's Phoenix LiveView layer (reference
lib/quoracle_web/ — DashboardLive 3-panel task tree / log viewer / mailbox,
SecretManagementLive settings, /healthz; SURVEY.md §2.7) with a thin
stdlib HTTP server: the browser consumes the same event-bus topics over
Server-Sent Events that LiveView consumed over websockets, and state
mounts replay from EventHistory + the durable tables exactly like
LiveView's mount-replay (reference ui/event_history.ex:17-20).

The PyTorch port's copy of ``quoracle_tpu/web/``.
"""

from quoracle_tpu_torch.web.server import DashboardServer

__all__ = ["DashboardServer"]
