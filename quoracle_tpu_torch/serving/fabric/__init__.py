"""Cross-host cluster fabric of the PyTorch port (port of
``quoracle_tpu/serving/fabric/``).

The in-process ClusterPlane (serving/cluster.py) made the replica a
boundary inside one process; this package makes it a WIRE boundary,
with temperature-0 outputs unchanged. Four pieces:

* :mod:`~quoracle_tpu_torch.serving.fabric.wire`: the length-prefixed,
  crc-framed, versioned binary codec (frames, JSON control messages, the
  HandoffEnvelope blob whose KV signature is checked before any page
  byte is read). Its bytes are the JAX package's, so either package
  decodes the other's frames.
* :mod:`~quoracle_tpu_torch.serving.fabric.transport`: how frames move,
  a threaded TCP peer with connect, read and write deadlines and bounded
  retry with backoff, and :class:`LoopbackTransport`, which runs every
  wire path in one process without a socket.
* :mod:`~quoracle_tpu_torch.serving.fabric.prefixd`: the fleet prefix
  service, the content-addressed ``DiskPrefixStore`` served over the wire,
  with a read-through client wired into ``TierManager.extend_prefix``.
* :mod:`~quoracle_tpu_torch.serving.fabric.peer` and
  :mod:`~quoracle_tpu_torch.serving.fabric.frontdoor`: the two process
  roles. A FabricPeer serves one replica's ``TorchBackend`` over the
  wire; the FabricPlane front door places, admits and hands off across
  remote peers through the ClusterRouter.

``wire`` and ``transport`` import nothing of the serving stack at module
level; the peer and the front door load lazily.
"""


def __getattr__(name: str):
    if name in ("WireError", "TransportError"):
        from quoracle_tpu_torch.serving.fabric import wire
        return getattr(wire, name)
    if name in ("LoopbackTransport", "TcpTransport", "PeerServer"):
        from quoracle_tpu_torch.serving.fabric import transport
        return getattr(transport, name)
    if name in ("PrefixService", "PrefixdClient"):
        from quoracle_tpu_torch.serving.fabric import prefixd
        return getattr(prefixd, name)
    if name == "FabricPeer":
        from quoracle_tpu_torch.serving.fabric.peer import FabricPeer
        return FabricPeer
    if name == "FabricPlane":
        from quoracle_tpu_torch.serving.fabric.frontdoor import FabricPlane
        return FabricPlane
    raise AttributeError(name)
