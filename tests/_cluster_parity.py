"""Shared set-up of the multi-replica parity tests
(tests/test_torch_{chaos_faults,cluster,fleet,chaos,fabric,fabric_obs,
sim}.py): each package's serving plane over the same fp32 tiny weights
(tests/_torch_parity.py).

The JAX planes build their replicas with ``TPUBackend(pool, ...)``, which
draws random weights per package. :func:`jax_shared_backends` swaps the
JAX ``TPUBackend`` that ``serving/cluster.py`` and the chaos scenarios
reach for a subclass that hands it engines over the shared weights; the
port's planes take the same engines through ``engine_factory``. Both
factories pin the unified ragged tier, the tier the card serves.
:func:`build_peer` and :func:`remote` do the same for the cross-host
fabric's peers, joined to a front door over ``LoopbackTransport``.
"""

import contextlib
import functools
import types

from _torch_parity import both_configs, shared_params
from quoracle_tpu.chaos import faults as jfaults
from quoracle_tpu.chaos import invariants as jinv
from quoracle_tpu.chaos import scenarios as jscen
from quoracle_tpu.infra import fleetobs as jfleetobs
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.serving import admission as jadm
from quoracle_tpu.serving import cluster as jcl
from quoracle_tpu.serving import fleet as jfl
from quoracle_tpu.serving import handoff as jho
from quoracle_tpu.serving import router as jro
from quoracle_tpu.serving.fabric import frontdoor as jdoor
from quoracle_tpu.serving.fabric import peer as jpeer
from quoracle_tpu.serving.fabric import transport as jtr
from quoracle_tpu_torch.chaos import faults as tfaults
from quoracle_tpu_torch.chaos import invariants as tinv
from quoracle_tpu_torch.chaos import scenarios as tscen
from quoracle_tpu_torch.infra import fleetobs as tfleetobs
from quoracle_tpu_torch.infra import locks as tlocks
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.serving import admission as tadm
from quoracle_tpu_torch.serving import cluster as tcl
from quoracle_tpu_torch.serving import fleet as tfl
from quoracle_tpu_torch.serving import handoff as tho
from quoracle_tpu_torch.serving import router as tro
from quoracle_tpu_torch.serving.fabric import frontdoor as tdoor
from quoracle_tpu_torch.serving.fabric import peer as tpeer
from quoracle_tpu_torch.serving.fabric import transport as ttr

MEMBER = "xla:tiny"
KW = dict(max_seq=512, prompt_buckets=(32, 64, 128, 256))


@functools.cache
def _weights():
    return shared_params("tiny", seed=7)


def jax_engine(spec=MEMBER, quantize_weights=False, quantize_kv=False):
    jcfg, _ = both_configs(spec.split(":", 1)[1])
    params, _ = _weights()
    eng = jgen.GenerateEngine(jcfg, params, jtok.get_tokenizer(spec),
                              quantize_weights=quantize_weights,
                              quantize_kv=quantize_kv, **KW)
    eng.unified_min_tokens = 0
    return eng


def port_engine(spec=MEMBER, quantize_weights=False, quantize_kv=False):
    _, tcfg = both_configs(spec.split(":", 1)[1])
    _, model = _weights()
    eng = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer(spec),
                              device="cpu",
                              quantize_weights=quantize_weights,
                              quantize_kv=quantize_kv, **KW)
    eng.unified_min_tokens = 0
    return eng


JAX = types.SimpleNamespace(
    name="jax", rt=jrt, cl=jcl, fl=jfl, ro=jro, ho=jho, adm=jadm,
    faults=jfaults, inv=jinv, scen=jscen, gen=jgen, engine=jax_engine,
    door=jdoor, peer=jpeer, tr=jtr, fleetobs=jfleetobs)
PORT = types.SimpleNamespace(
    name="port", rt=trt, cl=tcl, fl=tfl, ro=tro, ho=tho, adm=tadm,
    faults=tfaults, inv=tinv, scen=tscen, gen=tgen, engine=port_engine,
    door=tdoor, peer=tpeer, tr=ttr, fleetobs=tfleetobs)
SIDES = (JAX, PORT)


@contextlib.contextmanager
def jax_shared_backends():
    """While open, every ``TPUBackend(pool, ...)`` the JAX cluster and
    scenarios build serves engines over the shared weights (the drafts
    of its ``draft_map`` too)."""
    real = jrt.TPUBackend

    class SharedWeightsBackend(real):
        def __init__(self, pool, **kw):
            if kw.get("engines") is None:
                qkw = dict(quantize_weights=kw.get("quantize_weights",
                                                   False),
                           quantize_kv=kw.get("quantize_kv", False))
                engines = {}
                for spec in list(pool) + sorted(
                        set((kw.get("draft_map") or {}).values())):
                    if spec not in engines:
                        engines[spec] = jax_engine(spec, **qkw)
                kw["engines"] = engines
            super().__init__(pool, **kw)

    jrt.TPUBackend = SharedWeightsBackend
    jcl.TPUBackend = SharedWeightsBackend
    try:
        yield
    finally:
        jrt.TPUBackend = real
        jcl.TPUBackend = real


def backend(side, **kw):
    """A single backend of ``side`` over the shared weights."""
    if side is JAX:
        return jrt.TPUBackend([MEMBER], engines={MEMBER: jax_engine()},
                              **kw)
    return trt.TorchBackend([MEMBER], device="cpu",
                            engines={MEMBER: port_engine()}, **kw)


def build_cluster(side, **kw):
    """``ClusterPlane.build([MEMBER], ...)`` of ``side`` over the shared
    weights (the JAX side inside :func:`jax_shared_backends`)."""
    if side is JAX:
        with jax_shared_backends():
            return jcl.ClusterPlane.build([MEMBER], **kw)
    return tcl.ClusterPlane.build([MEMBER], device="cpu",
                                  engine_factory=port_engine, **kw)


@contextlib.contextmanager
def port_lockdep():
    """The port's lock-order sanitizer on for a case (the JAX one is on
    for the whole suite, tests/conftest.py), its ledger drained first."""
    was = tlocks.enabled()
    tlocks.enable()
    tlocks.LOCKDEP.drain()
    try:
        yield
    finally:
        if not was:
            tlocks.disable()


def build_peer(side, **kw):
    """``FabricPeer.build([MEMBER], ...)`` of ``side`` over the shared
    weights (the JAX side inside :func:`jax_shared_backends`)."""
    if side is JAX:
        with jax_shared_backends():
            return jpeer.FabricPeer.build([MEMBER], **kw)
    return tpeer.FabricPeer.build([MEMBER], device="cpu",
                                  engine_factory=port_engine, **kw)


def remote(side, peer, **kw):
    """A front door's replica of ``peer`` over the loopback fabric."""
    return side.cl.RemoteReplica(side.tr.LoopbackTransport(
        peer.handle, peer.replica_id, **kw))


@contextlib.contextmanager
def own_incidents(side):
    """While open, ``side``'s incident manager notifies only the front
    doors built inside. A front door another test left open would
    broadcast this case's incidents over its own links, and each send
    is a ``fabric.send`` fire of an armed plan: the schedule would then
    depend on which test files ran before in the process."""
    inc = side.fleetobs.INCIDENTS
    with inc._lock:
        saved, inc._notifiers = inc._notifiers, []
    try:
        yield
    finally:
        with inc._lock:
            inc._notifiers = saved + [fn for fn in inc._notifiers
                                      if fn not in saved]


def req(side, msgs, sid=None, cj=False, max_tokens=20, priority=None,
        tenant="default", temperature=0.0):
    return side.rt.QueryRequest(MEMBER, msgs, temperature=temperature,
                                max_tokens=max_tokens, session_id=sid,
                                constrain_json=cj, priority=priority,
                                tenant=tenant)


def res(r) -> tuple:
    """A QueryResult's comparable fields (latency and chip-ms dropped)."""
    return (r.model_spec, r.text, r.error, r.cached_tokens,
            r.usage.prompt_tokens, r.usage.completion_tokens,
            r.spec_rounds, r.permanent_error)


def both(case, *args) -> list:
    """Run ``case`` on each package; the observations must be equal."""
    jobs, tobs = (case(side, *args) for side in SIDES)
    assert tobs == jobs
    return tobs


def flight_view(events, kinds) -> list:
    """Flight records of ``kinds`` with ids, times and sequence numbers
    dropped."""
    drop = {"ts", "seq", "t", "plan", "wall_ms", "ms", "pid"}
    return [{k: v for k, v in e.items() if k not in drop}
            for e in events if e.get("kind") in kinds]
