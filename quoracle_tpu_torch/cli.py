"""CLI entry: run tasks from the terminal.

The reference is a Phoenix server driven from a browser; this build adds
a first-class CLI (the minimum end-to-end slice of SURVEY.md §7: "CLI
task entry"). The web dashboard consumes the same Runtime.

The PyTorch port's copy of ``quoracle_tpu/cli.py``, installed as
``quoracle-tpu-torch``. ``--backend torch`` serves with ``TorchBackend``
on ``--device`` (default: the GPU, and it raises without one; ``cpu``
serves the plain PyTorch paths). Flags whose modules the port has not
got reach the ``NotImplementedError`` of ``RuntimeConfig`` that names
their ROADMAP item.

Usage:
    quoracle-tpu-torch run "describe the task" \
        [--backend mock|torch] [--device cpu] [--pool xla:llama-3-8b,...] \
        [--db path.db] [--budget 5.00] [--profile name] [--grove DIR] \
        [--watch-seconds 30]
    quoracle-tpu-torch resume --db path.db      # boot revival
    quoracle-tpu-torch serve --db path.db [--host 127.0.0.1 --port 8400]
    quoracle-tpu-torch status --db path.db
    quoracle-tpu-torch show-prompts <scenario>|all
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from quoracle_tpu_torch.infra.bus import TOPIC_ACTIONS, TOPIC_LIFECYCLE
from quoracle_tpu_torch.runtime import Runtime, RuntimeConfig


def _print_event(topic: str, event: dict) -> None:
    kind = event.get("event")
    agent = event.get("agent_id", "")
    if kind == "agent_spawned":
        line = f"+ {agent} spawned (parent={event.get('parent_id')})"
    elif kind in ("agent_terminated", "agent_dismissed"):
        line = f"- {agent} {kind.split('_')[1]}"
    elif kind == "action_started":
        line = f"  {agent} → {event.get('action')}"
    elif kind == "action_completed":
        line = f"  {agent} ✓ {event.get('action')} [{event.get('status')}]"
    elif kind == "decision":
        d = event.get("decision", {})
        line = (f"  {agent} decided {d.get('action')} "
                f"(confidence {d.get('confidence')}, rounds {d.get('rounds')})")
    elif kind == "task_message":
        m = event.get("message", {})
        line = f"  ✉ {m.get('from')} → {m.get('targets')}: {m.get('content')}"
    else:
        return
    print(line, flush=True)


def _attach_printer(rt: Runtime) -> None:
    rt.bus.subscribe(TOPIC_LIFECYCLE, _print_event)
    rt.bus.subscribe(TOPIC_ACTIONS, _print_event)


def _parse_drafts(drafts) -> dict:
    """--draft TARGET=DRAFT (repeatable) -> draft_map dict."""
    out = {}
    for item in drafts or []:
        target, sep, draft = item.partition("=")
        if not sep or not target or not draft:
            raise SystemExit(f"--draft expects TARGET=DRAFT, got {item!r}")
        out[target] = draft
    return out


def _config(args: argparse.Namespace, **extra) -> RuntimeConfig:
    """The RuntimeConfig of the common flags (``run``, ``resume`` and
    ``serve`` take the same ones)."""
    return RuntimeConfig(
        db_path=args.db, backend=args.backend, device=args.device,
        checkpoints=args.checkpoints, tp=args.tp,
        image_backend=args.image_backend,
        coordinator_address=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
        draft_map=_parse_drafts(args.drafts) or None,
        draft_k=args.draft_k,
        continuous=args.continuous, qos=args.qos or None,
        host_kv_mb=args.host_kv_mb, disk_kv_dir=args.disk_kv_dir,
        disk_kv_gb=args.disk_kv_gb,
        replicas=args.replicas, disaggregate=args.disaggregate,
        fabric_listen=args.fabric_listen,
        fabric_peers=(args.fabric_peers.split(",")
                      if args.fabric_peers else None),
        prefixd=args.prefixd, chaos_plan=args.chaos_plan,
        quantize_weights=args.quantize_weights,
        quantize_kv=args.quantize_kv,
        fleet_min=args.fleet_min, fleet_max=args.fleet_max,
        fleet_tick_s=args.fleet_tick_s,
        sim_trace=args.sim_trace, sim_seed=args.sim_seed,
        capture_dir=args.capture_dir, capture_mb=args.capture_mb,
        **extra)


async def cmd_run(args: argparse.Namespace) -> int:
    pool = args.pool.split(",") if args.pool else None
    rt = Runtime(_config(args, model_pool=pool))
    _attach_printer(rt)
    if pool is None and args.profile is None:
        pool = rt.default_pool()
    task_id, root = await rt.tasks.create_task(
        args.description, model_pool=pool, profile=args.profile,
        budget=args.budget, grove=args.grove)
    rt.bus.subscribe(f"agents:{root.agent_id}:logs", _print_event)
    rt.bus.subscribe(f"tasks:{task_id}:messages", _print_event)
    print(f"task {task_id} started, root agent {root.agent_id}", flush=True)
    try:
        await asyncio.sleep(args.watch_seconds)
    finally:
        await rt.tasks.pause_task(task_id)
        print(json.dumps(rt.status()), flush=True)
        rt.close()
    return 0


async def cmd_resume(args: argparse.Namespace) -> int:
    rt = Runtime(_config(args))
    _attach_printer(rt)
    result = await rt.boot()
    print(json.dumps(result), flush=True)
    try:
        await asyncio.sleep(args.watch_seconds)
    finally:
        for task_id in result.get("revived", []):
            await rt.tasks.pause_task(task_id)
        rt.close()
    return 0


async def cmd_serve(args: argparse.Namespace) -> int:
    from quoracle_tpu_torch.web import DashboardServer
    rt = Runtime(_config(
        args, model_pool=args.pool.split(",") if args.pool else None))
    # Validate host/token BEFORE boot so a refused bind exits with a clean
    # message instead of a traceback over a half-started runtime.
    try:
        server = DashboardServer(rt, host=args.host, port=args.port,
                                 auth_token=args.token)
    except ValueError as e:
        print(f"error: {e}", flush=True)
        rt.close()
        return 2
    _attach_printer(rt)
    result = await rt.boot()
    if result["revived"]:
        print(f"revived tasks: {result['revived']}", flush=True)
    server = await server.start()
    print(f"dashboard at {server.url}", flush=True)
    try:
        while True:
            await asyncio.sleep(3600)
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await server.stop()
        await rt.shutdown()
    return 0


async def cmd_status(args: argparse.Namespace) -> int:
    rt = Runtime(RuntimeConfig(db_path=args.db))
    print(json.dumps(rt.status(), indent=2))
    rt.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="quoracle-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--db", default=":memory:")
        sp.add_argument("--backend", choices=["mock", "torch"],
                        default="mock")
        sp.add_argument("--device", default=None,
                        help="the torch backend's device: the GPU when "
                             "unset (raises without one); cpu serves the "
                             "plain PyTorch paths")
        sp.add_argument("--watch-seconds", type=float, default=30.0)
        sp.add_argument("--checkpoint", action="append", dest="checkpoints",
                        metavar="DIR",
                        help="HF checkpoint dir to register + serve "
                             "(repeatable; implies the pool when --pool "
                             "is unset)")
        sp.add_argument("--tp", type=int, default=None,
                        help="tensor-parallel size per pool member "
                             "(multi-GPU: not ported)")
        sp.add_argument("--image-backend", dest="image_backend",
                        choices=["procedural", "diffusion"],
                        default="procedural",
                        help="generate_images backend: placeholder PNGs "
                             "(diffusion is not ported)")
        sp.add_argument("--draft", action="append", dest="drafts",
                        metavar="TARGET=DRAFT",
                        help="speculative serving: draft model spec for a "
                             "pool member, e.g. xla:llama-3-8b=xla:draft "
                             "(repeatable; models/speculative.py)")
        sp.add_argument("--draft-k", dest="draft_k", type=int, default=6,
                        help="speculative serving: initial draft length K "
                             "per round (adaptive under --continuous — "
                             "shrinks on low acceptance, falls back to "
                             "vanilla below the floor and re-probes)")
        sp.add_argument("--coordinator", dest="coordinator", default=None,
                        help="multi-process serving: coordinator address "
                             "(not ported)")
        sp.add_argument("--num-processes", dest="num_processes", type=int,
                        default=None)
        sp.add_argument("--process-id", dest="process_id", type=int,
                        default=None)
        sp.add_argument("--continuous", action="store_true",
                        help="decode-level continuous batching for the "
                             "torch backend (models/scheduler.py)")
        sp.add_argument("--host-kv-mb", dest="host_kv_mb", type=int,
                        default=0,
                        help="tiered KV (serving/kvtier.py): host-RAM "
                             "budget per pool member for hibernated "
                             "sessions and stripped prefix blocks; "
                             "0 disables the host tier unless "
                             "--disk-kv-dir is set (then 256 MB)")
        sp.add_argument("--disk-kv-dir", dest="disk_kv_dir", default=None,
                        help="tiered KV: directory of the checksummed "
                             "disk prefix store — a restarted process "
                             "warm-starts from its predecessor's "
                             "prefixes; corrupt entries are skipped")
        sp.add_argument("--disk-kv-gb", dest="disk_kv_gb", type=float,
                        default=8.0,
                        help="byte budget of the disk prefix store per "
                             "pool member (GiB): oldest-LRU entries "
                             "prune when a write overflows it; 0 = "
                             "unbounded")
        sp.add_argument("--quantize-weights", dest="quantize_weights",
                        action="store_true",
                        help="quantized serving (models/quant.py): "
                             "per-channel symmetric int8 weights")
        sp.add_argument("--quantize-kv", dest="quantize_kv",
                        action="store_true",
                        help="quantized serving: int8 KV pages with "
                             "per-(token, kv-head) scales beside them")
        sp.add_argument("--replicas", type=int, default=1,
                        help="disaggregated serving plane "
                             "(serving/cluster.py): run N full replicas "
                             "of the pool on the --device behind a "
                             "QoS-aware router")
        sp.add_argument("--disaggregate", action="store_true",
                        help="role-tag the replicas into prefill (first "
                             "token + KV) and decode (continuous "
                             "batching + speculation) tiers with KV "
                             "handoff between them; implies --replicas "
                             "2 when unset")
        sp.add_argument("--fleet-min", dest="fleet_min", type=int,
                        default=1,
                        help="elastic fleet (serving/fleet.py): "
                             "serving-tier replica lower bound")
        sp.add_argument("--fleet-max", dest="fleet_max", type=int,
                        default=0,
                        help="elastic fleet: arm the FleetController "
                             "over the cluster (scale within "
                             "[--fleet-min, this], re-tier, drain by "
                             "live session migration); 0 keeps the boot "
                             "topology; requires --replicas/"
                             "--disaggregate")
        sp.add_argument("--fleet-tick-s", dest="fleet_tick_s",
                        type=float, default=5.0,
                        help="elastic fleet: seconds between policy "
                             "ticks (paces the ticker thread only)")
        sp.add_argument("--fabric-listen", dest="fabric_listen",
                        default=None, metavar="[ROLE@]HOST:PORT",
                        help="cluster fabric replica peer (not ported)")
        sp.add_argument("--fabric-peers", dest="fabric_peers",
                        default=None, metavar="[ROLE@]HOST:PORT,...",
                        help="cluster fabric front door (not ported)")
        sp.add_argument("--prefixd", default=None, metavar="HOST:PORT",
                        help="fleet prefix service (not ported)")
        sp.add_argument("--chaos-plan", dest="chaos_plan", default=None,
                        metavar="PLAN.json",
                        help="chaos plane (chaos/faults.py): arm this "
                             "JSON fault plan ({'seed': N, 'faults': "
                             "[{'point', 'kind', ...}]}) at boot")
        sp.add_argument("--sim-trace", dest="sim_trace", default=None,
                        metavar="TRACE.json",
                        help="fleet simulator trace (not ported)")
        sp.add_argument("--sim-seed", dest="sim_seed", default=None,
                        type=int, metavar="N",
                        help="fleet simulator seed (not ported)")
        sp.add_argument("--capture-dir", dest="capture_dir", default=None,
                        metavar="DIR",
                        help="serving flywheel capture store (not ported)")
        sp.add_argument("--capture-mb", dest="capture_mb", type=float,
                        default=256.0,
                        help="capture store disk budget (not ported)")
        sp.add_argument("--qos", action="store_true",
                        help="serving QoS: weighted-fair admission + "
                             "overload shedding + SLO demotion with "
                             "default thresholds; tenants via the "
                             "qos_tenants setting + serving/qos.QoSConfig")

    runp = sub.add_parser("run", help="create a task and watch it")
    runp.add_argument("description")
    runp.add_argument("--pool", help="comma-separated model specs")
    runp.add_argument("--profile")
    runp.add_argument("--budget")
    runp.add_argument("--grove", help="grove directory (topology + "
                                      "governance manifest)")
    common(runp)

    resp = sub.add_parser("resume", help="boot revival of persisted tasks")
    common(resp)

    servep = sub.add_parser("serve", help="run the web dashboard")
    servep.add_argument("--host", default="127.0.0.1")
    servep.add_argument("--port", type=int, default=8400)
    servep.add_argument("--pool", help="comma-separated model specs")
    servep.add_argument("--token", default=None,
                        help="dashboard auth token (default: env "
                             "QUORACLE_DASHBOARD_TOKEN); required for "
                             "non-loopback --host")
    common(servep)

    statp = sub.add_parser("status", help="show tasks + agents")
    statp.add_argument("--db", default=":memory:")

    showp = sub.add_parser(
        "show-prompts",
        help="dump verbatim LLM prompts for a named scenario (the "
             "reference's mix quoracle.show_llm_prompts)")
    showp.add_argument("scenario", nargs="?", default=None)
    showp.add_argument("--write-golden", metavar="DIR", default=None)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "show-prompts":
        from quoracle_tpu_torch.tools.show_prompts import main as show_main
        if args.write_golden:
            return show_main(["--write-golden", args.write_golden])
        return show_main([args.scenario] if args.scenario else [])
    handler = {"run": cmd_run, "resume": cmd_resume,
               "serve": cmd_serve, "status": cmd_status}[args.cmd]
    return asyncio.run(handler(args))


if __name__ == "__main__":
    sys.exit(main())
