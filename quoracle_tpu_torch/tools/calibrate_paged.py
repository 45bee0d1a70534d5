"""Measure the paged tiers' crossovers ON THIS CARD and write the engine's
gate file (port of ``quoracle_tpu/tools/calibrate_paged.py``;
utils/calibration.py reads the file).

For each resident size in the sweep, times resumed rounds under the
unified, direct_full, direct_decode and gather paths (tools/
bench_longctx.py harness). The smallest resident size where a direct
path's p50 is at most gather's becomes its ``*_min_resident`` gate; a
path that never wins stays null (off). The UNIFIED gate works the other
way around: the unified tier is the card's default without a file, so
the sweep records where gather is the better fallback: unified winning at
the smallest size writes 0 (always on, the measured default made
explicit), winning only from a larger size writes that size, losing
everywhere writes null (gather is the measured default on this card).
The file records ``device_kind`` (the card's name), so the engine loads
it on this kind of card only; it goes to ``--out``, else
``$QUORACLE_PAGED_CALIB``, else ~/.cache/quoracle_tpu_torch/
paged_gates.json.

Run on the serving card, one process:

    python -m quoracle_tpu_torch.tools.calibrate_paged \\
        --sweep 1024 4096 16384 --out build/paged_gates.json

``--prefer-memory`` enables a direct path at its smallest MEASURED size
even when it loses on latency (within ``--latency-slack``), for
deployments where peak memory matters more than p50. One set of random
weights (``--model``'s widths) serves every size; each size gets a fresh
engine, freed before the next.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from typing import Optional, Sequence

import torch

from quoracle_tpu_torch.models.config import get_model_config
from quoracle_tpu_torch.models.generate import resolve_device
from quoracle_tpu_torch.tools import bench_longctx
from quoracle_tpu_torch.utils.calibration import (
    device_kind as device_kind_of, save_paged_gates,
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def decide_gates(by_size: dict, prefer_memory: bool = False,
                 latency_slack: float = 1.25) -> dict:
    """The gates from the measurements ({resident: {path: {p50_round_ms,
    ...}}}), by the JAX tool's rules: a path's crossover is the smallest
    size where its p50 is at most gather's (or, with ``prefer_memory``,
    within ``latency_slack`` of it); unified at the smallest size is 0
    and never is None; a winning direct_full pulls the decode gate down
    to its own crossover, since the direct prefill runs only under the
    direct decode."""
    sweep = sorted(by_size)

    def crossover(path: str) -> Optional[int]:
        for resident in sweep:
            r = by_size[resident]
            ratio = (r[path]["p50_round_ms"]
                     / max(1e-9, r["gather"]["p50_round_ms"]))
            if ratio <= 1.0:
                return resident
            if prefer_memory and ratio <= latency_slack:
                return resident
        return None

    decode_gate = crossover("direct_decode")
    full_gate = crossover("direct_full")
    unified_gate = crossover("unified")
    if unified_gate == sweep[0]:
        unified_gate = 0
    prefill_gate = full_gate
    if full_gate is not None and (decode_gate is None
                                  or decode_gate > full_gate):
        decode_gate = full_gate
    return {"decode_min_resident": decode_gate,
            "prefill_min_resident": prefill_gate,
            "unified_min_resident": unified_gate}


def gate_note(by_size: dict) -> str:
    return "; ".join(
        f"resident {r}: " + ", ".join(
            f"{p}={v['p50_round_ms']:.0f}ms" for p, v in res.items())
        for r, res in by_size.items())


def free_device(device) -> None:
    """Give a freed engine's memory back before the next one is built."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", type=int, nargs="+",
                    default=[1024, 4096, 16384])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--model", default="xla:llama-3-8b",
                    help="catalog model whose widths the engine serves")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=None,
                    help="gate file path (default: the engine's load path)")
    ap.add_argument("--prefer-memory", action="store_true",
                    help="enable direct paths for peak-memory reasons even "
                         "when they lose on latency within --latency-slack")
    ap.add_argument("--latency-slack", type=float, default=1.25,
                    help="with --prefer-memory: max direct/gather p50 "
                         "ratio still considered acceptable")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    sweep = sorted(args.sweep)
    kind = device_kind_of(device)
    log(f"calibrating on {kind}; sweep {sweep}")

    cfg = get_model_config(args.model)
    by_size = {}
    params = None
    for resident in sweep:
        log(f"--- resident {resident} ---")
        # a fresh engine PER size (one sized for the largest would bucket-
        # pad the smaller sizes' gather rounds), over one set of weights
        pool = bench_longctx.session_bytes(cfg, resident, args.rounds,
                                           args.new_tokens)
        log(f"session pool {pool / (1 << 30):.0f} GiB")
        eng, tok = bench_longctx.build_engine(
            resident, args.rounds, args.new_tokens, args.model,
            session_max_bytes=pool, params=params, device=device)
        params = getattr(eng, "params", None)
        by_size[resident] = bench_longctx.measure_paths(
            eng, tok, resident, args.rounds, args.new_tokens)
        del eng, tok
        free_device(device)

    gates = decide_gates(by_size, args.prefer_memory, args.latency_slack)
    path = save_paged_gates(
        args.out or os.environ.get("QUORACLE_PAGED_CALIB"), **gates,
        device_kind=kind, note=gate_note(by_size))
    summary = {
        "metric": "paged_gate_calibration",
        **gates,
        "gate_file": path,
        "device_kind": kind,
        "measurements": {str(k): {p: v["p50_round_ms"]
                                  for p, v in r.items()}
                         for k, r in by_size.items()},
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
