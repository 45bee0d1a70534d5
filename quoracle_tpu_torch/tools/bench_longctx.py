"""Long-context resumed-round micro-benchmark: the paged tiers against
gather (port of ``quoracle_tpu/tools/bench_longctx.py``).

A LONG resident session is resumed for short rounds, the regime the paged
kernels exist for: the gather tier copies the session's pages into a
dense working cache and attends over the padded length, the paged tiers
read only the row's pages. Four paths, the engine's tiers:

  unified         the ragged kernel serves the suffix chunk and every
                  decode step straight from the pages (no working cache)
  direct_full     paged prefill (the suffix chunk against the pages in
                  place) + paged decode: no working cache anywhere
  direct_decode   gather prefill, paged decode
  gather          working-cache gather prefill + gather decode

Per path it reports the p50 resumed-round latency, the device's peak
memory, and each round's latency, reused tokens and temperature-0 tokens.
The JAX tool's peak counter is cumulative per process, hence its path
order (ascending expected footprint); here the peak is reset at each
path's start, so each path's number is its own.

Run on the card (``--device cpu`` runs the plain PyTorch paths on the
CPU):

    python -m quoracle_tpu_torch.tools.bench_longctx --resident 16384

The engine serves a copy of a catalog model registered with its context
window widened to the session: with ``--scale``, as the JAX tool does,
models/make_checkpoint.py's llama checkpoint at that scale (made under
the repository's git-ignored ``checkpoints/`` when missing), its weights
loaded by models/loader.py and its own tokenizer; without, ``--model``
(default llama-3-8b) over random bf16 weights drawn from a seeded
generator on the device. tools/calibrate_paged.py reuses
``measure_paths`` to find each path's crossover and write the engine's
gate file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from typing import Optional

import torch

from quoracle_tpu_torch.models.config import get_model_config, register_model
from quoracle_tpu_torch.models.generate import GenerateEngine, resolve_device
from quoracle_tpu_torch.models.loader import (
    load_params, register_hf_checkpoint,
)
from quoracle_tpu_torch.models.make_checkpoint import make_checkpoint
from quoracle_tpu_torch.models.quant import kv_token_bytes
from quoracle_tpu_torch.models.tokenizer import get_tokenizer
from quoracle_tpu_torch.models.transformer import init_params

GIB = 1 << 30


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def peak_mem_gb(device) -> Optional[float]:
    """The device's peak allocated bytes since the last reset, in GB
    (None on the CPU, which keeps no such counter)."""
    if torch.device(device).type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 1e9, 3)


def reset_peak_mem(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def session_max_seq(resident: int, rounds: int, new_tokens: int) -> int:
    """The engine's window: the session, every path's rounds (warm-up
    included) and a prompt bucket of room, as the JAX tool sizes it."""
    return resident + 4 * new_tokens * (rounds + 2) + 1024


def session_bytes(cfg, resident: int, rounds: int, new_tokens: int,
                  dtype=torch.bfloat16) -> int:
    """A session pool that holds the whole window half again (each path's
    rounds branch off the base conversation, and the radix tree keeps the
    branches until evicted), in whole GiB, at least 2 GiB (the JAX
    tool's budget). llama-3-8b in bf16 at 16384 resident tokens: 4 GiB."""
    token_bytes = kv_token_bytes(
        cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
        torch.empty((), dtype=dtype).element_size(), False)
    need = 1.5 * session_max_seq(resident, rounds, new_tokens) * token_bytes
    return max(2, -(-int(need) // GIB)) * GIB


CHECKPOINTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "checkpoints")


def bench_checkpoint(scale: str) -> str:
    """models/make_checkpoint.py's llama checkpoint at ``scale`` under
    ``checkpoints/`` (made once, then reused)."""
    return make_checkpoint(os.path.join(CHECKPOINTS, f"torch-llama-{scale}"),
                           family="llama", scale=scale)


def build_engine(resident: int, rounds: int, new_tokens: int,
                 model: str = "xla:llama-3-8b",
                 session_max_bytes: Optional[int] = None, params=None,
                 device=None, seed: int = 0, dtype=torch.bfloat16,
                 checkpoint: Optional[str] = None):
    """(engine, tokenizer) for a ``resident``-token session: a copy of
    ``model``'s catalog entry (or of ``checkpoint``'s config, registered
    as ``longctx-base``) registered as ``longctx`` with its context
    window widened to the session, prompt buckets (256, 1024, resident,
    window), and ``params`` (a prebuilt ``Transformer``, so one set of
    weights serves every sweep size), else the checkpoint's weights, else
    random weights drawn from a generator seeded ``seed``, in ``dtype`` on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    if checkpoint is not None:
        base = register_hf_checkpoint(checkpoint, "longctx-base")
        model = f"xla:{base.name}"
    base = get_model_config(model)
    max_seq = session_max_seq(resident, rounds, new_tokens)
    cfg = register_model(dataclasses.replace(
        base, name="longctx", context_window=max_seq))
    tok = get_tokenizer(model)
    if params is None and checkpoint is not None:
        params = load_params(checkpoint, cfg, device=device, dtype=dtype)
    elif params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init_params(cfg, gen, device=device, dtype=dtype)
    if session_max_bytes is None:
        session_max_bytes = session_bytes(cfg, resident, rounds, new_tokens,
                                          params.dtype)
    eng = GenerateEngine(
        cfg, params, tok, max_seq=max_seq, seed=seed, device=device,
        prompt_buckets=(256, 1024, resident, max_seq),
        session_max_bytes=session_max_bytes)
    return eng, tok


# The JAX tool's order (ascending expected footprint there, where the peak
# counter is cumulative): unified holds only the pool, direct_full adds the
# tail, direct_decode the working cache at prefill, gather keeps it
# through decode.
PATHS = ("unified", "direct_full", "direct_decode", "gather")


def _set_path(eng, path: str) -> None:
    eng._force_gather_decode = path == "gather"
    eng.unified_min_tokens = 0 if path == "unified" else 1 << 30
    eng.direct_decode_min_tokens = 0 if path.startswith("direct") else 1 << 30
    eng.direct_prefill_min_tokens = 0 if path == "direct_full" else 1 << 30


def base_prompt(tok, resident: int) -> list[int]:
    """The session's ``resident`` tokens: bos, then filler text."""
    filler = ("The quick brown fox jumps over the lazy dog. "
              "Numbers: 0123456789. ")
    ids = tok.encode(filler)
    return [tok.bos_id] + (ids * (resident // len(ids) + 1))[:resident - 1]


def build_session(eng, tok, resident: int, new_tokens: int,
                  sid: str = "s") -> list[int]:
    """Build the session incrementally in <= 1024-token suffix chunks
    under the engine's current gates; returns the base conversation
    (prompt and the last call's tokens)."""
    prompt = base_prompt(tok, resident)
    eng.drop_session(sid)
    step = 1024
    for end in range(step, len(prompt), step):
        eng.generate([prompt[:end]], temperature=0.0, max_new_tokens=1,
                     session_ids=[sid])
    r = eng.generate([prompt], temperature=0.0, max_new_tokens=new_tokens,
                     session_ids=[sid])[0]
    return list(prompt) + r.token_ids


def measure_paths(eng, tok, resident: int, rounds: int, new_tokens: int,
                  paths=PATHS) -> dict:
    """Build one resident session, then time resumed refinement-shaped
    rounds under each path. Returns {path: {p50_round_ms, peak_hbm_gb,
    rounds, round_ms, reused_tokens, token_ids}}: the per-round lists
    cover every round, the warm-up first; the p50 leaves it out.

    The JAX tool's comparability contracts hold: the session is built
    INCREMENTALLY in <= 1024-token suffix chunks under the FIRST path's
    gates, and every path replays its rounds from the SAME base
    conversation, so each path is timed at the same resident size."""
    _set_path(eng, paths[0])
    t0 = time.monotonic()
    base_conv = build_session(eng, tok, resident, new_tokens)
    log(f"incremental prefill of {resident} tokens: "
        f"{time.monotonic() - t0:.1f}s (path {paths[0]})")

    results = {}
    for path in paths:
        _set_path(eng, path)
        reset_peak_mem(eng.device)
        conv = list(base_conv)
        lats, reused, toks = [], [], []
        for i in range(rounds + 1):            # first = warm-up
            nxt = conv + tok.encode(f" continue {path} {i}.")
            t0 = time.monotonic()
            rr = eng.generate([nxt], temperature=0.0,
                              max_new_tokens=new_tokens,
                              session_ids=["s"])[0]
            lats.append((time.monotonic() - t0) * 1000)
            conv = nxt + rr.token_ids
            reused.append(rr.n_cached_tokens)
            toks.append(list(rr.token_ids))
            log(f"{path} round {i}: {lats[-1]:.0f}ms "
                f"(reused {rr.n_cached_tokens} tokens)")
        results[path] = {
            "p50_round_ms": statistics.median(lats[1:]),
            "peak_hbm_gb": peak_mem_gb(eng.device),
            "rounds": rounds,
            "round_ms": lats,
            "reused_tokens": reused,
            "token_ids": toks,
        }
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--resident", type=int, default=16384,
                    help="target resident session size in tokens")
    ap.add_argument("--rounds", type=int, default=4,
                    help="timed resumed rounds per path")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--model", default="xla:llama-3-8b",
                    help="catalog model whose widths the engine serves "
                         "over random weights")
    ap.add_argument("--scale", default=None,
                    choices=["1b", "small", "tiny"],
                    help="serve make_checkpoint's llama checkpoint at "
                         "this scale instead")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    eng, tok = build_engine(
        args.resident, args.rounds, args.new_tokens, args.model,
        device=args.device,
        checkpoint=bench_checkpoint(args.scale) if args.scale else None)
    log(f"engine ready; resident target {args.resident} tokens, session "
        f"pool {eng.sessions.max_tokens} tokens")
    results = measure_paths(eng, tok, args.resident, args.rounds,
                            args.new_tokens)
    dev = eng.device
    print(json.dumps({
        "metric": "longctx_resumed_round_p50",
        "resident_tokens": args.resident,
        "new_tokens_per_round": args.new_tokens,
        **{f"{k}_p50_ms": round(v["p50_round_ms"], 1)
           for k, v in results.items()},
        **{f"{k}_peak_hbm_gb": v["peak_hbm_gb"] for k, v in results.items()},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
    }))


if __name__ == "__main__":
    main()
