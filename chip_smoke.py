#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``quoracle_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printing one JSON line that ends with the seconds since the
start (``at_s``; any failure raises, so the script exits non-zero and
never prints its last line):

  env        torch and CUDA versions, the card's name and power limit
  build      nvcc builds the hand-written kernels from
             quoracle_tpu_torch/csrc (one process per source, in parallel);
             ptxas's registers, stack and spills per kernel, the bf16
             tensor-core instantiations listed apart
  kernels    each kernel against its plain PyTorch twin on the card at
             llama-3-8b attention shapes (H=32, KV=8, hd=128, page 128),
             in fp32 and bf16, with each case's tolerance; flash, the
             paged prefill and the int8 ragged kernels also at hd 256 and
             G = 1, 4, 8; the three split-K kernels (paged_fwd,
             ragged_fwd, ragged_q8_fwd) also on 4000-key rows,
             share-boundary lengths and windows, hd 128 and 256, G = 1,
             4, 8, at S forced to 1, 7 and its maximum and at the
             wrapper's own S, each launched twice (bit-identical)
  serve      TorchBackend(["xla:llama-3-8b"]) at full width and depth,
             random bf16 weights from a seeded generator: a consensus
             round (three sessioned JSON-constrained rows at temperatures
             1.0/0.7/0.0), one long sessionless row as its own query, then
             the resumed round, on the unified tier (the card's default),
             prefix sharing at its default (round 1 runs in two waves).
             The launch counts are zeroed just before and read just after:
             flash and ragged must have run. The inputs of the first flash
             call and of the resumed round's first ragged chunk and decode
             ticks are kept for the mainpath phase.
  serve_paged the same consensus rounds on two more engines that share
             the serve phase's weights: the direct tier (gates written by
             save_paged_gates to a file and read through the engine's
             loader; the paged prefill and paged decode kernels must run,
             the ragged kernel must not), then the gather tier on the same
             engine (pinned by _force_gather_decode), then the gather tier
             under pool exhaustion (a session pool too small for the
             rounds' stores, set by session_max_bytes, prefix sharing
             off: the rounds must still answer, through the dense prefill
             and decode, with no paged kernel launched). The direct round 2's first inputs of
             both paged kernels are kept, and the three tiers' round-2
             prefill and decode times are printed side by side.
  serve_int8 int8 serving (quantize_weights and quantize_kv) from the
             serve phase's bf16 weights: the same traffic on the unified
             tier, where the int8 ragged kernel must run (and ragged_fwd
             and the paged kernels must not) and flash serves the
             sessionless row; then the rounds again on the gather tier
             (forced) and under pool exhaustion (sharing off), with no
             int8 ragged launch. The int8 pool must hold ~1.94x the bf16 pool's
             tokens in the same 2 GiB. The resumed round's first int8
             chunk and decode ticks are kept for the mainpath phase, and
             round 2's prefill ms and ms per decode step are printed for
             int8 unified, int8 gather and bf16 unified.
  decide     two decides of the port's ConsensusEngine over TorchBackend
             (members served concurrently, the backend's default) for
             the north-star pool, llama-3-8b (a view of the serve
             phase's first 8 layers, also the embedder's weights),
             mistral-7b and gemma-7b at full width cut to 8 layers
             (DEPTH_CUT, for the script's time limit; the later phases'
             uses of the pool too), random bf16 weights from seeded
             generators (seed + i, as the backend draws them): one agent (session
             agent-decide), allowed actions {"wait"}, the system prompt of
             build_system_prompt for that set, the default schedule (4
             refinement rounds, temperatures 1.0 falling to 0.2, JSON
             grammar on), 256 new tokens a member and round; the second
             decide is the agent's next step and must resume (cached
             tokens > 0). Both must end "ok" with a decision. The launch
             counts are zeroed before the decides: ragged_fwd must run,
             the paged and int8 kernels must not. Then backend.embed of
             the system prompt (256-token chunks) and the decisions'
             texts: flash must run, every vector unit norm. Prints init
             seconds per member, peak memory, each decide's rounds,
             latency, prefill and decode ms, cached tokens (and each
             member's per round), round seconds (the first builds three
             vocabularies' grammar tables, timed apart) and each member's
             tier, the embed ms and each member's prefix cache counters
  prefix     the radix prefix cache on the card, in three parts: (1) the
             serve traffic's round 1 and resumed round 2 on two fresh
             llama-3-8b engines over the serve phase's weights, one at
             the sharing default and one with prefix_sharing = False, in
             turns: the deferred rows, cached tokens per row (0, then at
             least 128: rows 1-2 adopt row 0's pages), prefill tokens,
             prefill, decode and round ms, the pages held, the cache's
             counters and occupancy, the tier of each call and the
             launches (zeroed before each round); with sharing, fewer
             prefill tokens and pool pages; (2) copy-on-write through a
             1-layer fp32 cut of llama-3-8b on the GPU and the CPU: a
             session diverges inside a page an adopter shares, the page is
             copied (cow_copies) and the call runs on gather, the
             adopter's pages stay bit-identical on the card, and both
             devices give identical texts, cached counts and counters;
             (3) a second agent's first decide over the decide pool, same
             action set and messages: cached tokens of at least 128 on
             llama-3-8b and gemma-7b, 0 on mistral-7b (windowed models
             never share); its status and latency are printed
  batch      the JAX backend's default dispatch on the card: three
             agents (three threads, the serve traffic's JSON rows, 32 new
             tokens) send round 1 and the resumed round 2 to llama-3-8b;
             a wrapper around engine.generate (here, not in the package)
             holds the first call until the others have queued, and the
             member's baton batcher must merge them (fewer generate calls
             than rows, one session per agent, every text a JSON prefix);
             three more agents send the same two rounds in turn, and the
             resumed rounds' wall ms are printed side by side. A row with
             deadline_ms=0 must come back deadline_exceeded without a
             generate call, and a row whose deadline lapses while another
             caller holds the member must be dropped from the batch that
             serves its neighbour. Then one greedy JSON row per member
             of the decide pool (fresh sessions each run) with overlap on
             and off, in turns after a warm-up: round wall ms, each
             member's prefill and decode ms, and equal launches and
             texts in every run
  continuous continuous batching with QoS admission (models/scheduler.py
             under TorchBackend(continuous=True, qos=...)), in four
             parts: (1) a 2-layer fp32 cut of llama-3-8b: four rows (one
             unconstrained, one JSON, two JSON with different action
             enums) through the loop at chunk 4 and at chunk 32 give the
             temperature-0 tokens of one-shot generate, the owned
             sessions are dropped and ragged_fwd runs; (2) llama-3-8b in
             bf16 over the serve phase's weights: agent A's JSON row of
             256 new tokens, and agent B's 8-token row sent once A's loop
             has stepped twice, through the loop and then (B sent at the
             same ragged launch count) through the baton batcher: both
             rows' ms, A's chunks and ms a chunk, the rows of each step
             (timing recorded, not failed); then the serve traffic's two
             rounds through the loop (JSON prefixes, round 2 resumed,
             ragged_fwd and never a paged kernel); (3) QoS: one slot held
             by a long BATCH row while six BATCH rows and then an
             INTERACTIVE row queue, and the INTERACTIVE row must be
             admitted first of them (the policy's pops, served counts and
             per-class admit waits); a BATCH row past max_queue_depth=2
             comes back admission_rejected with retry_after_ms; a row of
             deadline_ms=0 fails at build and never reaches the loop, a
             row whose deadline lapses in the queue fails at admit and is
             never retired; qos_stats with the card's memory headroom;
             (4) one decide of the decide phase's agent over the decide
             pool with continuous=True and qos=True (its engines), which
             must end "ok" with a decision, then backend.embed (flash),
             beside the decide phase's baton decides, each member's loop
             steps, and one greedy JSON row a member (32 new tokens) with
             all three loops running against each member's row with its
             loop alone, twice each in turns. No batcher- thread may
             outlive close()
  spec       speculative serving (models/speculative.py), self-drafts at
             K 6, in three parts, the launch counts zeroed before the
             first and read after the last: (1) the decide pool under
             the loop with QoS and draft_map {llama-3-8b: llama-3-8b}
             (its engines): one decide that must end "ok" with
             llama-3-8b's spec rounds above 0 and its speculator in
             spec_stats(), then on a fresh speculator llama-3-8b's greedy
             JSON row (32 new tokens) with the other two loops running
             (an unconstrained row each) and alone, twice each in turns;
             the pool's other members are
             then released; (2) a 2-layer fp32 cut of llama-3-8b (full
             width): an unconstrained and a JSON row of 40 tokens through
             the loop at chunk 32, speculation off and on, on the
             unified tier, the forced gather tier and int8 pools: equal
             tokens, no "error" fallback, ragged_fwd (unified) and
             ragged_q8_fwd (int8) launched inside verify calls; a
             hopeless draft (a second cut from another seed) must
             disengage and re-probe with the tokens still equal; the
             batch-1 SpeculativeDecoder over a 322-token prompt must
             equal vanilla and launch flash; (3) llama-3-8b in bf16 at
             full depth over the serve phase's weights: one JSON row of
             SPEC_LONG_TOKENS new tokens through the loop, spec off and
             on, and through the batch-1 decoder: wall ms, ms per committed
             token, rounds, acceptance, tokens a round, K after every
             round and the first differing token (recorded, not
             failed). The first verify tick's ragged inputs (fp32 and
             bf16 float pages, int8 pages; blocks of nq = K) are held
             against the twins and timed beside the bound and SDPA
  obs        observability on the serving path (infra/), over the serve
             phase's llama-3-8b bf16 weights at full width and depth: the
             serve traffic (round 1, the sessionless row, the resumed
             round) on a fresh engine of seed 0 three times, every plane
             off, then on (a tracer sink, the span ring and the flight
             recorder as sinks, the cost, tree and introspect planes, the
             wall profiler running), then off: texts, token and cached
             counts identical, the wall ms a decode step of each run; in
             the on run every row's chip_ms above 0 (0 when off), the
             roofline's MFU readings of each prefill and decode in (0, 1]
             with the bound-by-memory flags, the rows' charge beside the
             phase walls; one decide of the decide pool under the
             continuous loop inside an agent.decide_tick span: the tree
             consensus.decide, consensus.round, backend.member and the
             loop's sched.queue_wait and sched.decode spans, DECIDE_MS,
             ROUNDS_TOTAL, the audit record's task_id equal to the trace
             id; a demote and restore on a 16-page pool with a host tier
             (the KV_* counters, the kv.restore span, the kv_demote and
             kv_restore records, the restore's charge), then a resumed
             round inside torch_trace_window, which must arm and write
             under build/ (removed after); the memory attribution of the
             serve and pool backends (named parts plus other equal the
             card's used bytes, none negative); the exposition's series
  agent      the agent layer (agent/, actions/, context/, infra/bus,
             budget, costs) over the decide pool with an event bus
             attached, allowed actions {"wait"} (build_system_prompt's
             prompt for that set), every agent's consensus budget set to
             DECIDE_MAX_TOKENS: a root agent started by AgentSupervisor
             takes two user messages, two ticks (each one
             agent.decide_tick span traced to the task with
             consensus.decide under it, the audit's task_id the task, a
             DECISION and its RESULT in every member's history, one
             serving_round a query round; the second resumes on
             llama-3-8b and gemma-7b; ragged ran, the paged and int8
             kernels did not); a second root over a seeded ~1,800-token
             history with llama-3-8b's window cut to the output floor +
             AGENT_HISTORY_ROOM condenses (the reflector's query on the
             card at AGENT_REFLECTION_TOKENS new tokens, flash from its
             sessionless prefill; the history fits
             after, the decide "ok"); the root spawns a child through
             spawn_child (the root's decision scripted) whose tick is
             the model's at its depth's QoS class, the tree registry
             shows both, and dismiss_child (scripted) terminates it:
             escrow conserved, the child's pages back (free + cached
             pages as before the spawn); one tick of an agent over the
             serve phase's llama-3-8b at full depth. Each tick's wall
             ms, rounds, members' cached tokens, prefill and decode ms,
             the reflection's and the embedder's ms, the launches
  runtime    runtime.Runtime (persistence, TaskManager, EventHistory, the
             StallWatchdog, the world actions' seams) over the decide
             pool on engines of its own (members in turn), a keyed
             database in a temporary directory outside the checkout
             (removed after): runtime A
             creates a task whose first tick must end "ok", then pauses
             it (sessions dropped, free + cached pages as before, the row
             "paused"); runtime B restores it over the same file and
             backend (every member's history equal entry for entry) and
             it ticks "ok" again (prefill and cached tokens reported);
             left "running", it is revived by runtime C's boot() and
             ticks "ok"; each tick's decode steps and ms a step a member
             reported; persisted costs equal the escrow's spent,
             EventHistory holds the lifecycle and action events, no
             watchdog trip (the pool's baton batcher gives it no
             source); ragged ran, the paged and int8 kernels did not; a
             torch Runtime without a device builds its engines on cuda,
             and its continuous loop's source, held by the watchdog,
             advances over one query without a trip. vault_active says
             whether cryptography is there
  web        the front doors (web/server.py, cli.py) and groves
             (governance/grove.py) over the decide pool on engines of its
             own, its members served in turn (overlap off): a grove
             written to a temporary directory outside the checkout (root
             and child nodes on one auto_inject edge, a
             shell_pattern_block and an action_block rule, strict
             confinement, one schema; its workspace there too), the two
             shipped groves loaded by list_groves; a Runtime with that
             groves_dir behind a DashboardServer on 127.0.0.1, port 0,
             driven over real HTTP: GET /api/groves lists the grove and its
             bootstrap, POST /api/tasks {"grove"} creates the root at the
             root node (its system prompt carries the grove's skills and
             governance docs), whose first tick ends "ok" on the card
             while /events (SSE) delivers its lifecycle and action events;
             scripted decides then spawn a child along the edge (the
             child node, its injected skills and constraints; it ticks
             on the card) and have the child write outside its
             confinement, write a report that breaks the schema, one that
             fits (written) and run a command the hard rule blocks (each
             refused but the fitting write); the status, agents, kv,
             resources (the device block's named parts within its used
             bytes, which are within WEB_MEM_MARGIN of the script's own
             mem_get_info), costs, models, tree, trace, chaos and /metrics
             routes answer 200, /api/sim and /api/train 501; the task
             pauses over HTTP (sessions dropped, pages back, the row
             "paused") and resumes (the restored tick "ok", its cached
             tokens reported); ragged ran, the paged and int8 kernels did
             not. Last, cli.main run --backend torch --grove over
             llama-3-8b at full width cut to DEPTH_CUT layers, drawn by
             the CLI's own TorchBackend (its engines on cuda, the entry
             point's default; a query served; ragged launched; each
             member's decode steps and ms a step reported) and cli.main
             status (the task paused)
  cluster    the multi-replica plane (serving/cluster.py, router.py,
             fleet.py) and the chaos plane (chaos/) over llama-3-8b at
             full width, one pool member, every engine a new
             GenerateEngine over shared weights (ClusterPlane.build's
             engine_factory; its own 512 MiB session pool; the grammar
             tables shared; prefix sharing off, so a row's prefill is the
             same computation on any engine). At DEPTH_CUT layers (the
             decide pool's view of the serve weights), bf16: (a) a
             unified plane of two replicas in baton mode: a constrained
             JSON row, a greedy row and a sessionless row (the dense
             path: flash) give the tokens and cached counts of one
             TorchBackend over the same weights; the greedy session's
             round 2 stays on its replica, cached tokens above 0, no
             handoff; (b) a disaggregated plane of 1 prefill + 2 decode
             replicas (host_kv_mb 256): the same rows, the handoffs'
             export and adopt ms and envelope bytes, the rows against
             one continuous TorchBackend recorded (in bf16 a decode
             replica's first step is a 1-token chunk tick where the
             backend runs a decode tick, which sums in another order:
             not checked here); then chaos/scenarios.py's
             kill_mid_handoff over these replicas with the port's
             lock-order sanitizer on: every invariant's verdict printed,
             all must pass. (c) On an fp32 cut at full width
             (CLUSTER_FP32_LAYERS layers, as the continuous phase's
             chunk-boundary equality): the three rows through 1 prefill
             + 2 decode replicas give one continuous TorchBackend's
             tokens; a FleetController drain of the decode replica
             holding the sessions migrates every one, leaving its store
             and host tier empty and no envelope, and the greedy
             session's round 2 gives the backend's tokens and cached
             count; a plan with a cluster.decode crash kills the row's
             decode replica and the envelope re-places the row on the
             survivor with the backend's tokens, kv_handoff_replace in
             the flight ring. Each replica engine's launches are booked
             to its replica: ragged_fwd must run on the prefill and on a
             decode replica, flash_fwd for the sessionless row; every
             engine on cuda. The launch counts are zeroed before (a) and
             read after (c)
  mainpath   each kernel against its twin on those kept inputs, timed
             (CUDA events, L2 flushed before every launch) beside its
             bound, the twin's time and scaled_dot_product_attention's
             time as a yardstick (for the paged kernels over K/V gathered
             beforehand, outside the timing, with the same mask; it
             returns a normalized output where they return partials; for
             the int8 kernel over K/V gathered and dequantized beforehand)
  trace      one more resumed round and one more sessionless row
             (TRACE_TOKENS new tokens a row), each under torch.profiler:
             wall time, device busy time (the union
             of kernel intervals), idle share, launches, and the kernels
             that take the most device time
  ckpt       an HF checkpoint on the card (models/loader.py): the serve
             phase's llama-3-8b bf16 weights, all 32 layers, exported by
             export_hf_checkpoint to a temporary directory outside the
             checkout, with make_checkpoint's tokenizer files and a
             config.json of the catalog entry (config_from_hf must give
             back its widths and rope); registered, then served by a
             TorchBackend built over the name alone, which loads the
             weights and the checkpoint's own tokenizer and chat
             template: the serve phase's traffic, JSON prefixes, round 2
             resumed, flash and ragged launched (counts zeroed before the
             build); every loaded leaf and the logits of one 938-token
             sequence bit-identical to the exported model's; then
             make_checkpoint's tiny llama and gemma (2 layers, at head
             dims 128 and 256, which the kernels serve) loaded in fp32 on
             the card and on the CPU, the same greedy rounds on the
             unified tier: identical texts and cached counts. Prints the bytes
             written, export and load seconds, load GB/s, round 2's ms
             beside the serve phase's random-weight round
  tiers      tiered KV and the handoff (serving/kvtier.py,
             serving/handoff.py) at llama-3-8b full width over the serve
             phase's bf16 weights, in five parts: (a) six sessions of
             3,000-token prompts (24 pages each, 144 against the 2 GiB
             pool's 128) on an engine with a host tier sized to hold what
             it demotes: the LRU session is demoted, its resumed round
             (20 more tokens, 32 new) restores it by page-in, and it must
             give a never-evicting control engine's tokens and cached
             count, with the restored pages bit-identical to the demoted
             ones and no restore failure; the demote and page-in ms, bytes
             and GB/s, the control's re-prefill of the same round with
             tiers off, and pinned (the default) against pageable host
             copies in turns;
             (b) restart-warm prefixes: engine A with a disk store in a
             fresh directory under build/ serves a 2,000-token prompt and
             drains its spills, a new engine B over the same directory
             serves it again: every full block restored from disk, B's
             tokens those of A's warm row; bytes written, write s, load
             ms per block (crc included); the directory is removed; (c)
             (a) over int8 pools (int8 weights quantized here, three
             sessions against a 64-page pool): pages and scales restored
             bit-identical, the resumed round on ragged_q8_fwd; (d) a
             one-token prefill handed from engine A to engine B
             (KVHandoff export and adopt, one set of weights) continues
             with the tokens of a control engine continuing itself, and a
             bf16 envelope is refused by an int8-KV engine (reason
             "signature", nothing lands); (e) TorchBackend(host_kv_mb=,
             continuous=True): an agent's round to its hibernated session
             is restored (the submit's prefetch or the lookup), cached
             tokens above 0, backend.prefetch_sessions warms it again,
             kv_stats on, effective headroom at least the raw one. The
             launch counts are zeroed before (a) and read after (e):
             ragged_fwd and ragged_q8_fwd must have run; the resumed
             rounds' first chunk and decode ticks are held against the
             twins and timed
  calib      the paged-tier calibration (tools/calibrate_paged.py's
             sweep: 1024, 4096 and 16384 resident tokens, 3 timed rounds
             of 32 new tokens a path after a warm-up) at llama-3-8b in
             bf16 cut to 8 layers (DEPTH_CUT; the serve phase's first
             8 layers, embedding and head), a fresh engine a size
             (tools/bench_longctx.py; the unified, direct_full,
             direct_decode and gather paths, each with its launches,
             p50, the rounds' spread, peak memory and reused tokens),
             then one more round per path from the same prompt whose
             temperature-0 tokens are compared with gather's (a
             divergence is recorded, not failed); the gates go to
             build/paged_gates.json, a new engine loads them through
             QUORACLE_PAGED_CALIB, and at each size a resumed round must
             take the tier they name. At 16384 the inputs of one call of
             flash (gather), ragged (unified: decode and chunk ticks),
             paged_fwd and paged_prefill_fwd (direct_full) are kept and
             each kernel is held against its twin and timed beside SDPA
  sweep      each kernel's time and bound over the lengths it serves:
             ragged decode ticks (bf16 and int8 pages side by side) and
             the paged decode over resident lengths (with S and the grid
             of each split-K launch, and S by hand at 823 keys for all
             three split-K kernels), flash over T, the paged prefill over
             prefix lengths at chunks of 16 and 128 tokens (each beside
             scaled_dot_product_attention's time)
  reference  a 1-layer cut of llama-3-8b in fp32: the same rounds through
             the GPU engine (kernels) and through the same weights on the
             CPU (plain twins) must give identical greedy texts and cached
             counts (3 new tokens a row), on the unified, direct and
             gather tiers, and with int8 weights and pages on the unified
             and gather tiers: each engine's unified tier runs round 1 and
             the resumed round 2, each tier after it one more resumed
             round over the sessions left before it; then the decide
             phase's two decides, greedy (the port engine's
             temperature_for_round pointed at 0.0 for this phase only: a
             decide never samples at 0 by itself), one refinement round at
             most and 4 new tokens, over 1-layer fp32 cuts of all three
             members at full width, served in turn: identical outcomes
             (status, decision, rounds, cached tokens, every member's
             texts) on the GPU and the CPU, and the embedder's vectors
             within 1e-5 at the 8, 64 and 256-token buckets. Engines of
             one tokenizer share the JSON grammar's host table

in that order but for batch, continuous, obs, agent, runtime, web,
cluster and spec, which run after prefix, and ckpt, tiers and calib, after trace; then the card's nvidia-smi
line, the kernels JSON line and, last,
``{"ok": true, "device": {...}}``. The script points
QUORACLE_PAGED_CALIB at build/chip_smoke_pinned_gates.json, a file it
never writes, for the whole run (the calib phase's loading engine
aside), so that no gates file on the machine changes a phase's tiers.
``--only kernels`` stops after the kernels phase (a quick check of a
kernel edit; no last line); ``--only
sweep`` runs the sweep phase alone after the build (kernel times at the
main path's lengths without the serving phases; no last line); ``--only
decide`` runs the decide phase (llama-3-8b built anew) and the reference
decide after the build (no last line); ``--only prefix`` runs the decide
phase and then the prefix phase after the build (no last line);
``--only calib``, ``--only batch``, ``--only continuous``, ``--only
spec``, ``--only tiers``, ``--only obs``, ``--only agent``, ``--only
runtime``, ``--only web`` and ``--only cluster`` run that phase after
the build, over weights drawn here (no last line); ``--only reference`` runs
the reference phase after the build (no last line); ``--only ckpt`` runs the serve phase and then the ckpt phase after
the build (no last line). Every
comparison runs with TF32 off (torch.backends.cuda.matmul.allow_tf32 =
False, and cudnn's too). The script imports torch and the port, never
JAX or the JAX package.
"""

import asyncio
import contextlib
import dataclasses
import gc
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

START = time.monotonic()
REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = "xla:llama-3-8b"
H100_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA data sheet (SXM)
H100_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense peaks
# Tolerances (atol, rtol) of the kernel-vs-twin comparisons, held
# element by element: |got - ref| <= atol + rtol * |ref|.
#  fp32: both sides sum fp32 products in another order (~1e-6 seen)
#  bf16 flash: both sides compute in fp32 and round the output to bf16,
#    so they may land one bf16 ulp apart (at most 2^-7 * |x|), on top of
#    the fp32 sum-order error. Relative, not absolute: the outputs are
#    weighted means of V, mostly |x| < 0.1, where a dropped key moves a
#    value by several ulps
#  bf16 ragged: bf16 inputs, fp32 math and fp32 output on both sides
#  int8 ragged (fp32 or bf16 q): the kernel dequantizes each key row as
#    it loads the tile (float(q8) * scale, one fp32 product), the very
#    values of the twin's k.float() * scale, then runs ragged_fwd's fp32
#    math; so ragged_fwd's bar: fp32 sums in another order
#  paged partials (acc, m, l; unnormalized, fp32 out, fp32 math on both
#    sides from the same inputs): m is a max of scores, exact but for the
#    scores' own sum order (~1e-6 at |s| of order 10); l and acc are sums
#    of exp(s - m) weights, which the kernel rescales tile by tile
#    (exp(a)·exp(b) against the twin's exp(a + b)): a few ulps relative
#    per term, so rtol 1e-5; acc's atol is 1e-4 because its terms p·v
#    cancel, and its error follows sum |p·v| (of order l, up to ~100 here)
#    rather than |acc|. Rows that see no key must be (0, NEG_INF, 0)
#    exactly.
#  bf16 on the tensor cores (flash_fwd, paged_prefill_fwd acc): P is
#    rounded to bf16 once for the P·V product (2^-9 relative per
#    probability), so the error follows sum p·|v|, not |out|: a third
#    term P_TOL · ref_abs, where ref_abs is the twin run with |v| in place
#    of v (flash: normalized, sum p|v| / l; paged prefill: the acc of
#    sum p|v|). m and l keep their bars: l sums the fp32 p. fp32 keeps
#    every bar (it stays on the scalar core).
TOL = {("flash_fwd", "float32"): (1e-5, 0.0),
       ("flash_fwd", "bfloat16"): (1e-5, 2.0 ** -7),
       ("ragged_fwd", "float32"): (1e-5, 0.0),
       ("ragged_fwd", "bfloat16"): (1e-5, 0.0),
       ("ragged_q8_fwd", "float32"): (1e-5, 0.0),
       ("ragged_q8_fwd", "bfloat16"): (1e-5, 0.0)}
PARTIAL_TOL = {"acc": (1e-4, 1e-5), "m": (1e-5, 1e-5), "l": (1e-5, 1e-5)}
PAGED_KERNELS = ("paged_fwd", "paged_prefill_fwd")
for _k in PAGED_KERNELS:
    for _d in ("float32", "bfloat16"):
        for _f, _tol in PARTIAL_TOL.items():
            TOL[(f"{_k}.{_f}", _d)] = _tol
P_TOL = {("flash_fwd", "bfloat16"): 2.0 ** -8,
         ("paged_prefill_fwd.acc", "bfloat16"): 2.0 ** -8}
NEG_INF = -1e30
MAX_TOKENS = 32             # new tokens per row in the serve phase
# new tokens a row of the profiled calls (the trace phase, serve_int8's
# trace), below MAX_TOKENS for the script's time limit: the profiler's
# own processing grows with the launches it records (~2,600 a decode
# step at full depth)
TRACE_TOKENS = 16
# layers of the full-width fp32 cuts that also run on the CPU (the
# prefix phase's copy-on-write, the reference phase's tiers), kept low
# for the script's time limit: the CPU forward is most of their time
CPU_CUT_LAYERS = 1
N_RULES = 30                # system-prompt length of the serve phase
TEMPS = [1.0, 0.7, 0.0]     # the consensus round's member temperatures
# the north-star pool of the decide phase; llama-3-8b (MODEL) comes first,
# so it is the embedder's model
DECIDE_POOL = [MODEL, "xla:mistral-7b", "xla:gemma-7b"]
# new tokens per member and round: with random weights a member's answer
# closes its JSON object (and so parses) or wanders through keys and
# strings, and a round needs one answer that parses. At 48 tokens, 1 of
# the 6 answers of the two decides closed (an H100 run); the share closed
# within each budget is estimated by quoracle_tpu_torch/tools/
# json_closure.py
DECIDE_MAX_TOKENS = 256
# layers of the decide pool's members (llama-3-8b a view of the serve
# phase's first layers, the others drawn at this depth) and of the calib
# sweep, of 32 (28 for gemma-7b): cut for the script's 1,200 s
DEPTH_CUT = 8
# the calib phase: tools/calibrate_paged.py's default sweep, timed rounds
# a path and new tokens a round; its gates go to GATES_FILE. Every other
# phase runs with QUORACLE_PAGED_CALIB pinned to PINNED_GATES, a path the
# script owns and never writes (so: no file, the engine's defaults), so
# that no gates file left on the machine changes the tiers it serves on
CALIB_SIZES = (1024, 4096, 16384)
CALIB_ROUNDS = 3
CALIB_NEW_TOKENS = 32
GATES_FILE = os.path.join(REPO, "build", "paged_gates.json")
# new tokens a row in the reference phase's tier rounds: the CPU side
# (plain twins, int8 weights dequantized on every call) is most of its
# time, and the whole script must finish inside 1,200 s. Cut for the obs
# phase (the reference phase took 214 s in one H100 run: the decide's CPU
# side 97 s, the tier rounds' 71 s): 3 new tokens (was 6); the tiers
# after an engine's first run one resumed round each over the sessions
# the tier before left (was: two rounds each from fresh sessions); the
# decide's members cut to 1 layer (was 2) and 4 new tokens (was 12);
# every engine of one tokenizer builds its JSON grammar tables once
# (host tables shared, each device's copy made from them)
REFERENCE_TOKENS = 3
REFERENCE_DECIDE_LAYERS = 1
REFERENCE_DECIDE_TOKENS = 4
PINNED_GATES = os.path.join(REPO, "build", "chip_smoke_pinned_gates.json")


def emit(obj) -> None:
    """One JSON line; a phase's line also says when the phase ended
    (``at_s``, seconds since the script started)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.monotonic() - START}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def dtype_name(t) -> str:
    return str(t.dtype).split(".")[-1]


def bar_of(kernel: str, dtype: str, ref, ref_abs=None):
    """The elementwise bar of the kernel and dtype around the twin's
    ``ref`` (a tensor): atol + rtol·|ref|, plus P_TOL·ref_abs for the bf16
    tensor-core kernels, whose ``ref_abs`` is the twin run with |v| (see
    TOL)."""
    atol, rtol = TOL[(kernel, dtype)]
    ptol = P_TOL.get((kernel, dtype), 0.0)
    bar = atol + rtol * ref.float().abs()
    if ptol:
        if ref_abs is None:
            raise ValueError(f"{kernel} ({dtype}): the bar needs ref_abs")
        bar = bar + ptol * ref_abs.float()
    return bar


def within_bar(kernel: str, dtype: str, got, ref, ref_abs=None):
    """Which elements of a kernel result meet ``bar_of``."""
    return (got.float() - ref.float()).abs() <= bar_of(kernel, dtype, ref,
                                                        ref_abs)


def check(torch, kernel: str, got, ref, what: dict, ref_abs=None) -> dict:
    """Max abs error of a kernel result against its twin, each element
    held to the tolerance of the kernel and dtype (``within_bar``);
    raises on disagreement."""
    diff = (got.float() - ref.float()).abs()
    bar = bar_of(kernel, what["dtype"], ref, ref_abs)
    ok = bool((diff <= bar).all())
    atol, rtol = TOL[(kernel, what["dtype"])]
    row = {"kernel": kernel, **what, "max_abs_err": diff.max().item(),
           "bar_used": (diff / bar).max().item(), "atol": atol, "rtol": rtol}
    ptol = P_TOL.get((kernel, what["dtype"]))
    if ptol:
        row["ptol"] = ptol
    if not (ok and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{kernel} disagrees with its twin: {row}")
    return row


def check_partials(torch, kernel: str, got, ref, what: dict,
                   acc_abs=None) -> dict:
    """(acc, m, l) of a paged kernel against its twin, field by field
    (``acc_abs``: the twin's acc with |v|, for the bf16 tensor-core bar);
    rows whose twin saw no key must be exactly (0, NEG_INF, 0)."""
    row = {"kernel": kernel, **what}
    for name, g, r in zip(("acc", "m", "l"), got, ref):
        one = check(torch, f"{kernel}.{name}", g, r, what,
                    acc_abs if name == "acc" else None)
        row[f"max_abs_err_{name}"] = one["max_abs_err"]
        row[f"bar_used_{name}"] = one["bar_used"]
    empty = ref[2] == 0                               # [..., H]
    acc_ok = bool(torch.all(got[0][empty] == 0))
    row["empty_rows"] = int(empty.sum())
    row["empty_exact"] = (acc_ok and bool(torch.all(got[1][empty] == NEG_INF))
                          and bool(torch.all(got[2][empty] == 0)))
    if not row["empty_exact"]:
        raise AssertionError(f"{kernel}: empty rows not (0, NEG_INF, 0): "
                             f"{row}")
    row["max_abs_err"] = max(row[f"max_abs_err_{n}"] for n in ("acc", "m",
                                                               "l"))
    return row


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Median device time of one launch of ``fn``: each of ``iters``
    launches between its own CUDA events, after a 1 GiB write outside
    the events, so that every launch finds the 50 MB L2 cold and the
    card is still busy writing (~0.3 ms) while the host enqueues the
    events and ``fn``'s launches: no host gap lands inside the events
    (a wrapper's Python outlasts a 256 MB write)."""
    scrub = torch.empty(256 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        scrub.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# Work counts for the bound: each input byte read once, each output byte
# written once, and the operations these inputs need (data-dependent:
# only keys some query can see, only visible (query, key) pairs)
# ---------------------------------------------------------------------------

def flash_work(q, k, qp, kv_len, window, off) -> tuple[int, int]:
    from quoracle_tpu_torch.ops.attention import attention_mask
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    mask = attention_mask(qp, kv_len, S, window, off)          # [B, T, S]
    keys = int(mask.any(dim=1).sum())
    pairs = int(mask.sum())
    es = q.element_size()
    nbytes = (2 * q.numel() * es                  # q in, out in q's dtype
              + 2 * keys * KV * hd * es           # visible K and V rows
              + 4 * (qp.numel() + 2 * B))         # positions, lens, offsets
    return nbytes, 4 * hd * H * pairs             # QK^T and PV, 2 each


def paged_mask(torch, kernel: str, page: int, tables, ints, n_q: int,
               window):
    """[rows, n_q, maxp·page] bool: which slots of its page table each
    query of a row sees. The one statement of each paged kernel's
    visibility rule here; the bound counts keys and pairs from it and the
    library yardstick takes it as its attn_mask.

      ragged_fwd         ints (meta [NB, 3] of kv_len, qpos0, nq), n_q = tq:
                         s < kv_len, s <= qpos0 + t, t < nq
      paged_fwd          ints (kv_len, kv_off, q_pos), n_q = 1:
                         s < kv_len, kv_off + s <= q_pos
      paged_prefill_fwd  ints (kv_len,), n_q = T: s < kv_len (every pool
                         token precedes every chunk token)

    and with a window W, query-to-key distance < W."""
    dev = tables.device
    s = torch.arange(tables.shape[1] * page, device=dev)[None, None]
    t = torch.arange(n_q, device=dev)[None, :, None]
    if kernel == "ragged_fwd":
        ints = ints[0].unbind(dim=1)
    cols = [x.long()[:, None, None] for x in ints]        # [rows, 1, 1]
    if kernel == "ragged_fwd":
        kv_len, qpos0, nq = cols
        mask = (s < kv_len) & (s <= qpos0 + t) & (t < nq)
        dist = qpos0 + t - s
    elif kernel == "paged_fwd":
        kv_len, kv_off, q_pos = cols
        mask = (s < kv_len) & (kv_off + s <= q_pos)
        dist = q_pos - kv_off - s
    else:
        (kv_len,) = cols
        mask = (s < kv_len) & (t >= 0)
        dist = kv_len + t - s
    return mask if window is None else mask & (dist < window)


def mask_counts(torch, mask, tables) -> tuple[int, int]:
    """(keys, pairs) of a visibility mask: the slots some query sees,
    once per distinct page table (a row's blocks share its pages), and
    the visible (query, key) pairs."""
    _, inv = torch.unique(tables, dim=0, return_inverse=True)
    seen = torch.zeros(int(inv.max()) + 1, mask.shape[2], dtype=torch.int32,
                       device=mask.device)
    seen.index_add_(0, inv, mask.any(dim=1).int())
    return int((seen > 0).sum()), int(mask.sum())


def ragged_work(torch, q, k_pages, tables, meta, tq, window,
                scales: bool = False) -> tuple[int, int]:
    """ragged_fwd, or ragged_q8_fwd with ``scales``: a visible key costs
    K and V rows of each KV head in the pages' dtype (int8: hd bytes each)
    plus, for int8 pages, the two fp32 scales of each KV head."""
    _, H, hd = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    keys, pairs = mask_counts(torch, paged_mask(
        torch, "ragged_fwd", page, tables, (meta,), tq, window), tables)
    es = q.element_size()
    kv_bytes = 2 * hd * k_pages.element_size() + (8 if scales else 0)
    nbytes = (q.numel() * es + q.numel() * 4      # q in, fp32 out
              + keys * KV * kv_bytes              # visible K and V slots
              + 4 * (tables.numel() + meta.numel()))
    return nbytes, 4 * hd * H * pairs


def paged_work(torch, q, k_pages, tables, kv_lens, kv_off, q_pos,
               window) -> tuple[int, int]:
    """paged_fwd: one query per row; a row's visible pool keys are read
    once (shared by its heads) and each (head, key) pair costs 4·hd."""
    B, H, hd = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    keys, pairs = mask_counts(torch, paged_mask(
        torch, "paged_fwd", page, tables, (kv_lens, kv_off, q_pos), 1,
        window), tables)
    es = q.element_size()
    nbytes = (q.numel() * es + q.numel() * 4 + 2 * B * H * 4  # q; acc, m, l
              + 2 * keys * KV * hd * es
              + 4 * (tables.numel() + 4 * B))
    return nbytes, 4 * hd * H * pairs


def paged_prefill_work(torch, q, k_pages, tables, kv_lens,
                       window) -> tuple[int, int]:
    """paged_prefill_fwd: every chunk query against the row's prefix."""
    B, T, H, hd = q.shape
    page, KV = k_pages.shape[1], k_pages.shape[2]
    keys, pairs = mask_counts(torch, paged_mask(
        torch, "paged_prefill_fwd", page, tables, (kv_lens,), T, window),
        tables)
    es = q.element_size()
    nbytes = (q.numel() * es + q.numel() * 4 + 2 * B * T * H * 4
              + 2 * keys * KV * hd * es
              + 4 * (tables.numel() + B))
    return nbytes, 4 * hd * H * pairs


def prefill_blocks(P, q, kp) -> int:
    """CUDA blocks of a paged_prefill_fwd launch: B · ceil(T/tq) · KV."""
    B, T, H, _ = q.shape
    tq, _ = P.prefill_block(H, kp.shape[2], q.dtype)
    return B * -(-T // tq) * kp.shape[2]


def gathered_kv(torch, k_pages, v_pages, tables, dtype, k_scale=None,
                v_scale=None):
    """[B, KV, maxp·page, hd] K and V of each row's table in ``dtype``,
    for the library yardstick (gathered, and int8 pages dequantized,
    outside its timing)."""
    from quoracle_tpu_torch.models.quant import gather_scales
    B, maxp = tables.shape
    _, page, KV, hd = k_pages.shape
    t = tables.long()
    out = []
    for x, sc in ((k_pages, k_scale), (v_pages, v_scale)):
        x = x[t].reshape(B, maxp * page, KV, hd)
        if sc is not None:
            x = x.float() * gather_scales(sc, tables)[..., None]
        out.append(x.to(dtype).transpose(1, 2).contiguous())
    return tuple(out)


def bound(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def ragged_tick(torch, rows, tq, maxp, perm, dev):
    """Block tables and metadata of a flat tick from (prefix, q_len) rows
    (q_len 0 = an inert block), each row on scattered page ids."""
    nb = sum(-(-n // tq) if n else 1 for _, n in rows)
    bt = torch.zeros(nb, maxp, dtype=torch.int32)
    bm = torch.zeros(nb, 3, dtype=torch.int32)
    blk = 0
    for r, (pre, n) in enumerate(rows):
        pages = perm[[(r * maxp + j) % len(perm) for j in range(maxp)]]
        for b in range(-(-n // tq) if n else 1):
            bt[blk] = pages
            bm[blk] = torch.tensor([pre + n, pre + b * tq,
                                    max(0, min(tq, n - b * tq))])
            blk += 1
    return bt.to(dev), bm.to(dev)


def phase_kernels(torch, F, P) -> list:
    """Synthetic cases at llama-3-8b shapes, each kernel vs its twin."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    H, KV, hd, page = 32, 8, 128, 128
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        cases += flash_cases(torch, F, dt, dname, g)
        # ragged: a mixed tq=8 tick (a fresh chunk, resumed chunks of other
        # lengths, a one-token row, an inert block) and a tq=1 decode tick
        # (live rows, an inert slot) over scattered page ids
        n_pages = 64
        kp = torch.randn(n_pages, page, KV, hd, generator=g,
                         device=dev).to(dt)
        vp = torch.randn(n_pages, page, KV, hd, generator=g,
                         device=dev).to(dt)
        perm = torch.randperm(n_pages - 1,
                              generator=torch.Generator().manual_seed(1)) + 1
        ticks = {8: [(0, 300), (700, 37), (130, 8), (0, 0), (1500, 1)],
                 1: [(300, 1), (0, 1), (0, 0), (1999, 1), (129, 1)]}
        for tq, rows in ticks.items():
            bt, bm = ragged_tick(torch, rows, tq, 16, perm, dev)
            qq = torch.randn(bm.shape[0] * tq, H, hd, generator=g,
                             device=dev).to(dt)
            for window in (None, 200):
                got = P.ragged_attend(qq, kp, vp, bt, bm, tq, window)
                ref = P.ragged_attend_ref(qq, kp, vp, bt, bm, tq, window)
                row = check(torch, "ragged_fwd", got, ref,
                            {"dtype": dname, "tq": tq, "window": window})
                row["inert_zero"] = all(
                    bool(torch.all(got[i * tq + int(n):(i + 1) * tq] == 0))
                    for i, n in enumerate(bm[:, 2].tolist()))
                if not row["inert_zero"]:
                    raise AssertionError(f"inert slots not zero: {row}")
                cases.append(row)
        cases += paged_cases(torch, P, dt, dname, g, perm, kp, vp, page)
        cases += ragged_q8_cases(torch, P, dt, dname, g, perm, ticks, page)
        cases += split_cases(torch, P, dt, dname, g)
    torch.cuda.synchronize()
    return cases


def split_grid(torch, P, n_blocks, n_kv, maxp, page, splits=None) -> dict:
    """S and the grid of a split-K launch (``splits`` forced, or the
    wrapper's own choice, ``split_count``)."""
    if splits is None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = P.split_count(n_blocks, n_kv, maxp, page, sms)
    return {"splits": splits, "grid": [n_blocks, n_kv, splits]}


def split_cases(torch, P, dt, dname, g) -> list:
    """The split-K kernels (paged_fwd, ragged_fwd, ragged_q8_fwd) on cases
    the split can get wrong: rows of 4000+ keys over a 40-page table,
    kv_len on a 64-key tile (share) boundary and one past it, a one-key
    row, a window that leaves most shares of the longest row empty, S
    forced to 1, 7 and its maximum and the wrapper's own S; hd 128 and
    256, G = 4, 1 and 8. paged_fwd: an empty row exactly (0, NEG_INF, 0)
    after the combine; ragged_fwd over the float pools, ragged_q8_fwd over
    the same pools quantized with the engine's rule (every vector's max on
    +-127, all-zero vectors at scale 1.0): an inert block and rows t >= nq
    exactly 0. Every case launches twice: the outputs must be bit for bit
    the same."""
    from quoracle_tpu_torch.models.quant import kv_quant
    dev = "cuda"
    page, maxp, n_pages, B = 128, 40, 97, 4
    perm = torch.randperm(n_pages - 1,
                          generator=torch.Generator().manual_seed(3)) + 1
    tables = torch.stack([perm[[(r * maxp + j) % len(perm)
                                for j in range(maxp)]]
                          for r in range(B)]).int().to(dev)
    kv_lens = torch.tensor([4100, 1024, 1025, 0], dtype=torch.int32,
                           device=dev)
    kv_off = torch.tensor([0, 5, 128, 3], dtype=torch.int32, device=dev)
    q_pos = kv_off + kv_lens + torch.tensor([0, 3, 7, 31], dtype=torch.int32,
                                            device=dev)
    ticks = {8: [(4000, 37), (1016, 8), (0, 0), (1017, 8), (0, 1)],
             1: [(4099, 1), (1023, 1), (0, 0), (1024, 1), (0, 1)]}
    s_max = P.max_splits(maxp, page)
    cases = []

    def twice(fn, what, check_fn):
        got, again = fn(), fn()
        row = check_fn(got, what)
        pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
        row["repeat_identical"] = all(torch.equal(a, b) for a, b in pairs)
        if not row["repeat_identical"]:
            raise AssertionError(f"two launches differ: {row}")
        cases.append(row)
        return got

    for hd in (128, 256):
        pools = [torch.randn(n_pages, page, 8, hd, generator=g, device=dev)
                 for _ in range(2)]
        for x in pools:                          # in row 0's first page
            x[int(perm[0]), :3] = 0.0
        for H, KV, tqs in ((32, 8, (8, 1)), (8, 8, (8, 1)), (32, 4, (4, 1))):
            kf, vf = (x[:, :, :KV].to(dt).contiguous() for x in pools)
            q = torch.randn(B, H, hd, generator=g, device=dev).to(dt)
            for window in (None, 200):
                a = (q, kf, vf, tables, kv_lens, kv_off, q_pos, window)
                ref = P.paged_attend_ref(*a)
                for splits in (1, 7, None, s_max):
                    twice(lambda: P.paged_attend(*a, splits=splits),
                          {"dtype": dname, "hd": hd, "H": H, "KV": KV,
                           "window": window,
                           **split_grid(torch, P, B, KV, maxp, page, splits)},
                          lambda got, what: check_partials(
                              torch, "paged_fwd", got, ref, what))
            quant = []
            for x in pools:
                q8, sc = kv_quant(x[:, :, :KV].contiguous())
                quant += [q8, sc.transpose(1, 2).contiguous()]
            kq, ks, vq, vs = quant
            ragged = (("ragged_fwd", kf, vf, {}),
                      ("ragged_q8_fwd", kq, vq, dict(k_scale=ks, v_scale=vs)))
            for (name, kp, vp, sc), tq in itertools.product(ragged, tqs):
                bt, bm = ragged_tick(torch, ticks[8 if tq > 1 else 1], tq,
                                     maxp, perm, dev)
                nb = bm.shape[0]
                qq = torch.randn(nb * tq, H, hd, generator=g,
                                 device=dev).to(dt)
                for window in (None, 200):
                    a = (qq, kp, vp, bt, bm, tq, window)
                    ref = P.ragged_attend_ref(*a, **sc)
                    for splits in (1, 7, None, s_max):
                        got = twice(
                            lambda: P.ragged_attend(*a, **sc, splits=splits),
                            {"dtype": dname, "hd": hd, "H": H, "KV": KV,
                             "tq": tq, "window": window,
                             **split_grid(torch, P, nb, KV, maxp, page,
                                          splits)},
                            lambda got, what: check(
                                torch, name, got, ref, what))
                        zero = all(
                            bool(torch.all(got[i * tq + int(n):(i + 1) * tq]
                                           == 0))
                            for i, n in enumerate(bm[:, 2].tolist()))
                        cases[-1]["inert_zero"] = zero
                        if not zero:
                            raise AssertionError(
                                f"inert slots not zero: {cases[-1]}")
    return cases


FLASH_GEOMETRIES = (
    # (H, KV, hd, T, S, kv_len of the two rows)
    (32, 8, 128, 512, 576, (512, 389)),     # llama-3-8b, G = 4
    (16, 16, 256, 300, 333, (300, 217)),    # gemma-7b, hd 256, G = 1
    (8, 8, 128, 300, 333, (300, 217)),      # hd 128, G = 1
    (32, 4, 128, 300, 333, (300, 217)),     # hd 128, G = 8
)


def flash_cases(torch, F, dt, dname, g) -> list:
    """flash_fwd against its twin over FLASH_GEOMETRIES: B=2, kv_len
    differing per row, a nonzero offset on row 1 whose first 16 queries
    sit at position -1 (padding: fully masked, exact zeros), with and
    without a sliding window. T = 300 and S = 333 are multiples neither of
    the bf16 block's TQ = 64 / G queries nor of the key tile."""
    dev = "cuda"
    cases = []
    for H, KV, hd, T, S, lens in FLASH_GEOMETRIES:
        q = torch.randn(2, T, H, hd, generator=g, device=dev).to(dt)
        k = torch.randn(2, S, KV, hd, generator=g, device=dev).to(dt)
        v = torch.randn(2, S, KV, hd, generator=g, device=dev).to(dt)
        off = torch.tensor([0, 7], dtype=torch.int32, device=dev)
        qp = (torch.arange(T, device=dev)[None] + off[:, None]).int()
        qp[1, :16] = -1
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        for window in (None, 200):
            got = F.flash_attend(q, k, v, qp, kv_len, window, off)
            ref = F.flash_attend_ref(q, k, v, qp, kv_len, window, off)
            ref_abs = F.flash_attend_ref(q, k, v.abs(), qp, kv_len, window,
                                         off)
            row = check(torch, "flash_fwd", got, ref,
                        {"dtype": dname, "H": H, "KV": KV, "hd": hd, "T": T,
                         "S": S, "window": window}, ref_abs)
            row["masked_rows_zero"] = bool(torch.all(got[1, :16] == 0))
            if not row["masked_rows_zero"]:
                raise AssertionError(f"masked rows not zero: {row}")
            cases.append(row)
    return cases


def ragged_q8_cases(torch, P, dt, dname, g, perm, ticks, page) -> list:
    """The int8 ragged kernel against its twin: pools quantized from
    random K/V with the engine's rule (every vector's max on +-127),
    some all-zero vectors in a visible page (scale 1.0), scattered pages,
    the ragged phase's ticks with a window, inert blocks and one-token
    rows; hd 128 and 256, q in fp32 and bf16, G = 4 (llama-3-8b), 1 and
    8 query heads per KV head. tq = 8 holds 8·G score rows, so G = 8
    runs tq = 4 (the kernel takes at most 32 rows per block)."""
    from quoracle_tpu_torch.models.quant import kv_quant
    dev = "cuda"
    cases = []
    n_pages = 64
    for hd in (128, 256):
        pools = [torch.randn(n_pages, page, 8, hd, generator=g, device=dev)
                 for _ in range(2)]
        for x in pools:                          # in row 0's first page
            x[int(perm[0]), :3] = 0.0
        for H, KV, tqs in ((32, 8, (8, 1)), (8, 8, (8, 1)), (32, 4, (4, 1))):
            quant = []
            for x in pools:
                q8, sc = kv_quant(x[:, :, :KV].contiguous())
                quant += [q8, sc.transpose(1, 2).contiguous()]
            kq, ks, vq, vs = quant
            if not bool(torch.all(ks[int(perm[0]), :, :3] == 1.0)):
                raise AssertionError("zero vectors did not get scale 1.0")
            for tq in tqs:
                rows = ticks[8 if tq > 1 else 1]
                bt, bm = ragged_tick(torch, rows, tq, 16, perm, dev)
                qq = torch.randn(bm.shape[0] * tq, H, hd, generator=g,
                                 device=dev).to(dt)
                for window in (None, 200):
                    a = (qq, kq, vq, bt, bm, tq, window)
                    sc = dict(k_scale=ks, v_scale=vs)
                    got = P.ragged_attend(*a, **sc)
                    row = check(torch, "ragged_q8_fwd", got,
                                P.ragged_attend_ref(*a, **sc),
                                {"dtype": dname, "hd": hd, "H": H, "KV": KV,
                                 "tq": tq, "window": window})
                    row["inert_zero"] = all(
                        bool(torch.all(got[i * tq + int(n):(i + 1) * tq]
                                       == 0))
                        for i, n in enumerate(bm[:, 2].tolist()))
                    if not row["inert_zero"]:
                        raise AssertionError(f"inert slots not zero: {row}")
                    cases.append(row)
    return cases


def prefill_case(torch, P, qc, kp, vp, tables, pre, window, dname) -> dict:
    """paged_prefill_fwd against its twin on one chunk; the bf16 bar's
    acc_abs is the twin's acc over |v| pages."""
    a = (qc, kp, vp, tables, pre, window)
    acc_abs = P.paged_prefill_attend_ref(qc, kp, vp.abs(), tables, pre,
                                         window)[0]
    tq, _ = P.prefill_block(qc.shape[2], kp.shape[2], qc.dtype)
    return check_partials(
        torch, "paged_prefill_fwd", P.paged_prefill_attend(*a),
        P.paged_prefill_attend_ref(*a),
        {"dtype": dname, "H": qc.shape[2], "KV": kp.shape[2],
         "hd": qc.shape[3], "T": qc.shape[1], "tq": tq, "window": window},
        acc_abs)


def paged_cases(torch, P, dt, dname, g, perm, kp, vp, page) -> list:
    """The direct tier's two kernels against their twins: scattered page
    tables, an empty row, rows past a page edge, with and without a
    window, at G = 4 (llama-3-8b), 1 and 8 query heads per KV head (the
    prefill kernel also at hd 256, G = 1 and 4); the prefill chunk T = 37
    is no multiple of any block's tq (64/G in bf16, 32/G in fp32)."""
    dev = "cuda"
    cases = []
    B, maxp, hd = 4, 16, 128
    tables = torch.stack([perm[[(r * maxp + j) % len(perm)
                                for j in range(maxp)]]
                          for r in range(B)]).int().to(dev)
    kv_lens = torch.tensor([300, 0, 1999, 129], dtype=torch.int32,
                           device=dev)
    kv_off = torch.tensor([0, 5, 0, 128], dtype=torch.int32, device=dev)
    q_pos = kv_off + kv_lens + torch.tensor([0, 3, 7, 31], dtype=torch.int32,
                                            device=dev)
    pre = torch.tensor([700, 0, 1500], dtype=torch.int32, device=dev)
    for H, KV in ((32, 8), (8, 8), (32, 4)):
        kpg, vpg = kp[:, :, :KV].contiguous(), vp[:, :, :KV].contiguous()
        q = torch.randn(B, H, hd, generator=g, device=dev).to(dt)
        qc = torch.randn(3, 37, H, hd, generator=g, device=dev).to(dt)
        for window in (None, 200):
            a = (q, kpg, vpg, tables, kv_lens, kv_off, q_pos, window)
            cases.append(check_partials(
                torch, "paged_fwd", P.paged_attend(*a), P.paged_attend_ref(*a),
                {"dtype": dname, "H": H, "KV": KV, "window": window}))
            cases.append(prefill_case(torch, P, qc, kpg, vpg, tables[:3],
                                      pre, window, dname))
    # the prefill kernel at hd 256: gemma-7b's G = 1 and G = 4
    kp2, vp2 = (torch.randn(kp.shape[0], page, 8, 256, generator=g,
                            device=dev).to(dt) for _ in range(2))
    for H, KV in ((8, 8), (32, 8)):
        qc = torch.randn(3, 37, H, 256, generator=g, device=dev).to(dt)
        for window in (None, 200):
            cases.append(prefill_case(torch, P, qc, kp2[:, :, :KV].contiguous(),
                                      vp2[:, :, :KV].contiguous(), tables[:3],
                                      pre, window, dname))
    for row in cases:
        if row["empty_rows"] == 0:
            raise AssertionError(f"no empty row was checked: {row}")
    return cases


def chat(user: str, n_rules: int = 30) -> list:
    system = ("You are one member of a consensus pool of agents. Answer "
              "with exactly one JSON action object. Rules: " + " ".join(
                  f"rule {i}: keep step {i} short, cite file_{i}.py line "
                  f"{i * 7}, and never repeat step {i - 1}."
                  for i in range(n_rules)))
    return [{"role": "system", "content": system},
            {"role": "user", "content": user}]


def json_prefix_ok(dfa, text: str) -> bool:
    """The text walks the port's JSON grammar DFA without a reject."""
    state = dfa.start_id
    for ch in text:
        ci = dfa.char_index(ch)
        if ci < 0:
            return False
        state = int(dfa.trans[state, ci])
        if state < 0:
            return False
    return True


def consensus_round(R, backend, spec, hist, temps, max_tokens):
    """One consensus round: a sessioned JSON-constrained row per member
    history (session ``agent-<i>``). Returns its summary and results."""
    eng = backend.engines[spec]
    t0 = time.monotonic()
    res = backend.query([
        R.QueryRequest(spec, h, temperature=t, max_tokens=max_tokens,
                       session_id=f"agent-{i}", constrain_json=True)
        for i, (h, t) in enumerate(zip(hist, temps))])
    for r in res:
        if not r.ok:
            raise AssertionError(f"consensus row error: {r.error}")
    return {"latency_ms": (time.monotonic() - t0) * 1e3,
            "prefill_ms": res[0].prefill_ms,
            "decode_ms": res[0].decode_ms,
            "prefill_tokens": eng.last_prefill_tokens,
            "prompt_tokens": [r.usage.prompt_tokens for r in res],
            "new_tokens": [r.usage.completion_tokens for r in res],
            "cached_tokens": [r.cached_tokens for r in res]}, res


def sessionless_row(R, backend, spec, max_tokens, n_rules):
    """One greedy row without a session, its prompt long enough for the
    dense path to run flash. Returns its summary and result."""
    t0 = time.monotonic()
    (one,) = backend.query([R.QueryRequest(
        spec, chat("summarize the rules above in one line", n_rules + 6),
        temperature=0.0, max_tokens=max_tokens)])
    if not one.ok:
        raise AssertionError(f"sessionless row error: {one.error}")
    return {"latency_ms": (time.monotonic() - t0) * 1e3,
            "prefill_ms": one.prefill_ms, "decode_ms": one.decode_ms,
            "prompt_tokens": one.usage.prompt_tokens,
            "new_tokens": one.usage.completion_tokens}, one


def run_rounds(R, backend, spec, temps, max_tokens, n_rules,
               on_round=lambda rnd: None, sessionless: bool = True):
    """The consensus-shaped traffic: round 1 (three sessioned JSON rows)
    and (unless ``sessionless`` is False) one long sessionless row as its
    own query, then round 2, which resumes each session with one more
    user message. Returns per-round summaries, the results of every row,
    and the histories a next round would send."""
    users = ["pick the next action", "decide what to do next",
             "propose one step"]
    hist = [chat(u, n_rules) for u in users]
    rounds, results = [], []
    for rnd in (1, 2):
        on_round(rnd)
        summary, res = consensus_round(R, backend, spec, hist, temps,
                                       max_tokens)
        summary = {"round": rnd, **summary}
        if rnd == 1 and sessionless:
            summary["sessionless"], one = sessionless_row(
                R, backend, spec, max_tokens, n_rules)
            res = res + [one]
        rounds.append(summary)
        results.append(res)
        hist = [h + [{"role": "assistant", "content": r.text},
                     {"role": "user", "content": "refine your proposal"}]
                for h, r in zip(hist, res)]
    return rounds, results, hist


def check_json(results, dfa) -> None:
    """Every consensus row's text walks the JSON grammar."""
    for res in results:
        for r in res[:3]:
            if not json_prefix_ok(dfa, r.text):
                raise AssertionError(f"not a JSON prefix: {r.text!r}")


def check_rounds(rounds, results, dfa, long_min: int) -> None:
    if rounds[0]["sessionless"]["prompt_tokens"] < long_min:
        raise AssertionError(f"sessionless prompt below {long_min} tokens")
    if min(rounds[1]["cached_tokens"]) <= 0:
        raise AssertionError(f"round 2 resumed nothing: {rounds[1]}")
    check_json(results, dfa)


def ragged_recorder(torch, P, kept: dict, keep_now):
    """A stand-in for ``P.ragged_attend`` that keeps (cloned) the inputs
    of the first chunk tick (tq > 1) and the first decode tick (tq = 1)
    seen while ``keep_now()`` holds, under kept["chunk"] and
    kept["decode"], then calls the real wrapper."""
    orig = P.ragged_attend

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def rec(q, k_pages, v_pages, tables, meta, tq, sliding_window=None,
            **kw):
        key = "chunk" if tq > 1 else "decode"
        if keep_now() and key not in kept:
            kept[key] = ([clone(x) for x in (q, k_pages, v_pages, tables,
                                             meta, tq, sliding_window)],
                         {n: clone(x) for n, x in kw.items()})
        return orig(q, k_pages, v_pages, tables, meta, tq, sliding_window,
                    **kw)
    return rec


def phase_serve(torch, R, F, P, kernels, dfa):
    t0 = time.monotonic()
    backend = R.TorchBackend([MODEL], seed=0)        # the card, bf16
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0

    # keep (cloned) the inputs of the first flash call and of the resumed
    # round's first ragged chunk and decode ticks; timing launches later
    # do not count, the counts are read before them
    kept: dict = {}
    cur = {"round": 0}
    orig_flash, orig_ragged = F.flash_attend, P.ragged_attend

    def flash_rec(*a, **kw):
        if "flash_fwd" not in kept:
            kept["flash_fwd"] = (
                [x.clone() if torch.is_tensor(x) else x for x in a],
                {n: x.clone() if torch.is_tensor(x) else x
                 for n, x in kw.items()})
        return orig_flash(*a, **kw)

    ragged_rec = ragged_recorder(torch, P, kept.setdefault("ragged_fwd", {}),
                                 lambda: cur["round"] == 2)
    F.flash_attend, P.ragged_attend = flash_rec, ragged_rec
    kernels.reset_launch_counts()
    try:
        rounds, results, hist = run_rounds(
            R, backend, MODEL, TEMPS, MAX_TOKENS, N_RULES,
            on_round=lambda rnd: cur.update(round=rnd))
        torch.cuda.synchronize()
    finally:
        F.flash_attend, P.ragged_attend = orig_flash, orig_ragged
    launches = kernels.launch_counts()
    if min(launches["flash_fwd"], launches["ragged_fwd"]) <= 0:
        raise AssertionError(f"the main path missed a kernel: {launches}")
    check_rounds(rounds, results, dfa, long_min=256)
    eng = backend.engines[MODEL]
    report = {"phase": "serve", "model": MODEL, "init_s": init_s,
              "launches": launches, "rounds": rounds,
              "kv_pages_free": eng.sessions.free_pages(),
              "kv_pages": eng.sessions.n_pages,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "texts": [r.text[:48] for r in results[0]]}
    return backend, report, kept, launches, hist


def phase_serve_paged(torch, R, P, kernels, dfa, backend, serve_report):
    """The direct and gather tiers at full width and depth, on engines
    that share the serve phase's weights (one 16 GB copy on the card)."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.utils.calibration import save_paged_gates
    base = backend.engines[MODEL]

    def engine(**kw):
        eng = GenerateEngine(base.cfg, base.params, base.tokenizer, seed=0,
                             device="cuda", **kw)
        return eng, R.TorchBackend([MODEL], device="cuda",
                                   engines={MODEL: eng})

    # direct tier: gates through a calibration file and the normal loader;
    # the file lives in a temporary directory (never in the checkout) and
    # goes once the engine has read it
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    prev = os.environ.get("QUORACLE_PAGED_CALIB")
    try:
        os.environ["QUORACLE_PAGED_CALIB"] = save_paged_gates(
            os.path.join(work, "direct_gates.json"), decode_min_resident=0,
            prefill_min_resident=0, unified_min_resident=None,
            device_kind=torch.cuda.get_device_name(0),
            note="chip_smoke.py: direct tier on")
        direct, direct_backend = engine()
    finally:
        shutil.rmtree(work)
        if prev is None:
            os.environ.pop("QUORACLE_PAGED_CALIB", None)
        else:
            os.environ["QUORACLE_PAGED_CALIB"] = prev
    if not (direct.direct_decode_min_tokens == 0
            and direct.direct_prefill_min_tokens == 0
            and direct.unified_min_tokens >= 1 << 30):
        raise AssertionError(f"gates not read: {direct.paged_gates}")

    kept: dict = {}
    cur = {"round": 0}
    orig = {k: getattr(P, k) for k in ("paged_attend",
                                       "paged_prefill_attend")}

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def recorder(name):
        def rec(*a, **kw):
            if cur["round"] == 2 and name not in kept:
                kept[name] = ([clone(x) for x in a],
                              {n: clone(x) for n, x in kw.items()})
            return orig[name](*a, **kw)
        return rec

    for name in orig:
        setattr(P, name, recorder(name))
    kernels.reset_launch_counts()
    try:
        rounds, results, _ = run_rounds(
            R, direct_backend, MODEL, TEMPS, MAX_TOKENS, N_RULES,
            on_round=lambda rnd: cur.update(round=rnd), sessionless=False)
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(P, name, fn)
    d_launch = kernels.launch_counts()
    if not (d_launch["paged_fwd"] > 0 and d_launch["paged_prefill_fwd"] > 0
            and d_launch["ragged_fwd"] == 0):
        raise AssertionError(f"direct tier launches: {d_launch}")
    check_json(results, dfa)
    direct_rep = {"launches": d_launch, "rounds": rounds,
                  "kv_pages_free": direct.sessions.free_pages()}

    # gather tier on the same engine, pinned by the JAX engine's seam
    # with the pool as large as the other tiers had (the comparable run)
    for i in range(len(TEMPS)):
        direct.drop_session(f"agent-{i}")
    direct._force_gather_decode = True
    kernels.reset_launch_counts()
    rounds_f, results_f, _ = run_rounds(
        R, direct_backend, MODEL, TEMPS, MAX_TOKENS, N_RULES,
        sessionless=False)
    torch.cuda.synchronize()
    f_launch = kernels.launch_counts()
    if (f_launch["ragged_fwd"] or f_launch["paged_fwd"]
            or f_launch["paged_prefill_fwd"]):
        raise AssertionError(f"forced gather launches: {f_launch}")
    check_json(results_f, dfa)
    forced_rep = {"launches": f_launch, "rounds": rounds_f}
    del direct_backend, direct

    # gather tier under pool exhaustion: 8 usable pages of 128 tokens;
    # round 1 stores one session and declines the others' stores, and the
    # page-reading tiers find no free pages for those rows, so both rounds
    # drop to gather (the port used to raise here)
    token_bytes = (2 * base.cfg.n_layers * base.cfg.n_kv_heads
                   * base.cfg.head_dim * 2)
    gather, gather_backend = engine(session_max_bytes=8 * 128 * token_bytes)
    # sharing would split round 1 into waves, the first of which finds its
    # pages and runs unified: this case is there for the gather tier
    gather.prefix_sharing = False
    kernels.reset_launch_counts()
    rounds_g, results_g, _ = run_rounds(
        R, gather_backend, MODEL, TEMPS, MAX_TOKENS, N_RULES,
        sessionless=False)
    torch.cuda.synchronize()
    g_launch = kernels.launch_counts()
    if (g_launch["ragged_fwd"] or g_launch["paged_fwd"]
            or g_launch["paged_prefill_fwd"] or not g_launch["flash_fwd"]):
        raise AssertionError(f"gather tier launches: {g_launch}")
    check_json(results_g, dfa)
    if rounds_g[1]["cached_tokens"][0] <= 0:
        raise AssertionError(f"gather round 2 resumed nothing: {rounds_g}")
    exhausted_rep = {"launches": g_launch, "rounds": rounds_g,
                  "kv_pages": gather.sessions.n_pages,
                  "kv_pages_free": gather.sessions.free_pages(),
                  "stored_sessions": len(gather.sessions)}
    del gather_backend, gather
    torch.cuda.empty_cache()

    compare = round2_compare({"unified": serve_report["rounds"][1],
                              "direct": rounds[1], "gather": rounds_f[1]})
    report = {"phase": "serve_paged", "model": MODEL,
              "direct": direct_rep, "gather_forced": forced_rep,
              "gather_pool_exhausted": exhausted_rep,
              "round2_by_tier": compare}
    return report, kept, d_launch


def round2_compare(tiers: dict) -> dict:
    """Round 2's prefill ms and ms per decode step of each tier's run."""
    return {tier: {"prefill_ms": r2["prefill_ms"],
                   "decode_ms": r2["decode_ms"],
                   "decode_ms_per_step":
                       r2["decode_ms"] / max(1, max(r2["new_tokens"]) - 1),
                   "new_tokens": r2["new_tokens"],
                   "cached_tokens": r2["cached_tokens"]}
            for tier, r2 in tiers.items()}


def phase_serve_int8(torch, R, P, kernels, dfa, backend, serve_report):
    """Int8 serving at full width and depth: an engine with int8 weights
    (quantized on the card from the serve phase's bf16 weights) and an
    int8 page pool in the same 2 GiB budget, driven with the serve
    phase's traffic on the unified tier, then on the gather tier (forced,
    same engine) and under pool exhaustion (a second engine sharing the
    int8 weights, 8 usable pages)."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.quant import kv_token_bytes, params_nbytes
    base = backend.engines[MODEL]
    int8 = dict(quantize_weights=True, quantize_kv=True)
    t0 = time.monotonic()
    eng = GenerateEngine(base.cfg, base.params, base.tokenizer, seed=0,
                         device="cuda", **int8)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    ib = R.TorchBackend([MODEL], device="cuda", engines={MODEL: eng})
    ratio = eng.sessions.max_tokens / base.sessions.max_tokens
    if not 1.9 <= ratio <= 2.0:
        raise AssertionError(f"int8 pool holds {ratio:.3f}x the bf16 pool's "
                             f"tokens, not ~1.94x")

    kept: dict = {}
    cur = {"round": 0}
    orig = P.ragged_attend
    P.ragged_attend = ragged_recorder(torch, P, kept,
                                      lambda: cur["round"] == 2)
    kernels.reset_launch_counts()
    try:
        rounds, results, hist = run_rounds(
            R, ib, MODEL, TEMPS, MAX_TOKENS, N_RULES,
            on_round=lambda rnd: cur.update(round=rnd))
        torch.cuda.synchronize()
    finally:
        P.ragged_attend = orig
    launches = kernels.launch_counts()
    if not (launches["ragged_q8_fwd"] > 0 and launches["flash_fwd"] > 0
            and launches["ragged_fwd"] == launches["paged_fwd"]
            == launches["paged_prefill_fwd"] == 0):
        raise AssertionError(f"int8 unified launches: {launches}")
    if set(kept) != {"chunk", "decode"} or any(
            "k_scale" not in kw for _, kw in kept.values()):
        raise AssertionError("the int8 ticks' inputs were not kept")
    check_rounds(rounds, results, dfa, long_min=256)
    # where an int8 round's time goes: the weights' dequantization runs
    # on every call, beside the kernels
    trace = traced(torch, "int8 resumed consensus round",
                   lambda: consensus_round(R, ib, MODEL, hist, TEMPS,
                                           TRACE_TOKENS))
    trace.update(prefill_ms=eng.last_prefill_s * 1e3,
                 decode_ms=eng.last_decode_s * 1e3)
    unified_rep = {"launches": launches, "rounds": rounds,
                   "texts": [r.text[:48] for r in results[0]],
                   "trace": trace}

    # the gather tier on the same engine: pages dequantize into the
    # working cache and requantize on the way back
    for i in range(len(TEMPS)):
        eng.drop_session(f"agent-{i}")
    eng._force_gather_decode = True
    kernels.reset_launch_counts()
    rounds_f, results_f, _ = run_rounds(
        R, ib, MODEL, TEMPS, MAX_TOKENS, N_RULES, sessionless=False)
    torch.cuda.synchronize()
    f_launch = kernels.launch_counts()
    if f_launch["ragged_q8_fwd"] or f_launch["ragged_fwd"]:
        raise AssertionError(f"int8 forced gather launches: {f_launch}")
    check_json(results_f, dfa)
    forced_rep = {"launches": f_launch, "rounds": rounds_f}
    del ib

    # pool exhaustion: 8 usable int8 pages, through gather
    cfg = base.cfg
    tb = kv_token_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 1, True)
    small = GenerateEngine(cfg, eng.params, base.tokenizer, seed=0,
                           device="cuda", session_max_bytes=8 * 128 * tb,
                           **int8)
    small.prefix_sharing = False       # as serve_paged's exhausted case
    sb = R.TorchBackend([MODEL], device="cuda", engines={MODEL: small})
    kernels.reset_launch_counts()
    rounds_g, results_g, _ = run_rounds(
        R, sb, MODEL, TEMPS, MAX_TOKENS, N_RULES, sessionless=False)
    torch.cuda.synchronize()
    g_launch = kernels.launch_counts()
    if g_launch["ragged_q8_fwd"] or g_launch["ragged_fwd"] \
            or not g_launch["flash_fwd"]:
        raise AssertionError(f"int8 pool-exhausted launches: {g_launch}")
    check_json(results_g, dfa)
    if rounds_g[1]["cached_tokens"][0] <= 0:
        raise AssertionError(f"int8 exhausted round 2 resumed nothing: "
                             f"{rounds_g}")
    exhausted_rep = {"launches": g_launch, "rounds": rounds_g,
                     "kv_pages": small.sessions.n_pages,
                     "stored_sessions": len(small.sessions)}
    report = {"phase": "serve_int8", "model": MODEL, "build_s": build_s,
              "weight_bytes": params_nbytes(eng.params),
              "bf16_weight_bytes": params_nbytes(base.params),
              "kv_token_bytes": tb,
              "max_tokens": eng.sessions.max_tokens,
              "bf16_max_tokens": base.sessions.max_tokens,
              "max_tokens_ratio": ratio,
              "unified": unified_rep, "gather_forced": forced_rep,
              "gather_pool_exhausted": exhausted_rep,
              "round2": round2_compare({
                  "int8_unified": rounds[1], "int8_gather": rounds_f[1],
                  "bf16_unified": serve_report["rounds"][1]}),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del sb, small, eng
    torch.cuda.empty_cache()
    return report, kept, launches


def wait_only_system_prompt() -> str:
    """The port's system prompt for an agent allowed only ``wait``."""
    from quoracle_tpu_torch.actions.schema import ACTIONS
    from quoracle_tpu_torch.consensus.prompt_builder import (
        build_system_prompt,
    )
    return build_system_prompt(
        forbidden_actions=tuple(a for a in ACTIONS if a != "wait"))


def next_step(outcome, messages: list, pool: list) -> dict:
    """The agent's next step: each member's history plus its own answer
    of the decide (the text its session holds; the decision's JSON if it
    gave none) and the action's result."""
    out = {}
    for m in pool:
        raw = next((p.raw_text for p in outcome.proposals
                    if p.model_spec == m), None)
        if raw is None:
            raw = next((f.raw_text for f in outcome.failures
                        if f.model_spec == m and f.raw_text), None)
        if raw is None:
            d = outcome.decision
            raw = json.dumps({"action": d.action, "params": d.params})
        out[m] = list(messages) + [
            {"role": "assistant", "content": raw},
            {"role": "user", "content": "result: waited; no new events "
                                        "arrived. Decide the next step."}]
    return out


TIER_SPIES = ("_run_unified", "_run_split", "_run_dense", "_prefix_wave_split")


def spied_note(attr: str, a: tuple, out):
    """What ``tier_spy`` reports for one call: the tier by the
    calibration's path names (``_run_split``'s from its use_direct and
    use_direct_pre, its last two positional arguments), "dense", or
    ["deferred", rows]."""
    if attr == "_run_split":
        use_direct, use_direct_pre = a[-2:]
        return ("direct_full" if use_direct_pre else
                "direct_decode" if use_direct else "gather")
    return {"_run_unified": "unified", "_run_dense": "dense"}.get(
        attr, ["deferred", out])


def tier_spy(eng, note) -> None:
    """Report to ``note`` the tier of each call the engine runs and, as
    ["deferred", rows], the rows each sessioned generate defers to a
    second wave: instance attributes over the engine's methods, which
    ``untier_spy`` removes."""
    for attr in TIER_SPIES:
        def run(*a, _fn=getattr(eng, attr), _attr=attr, **kw):
            out = _fn(*a, **kw)
            note(spied_note(_attr, a, out))
            return out
        setattr(eng, attr, run)


def untier_spy(eng) -> None:
    for attr in TIER_SPIES:
        delattr(eng, attr)


def run_decides(R, CE, backend, pool: list, max_tokens: int,
                max_refinement_rounds: int = 4,
                session_key: str = "agent-decide", steps: int = 2) -> tuple:
    """Decides of one agent (session ``session_key``) through the port's
    ConsensusEngine over ``backend``, allowed actions {"wait"}, on the
    default schedule: the first from the system prompt and a task, the
    second (``steps`` 2) the agent's next step. Returns the outcomes and,
    per decide, the seconds of each round (``backend.query`` call), each
    member's tier and cached tokens per round, and the seconds spent
    building JSON grammar tables."""
    messages = [{"role": "system", "content": wait_only_system_prompt()},
                {"role": "user", "content": "Task: keep the build green. "
                                            "Decide the next step."}]
    rec = {"round_s": [], "tiers": {m: [] for m in pool}, "cached": [],
           "grammar_s": 0.0}
    orig_query = backend.query

    def timed_query(requests):
        t0 = time.monotonic()
        try:
            res = orig_query(requests)
            rec["cached"].append({r.model_spec: r.cached_tokens
                                  for r in res})
            return res
        finally:
            rec["round_s"].append(time.monotonic() - t0)

    grammar_lock = threading.Lock()

    def grammar_spy(fn):
        # members build their tables on their own threads (overlap): the
        # sum is thread-seconds, not wall seconds
        def run(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                with grammar_lock:
                    rec["grammar_s"] += time.monotonic() - t0
        return run

    for spec in pool:
        eng = backend.engines[spec]

        def note(c, spec=spec):
            if isinstance(c, str):          # a tier, not a wave split
                rec["tiers"][spec].append(c)
        tier_spy(eng, note)
        eng._json_table_device = grammar_spy(eng._json_table_device)
    backend.query = timed_query
    engine = CE.ConsensusEngine(backend, CE.ConsensusConfig(
        model_pool=list(pool), max_refinement_rounds=max_refinement_rounds,
        session_key=session_key, allowed_actions={"wait"},
        max_tokens=max_tokens))
    records, outcomes = [], []
    try:
        for step in range(steps):
            rec.update(round_s=[], tiers={m: [] for m in pool}, cached=[],
                       grammar_s=0.0)
            outcomes.append(engine.decide(
                {m: list(messages) for m in pool} if step == 0
                else next_step(outcomes[0], messages, pool)))
            records.append({k: (dict(v) if isinstance(v, dict) else v)
                            for k, v in rec.items()})
    finally:
        del backend.query
        for spec in pool:
            eng = backend.engines[spec]
            untier_spy(eng)
            del eng._json_table_device
    return outcomes, records


def decide_summary(out, rec) -> dict:
    """What a decide did, for the phase's JSON line."""
    return {"status": out.status, "rounds_used": out.rounds_used,
            "latency_ms": out.latency_ms, "prefill_ms": out.prefill_ms,
            "decode_ms": out.decode_ms, "cached_tokens": out.cached_tokens,
            "prompt_tokens": out.prompt_tokens,
            "completion_tokens": out.completion_tokens,
            "embed_texts": out.embed_texts,
            "member_latency_ms": out.member_latency_ms,
            "round_s": rec["round_s"], "grammar_build_s": rec["grammar_s"],
            "tiers": rec["tiers"], "member_cached_tokens": rec["cached"],
            "decision": (None if out.decision is None else {
                "action": out.decision.action, "kind": out.decision.kind,
                "params": out.decision.params,
                "confidence": out.decision.confidence}),
            "failures": [[f.model_spec, f.kind, f.error[:80],
                          f.raw_text[:120]] for f in out.failures],
            "texts": {p.model_spec: p.raw_text[:80] for p in out.proposals}}


def decide_texts(out) -> list:
    """The decision's texts: its JSON, its reasoning, and the members'
    answers."""
    d = out.decision
    return ([json.dumps({"action": d.action, "params": d.params}),
             d.reasoning or "(no reasoning)"]
            + [p.raw_text for p in out.proposals])


def depth_cut(spec: str):
    """``spec``'s catalog entry cut to DEPTH_CUT layers, registered as
    ``<name>-<DEPTH_CUT>layer``."""
    from quoracle_tpu_torch.models import config as C
    base = C.get_model_config(spec)
    return C.register_model(dataclasses.replace(
        base, name=f"{base.name}-{DEPTH_CUT}layer", n_layers=DEPTH_CUT))


def layer_view(torch, params, cfg):
    """A Transformer of ``cfg`` over ``params``' embedding, first
    ``cfg.n_layers`` layers, final norm and head: shared, no copy."""
    from quoracle_tpu_torch.models.transformer import Transformer
    view = Transformer(cfg, device="meta", dtype=params.dtype)
    view.embed, view.final_norm = params.embed, params.final_norm
    view.layers = torch.nn.ModuleList(params.layers[:cfg.n_layers])
    view.lm_head = params.lm_head
    return view


def decide_pool_backend(torch, R, backend) -> tuple:
    """The decide pool's backend (overlap at its default, on), each member
    cut to DEPTH_CUT layers: llama-3-8b over the serve phase's first
    layers (``layer_view``), the other members drawn here with the
    backend's seeding (seed + i). Returns it and each member's init
    seconds."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.tokenizer import get_tokenizer
    from quoracle_tpu_torch.models.transformer import init_params
    engines, init_s = {}, {}
    for i, spec in enumerate(DECIDE_POOL):
        t0 = time.monotonic()
        cfg = depth_cut(spec)
        if spec == MODEL:
            params = layer_view(torch, backend.engines[MODEL].params, cfg)
        else:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(i)
            params = init_params(cfg, gen, device="cuda")
        engines[spec] = GenerateEngine(cfg, params, get_tokenizer(spec),
                                       seed=i, device="cuda")
        torch.cuda.synchronize()
        init_s[spec] = time.monotonic() - t0
    return (R.TorchBackend(DECIDE_POOL, device="cuda", engines=engines),
            init_s)


def phase_decide(torch, R, kernels, backend):
    """Two decides of the port's ConsensusEngine over the north-star pool
    at full width cut to DEPTH_CUT layers (llama-3-8b a view of the serve
    phase's weights, the other two drawn here with the backend's seeding,
    seed + i; the embedder shares llama's weights), on the unified tier (a resumed round
    whose divergence falls inside a radix-cached page copies it and runs
    on gather; ``tiers`` shows where); then the embedder on the system
    prompt (256-token chunks: flash) and the decision's texts. Returns the
    report, the decides' launch counts and the pool's backend, its agent's
    sessions still resident."""
    from quoracle_tpu_torch.consensus import engine as CE
    import numpy as np
    torch.cuda.reset_peak_memory_stats()
    pool_backend, init_s = decide_pool_backend(torch, R, backend)
    engines = pool_backend.engines
    if pool_backend.embedder.params is not engines[MODEL].params:
        raise AssertionError("the embedder does not share llama's weights")

    # the members' grammar tables for the decides' action set, built in
    # turn before them: built at first use on the members' threads, three
    # builds at once cost ~3.5x their sum (the GIL; PERF.md), which
    # the script's 1,200 s cannot spare
    t0 = time.monotonic()
    for spec in DECIDE_POOL:
        engines[spec]._json_table_device((("wait",),))
    grammar_prebuild_s = time.monotonic() - t0
    kernels.reset_launch_counts()
    outcomes, records = run_decides(R, CE, pool_backend, DECIDE_POOL,
                                    DECIDE_MAX_TOKENS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    decides = [decide_summary(o, r) for o, r in zip(outcomes, records)]
    report = {"phase": "decide", "pool": DECIDE_POOL, "init_s": init_s,
              "grammar_prebuild_s": grammar_prebuild_s,
              "max_tokens": DECIDE_MAX_TOKENS, "decides": decides,
              "launches": launches}
    bad = [d for d in decides if d["status"] != "ok" or d["decision"] is None]
    if bad or outcomes[1].cached_tokens <= 0 or not (
            launches["ragged_fwd"] > 0 and launches["paged_fwd"]
            == launches["paged_prefill_fwd"] == launches["ragged_q8_fwd"]
            == 0):
        emit(report)
        raise AssertionError("the decide phase failed its checks")

    system = wait_only_system_prompt()
    texts = [system] + decide_texts(outcomes[0]) + decide_texts(outcomes[1])
    n_system = len(engines[MODEL].tokenizer.encode(system))
    if n_system <= 256:
        raise AssertionError(f"system prompt of {n_system} tokens: no "
                             f"256-token chunk")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    vecs = pool_backend.embed(texts)
    torch.cuda.synchronize()
    embed_ms = (time.monotonic() - t0) * 1e3
    embed_launches = kernels.launch_counts()
    norms = [float(np.linalg.norm(v)) for v in vecs]
    report["embed"] = {"texts": len(texts), "system_prompt_tokens": n_system,
                       "ms": embed_ms, "launches": embed_launches,
                       "max_norm_err": max(abs(n - 1.0) for n in norms)}
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if embed_launches["flash_fwd"] <= 0 or report["embed"]["max_norm_err"] \
            > 1e-5:
        emit(report)
        raise AssertionError("the embedder missed flash or a unit norm")
    report["prefix_cache"] = {
        spec: eng.sessions.prefix_cache.stats()
        for spec, eng in engines.items()}
    return report, launches, pool_backend


def fanout_round(torch, R, kernels, backend, hist) -> tuple:
    """One consensus round of the serve traffic on ``backend``'s llama-3-8b
    engine, counts zeroed just before: its summary with the waves, the
    tiers, the pages its sessions hold, the prefix cache's counters and
    occupancy, and the kernel launches."""
    eng = backend.engines[MODEL]
    calls: list = []
    tier_spy(eng, calls.append)
    kernels.reset_launch_counts()
    try:
        summary, res = consensus_round(R, backend, MODEL, hist, TEMPS,
                                       MAX_TOKENS)
        torch.cuda.synchronize()
    finally:
        untier_spy(eng)
    st = eng.sessions
    summary.update(
        deferred_rows=[c[1] for c in calls if c[0] == "deferred"],
        tiers=[c for c in calls if isinstance(c, str)],
        pages_stored=len({p for s in st._sessions.values()
                          for p in s.pages}),
        pool_pages_in_use=st.n_pages - 1 - st.free_pages(),
        prefix_cache=st.prefix_cache.stats(),
        occupancy=st.prefix_cache.occupancy(),
        launches=kernels.launch_counts())
    return summary, res


def prefix_fanout(torch, R, kernels, base) -> dict:
    """Part 1: the serve traffic's round 1 (three new sessions, one system
    prompt) and resumed round 2 on two fresh engines over the serve
    phase's weights, one at the sharing default and one with
    ``prefix_sharing = False``, in turns, each engine's grammar table
    built beforehand."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    users = ["pick the next action", "decide what to do next",
             "propose one step"]
    runs = {}
    for label, sharing in (("sharing", True), ("no_sharing", False)):
        eng = GenerateEngine(base.cfg, base.params, base.tokenizer, seed=0,
                             device="cuda")
        eng.prefix_sharing = sharing
        backend = R.TorchBackend([MODEL], device="cuda",
                                 engines={MODEL: eng})
        # a sessionless constrained token first: each engine builds its
        # JSON grammar table (seconds on the host) outside the rounds
        backend.query([R.QueryRequest(MODEL, chat("warm up", 1),
                                      temperature=0.0, max_tokens=1,
                                      constrain_json=True)])
        runs[label] = {"backend": backend,
                       "hist": [chat(u, N_RULES) for u in users]}
    out = {}
    for rnd in (1, 2):
        for label, run in runs.items():
            summary, res = fanout_round(torch, R, kernels, run["backend"],
                                        run["hist"])
            out.setdefault(label, []).append({"round": rnd, **summary})
            run["hist"] = [h + [{"role": "assistant", "content": r.text},
                                {"role": "user",
                                 "content": "refine your proposal"}]
                           for h, r in zip(run["hist"], res)]
    on, off = out["sharing"][0], out["no_sharing"][0]
    if not (on["cached_tokens"][0] == 0
            and min(on["cached_tokens"][1:]) >= 128
            and on["deferred_rows"] == [[1, 2]]
            and on["prefill_tokens"] < off["prefill_tokens"]
            and on["pool_pages_in_use"] < off["pool_pages_in_use"]
            and on["launches"]["ragged_fwd"] > 0
            and off["cached_tokens"] == [0, 0, 0]):
        emit({"phase": "prefix", "fanout": out})
        raise AssertionError("the fan-out round did not share its prompt")
    del runs
    torch.cuda.empty_cache()
    return out


def prefix_cow(torch, R) -> dict:
    """Part 2: copy-on-write through a CPU_CUT_LAYERS-layer fp32 cut of
    llama-3-8b on the GPU (kernels) and on the CPU (plain twins), one set of weights,
    unified tier on both, greedy: session a stores a prompt, b adopts its
    first page, then a diverges at token 100, inside that shared page.
    The divergent call must copy the page (cow_copies) and run on gather
    (the swapped page is only partly reused), b's pages must stay
    bit-identical on the card, and both devices must give the same texts,
    cached counts and counters."""
    from quoracle_tpu_torch.models import config as C
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.tokenizer import get_tokenizer
    cfg = C.register_model(dataclasses.replace(
        C.get_model_config(MODEL), name=f"llama-3-8b-{CPU_CUT_LAYERS}layer",
        n_layers=CPU_CUT_LAYERS))
    tok = get_tokenizer(f"xla:{cfg.name}")
    pa = tok.encode_chat(chat("task alpha", 8))
    pb = tok.encode_chat(chat("task beta", 8))
    pa_div = pa[:100] + tok.encode(" rewritten after condensation, "
                                   "decide again")
    params = dict(zip(("cuda", "cpu"), fp32_cut(torch, cfg, 2,
                                                 cpu_copy=True)))
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = GenerateEngine(cfg, params[dev], tok, seed=0, device=dev)
        eng.unified_min_tokens = 0          # the CPU default is gather
        calls: list = []
        tier_spy(eng, calls.append)
        t0 = time.monotonic()

        def gen(prompt, sid):
            (r,) = eng.generate([prompt], temperature=0.0,
                                max_new_tokens=12, session_ids=[sid])
            return [r.text, r.n_cached_tokens]

        texts = [gen(pa, "a"), gen(pb, "b")]
        b_pages = list(eng.sessions.get("b").pages)
        before = [x[:, b_pages].clone() for x in (eng.sessions.k,
                                                  eng.sessions.v)]
        del calls[:]
        texts.append(gen(pa_div, "a"))
        cow_tiers = [c for c in calls if isinstance(c, str)]
        kept = all(torch.equal(x[:, b_pages], y) for x, y in zip(
            (eng.sessions.k, eng.sessions.v), before))
        texts.append(gen(pb + tok.encode(" more"), "b"))
        runs[dev] = {"s": time.monotonic() - t0, "texts": texts,
                     "cow_tiers": cow_tiers, "b_pages_kept": kept,
                     "prefix_cache": eng.sessions.prefix_cache.stats()}
        del eng
    del params
    torch.cuda.empty_cache()
    g, c = runs["cuda"], runs["cpu"]
    report = {"model": cfg.name, "gpu": g, "cpu_s": c["s"],
              "identical": all(g[k] == c[k] for k in (
                  "texts", "cow_tiers", "prefix_cache"))}
    if not (report["identical"] and g["b_pages_kept"]
            and g["prefix_cache"]["cow_copies"] >= 1
            and g["cow_tiers"] == ["gather"]
            and g["texts"][1][1] >= 128):
        report["cpu"] = c
        emit({"phase": "prefix", "cow": report})
        raise AssertionError("copy-on-write failed on the card")
    return report


def prefix_second_agent(torch, R, kernels, pool_backend) -> dict:
    """Part 3: a second agent's first decide over the decide pool, after
    the decide phase's two decides, with the same action set and
    messages: the members without a window (llama-3-8b, gemma-7b) adopt
    the system prompt's cached pages, the windowed one (mistral-7b)
    adopts none."""
    from quoracle_tpu_torch.consensus import engine as CE
    kernels.reset_launch_counts()
    outcomes, records = run_decides(R, CE, pool_backend, DECIDE_POOL,
                                    DECIDE_MAX_TOKENS,
                                    session_key="agent-second", steps=1)
    torch.cuda.synchronize()
    summary = decide_summary(outcomes[0], records[0])
    first = summary["member_cached_tokens"][0]
    report = {"status": summary["status"],
              "latency_ms": summary["latency_ms"],
              "rounds_used": summary["rounds_used"],
              "prefill_ms": summary["prefill_ms"],
              "decode_ms": summary["decode_ms"],
              "prompt_tokens": summary["prompt_tokens"],
              "member_cached_tokens": summary["member_cached_tokens"],
              "tiers": summary["tiers"], "launches": kernels.launch_counts(),
              "prefix_cache": {
                  spec: eng.sessions.prefix_cache.stats()
                  for spec, eng in pool_backend.engines.items()}}
    windowed = {spec: eng.cfg.sliding_window is not None
                for spec, eng in pool_backend.engines.items()}
    report["windowed"] = windowed
    if not (sorted(windowed.values()) == [False, False, True]
            and all(first[spec] == 0 if w else first[spec] >= 128
                    for spec, w in windowed.items())):
        emit({"phase": "prefix", "second_agent": report})
        raise AssertionError("the second agent's decide did not adopt")
    return report


def phase_prefix(torch, R, kernels, backend, pool_backend) -> dict:
    """The radix prefix cache and prefix sharing on the card, in three
    parts, each with its ``at_s``: the fan-out at full width with and
    without sharing, copy-on-write at a 1-layer fp32 cut against the CPU,
    and a second agent's first decide over the decide pool."""
    report = {"phase": "prefix", "model": MODEL}
    report["fanout"] = prefix_fanout(torch, R, kernels,
                                     backend.engines[MODEL])
    report["fanout_at_s"] = time.monotonic() - START
    report["cow"] = prefix_cow(torch, R)
    report["cow_at_s"] = time.monotonic() - START
    report["second_agent"] = prefix_second_agent(torch, R, kernels,
                                                 pool_backend)
    report["second_agent_at_s"] = time.monotonic() - START
    return report


# ---------------------------------------------------------------------------
# calib: the paged-tier calibration at long context
# ---------------------------------------------------------------------------

def long_recorders(torch, F, P, kept: dict, cur: dict) -> dict:
    """Stand-ins for the four attention wrappers that keep (cloned) the
    first call's inputs of each kernel while ``cur["path"]`` is the path
    that launches it: ragged_fwd's decode and chunk ticks on unified,
    paged_fwd and paged_prefill_fwd on direct_full, flash_fwd on gather.
    Returns the originals, for ``setattr`` back."""
    orig = {"ragged_attend": P.ragged_attend, "paged_attend": P.paged_attend,
            "paged_prefill_attend": P.paged_prefill_attend,
            "flash_attend": F.flash_attend}

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def keep(key, path, a, kw):
        if cur["path"] == path and key not in kept:
            kept[key] = ([clone(x) for x in a],
                         {n: clone(x) for n, x in kw.items()})

    def ragged(q, k_pages, v_pages, tables, meta, tq, sliding_window=None,
               **kw):
        a = (q, k_pages, v_pages, tables, meta, tq, sliding_window)
        keep("chunk" if tq > 1 else "decode", "unified", a, kw)
        return orig["ragged_attend"](*a, **kw)

    def paged(*a, **kw):
        keep("paged_attend", "direct_full", a, kw)
        return orig["paged_attend"](*a, **kw)

    def paged_prefill(*a, **kw):
        keep("paged_prefill_attend", "direct_full", a, kw)
        return orig["paged_prefill_attend"](*a, **kw)

    def flash(*a, **kw):
        keep("flash_fwd", "gather", a, kw)
        return orig["flash_attend"](*a, **kw)
    P.ragged_attend, P.paged_attend = ragged, paged
    P.paged_prefill_attend, F.flash_attend = paged_prefill, flash
    return orig


def restore_wrappers(F, P, orig: dict) -> None:
    F.flash_attend = orig.pop("flash_attend")
    for name, fn in orig.items():
        setattr(P, name, fn)


def calib_size(torch, F, P, kernels, BL, CP, resident: int, params,
               keep) -> tuple:
    """One size of the sweep on a fresh engine over ``params``: the
    harness's measure (its launches counted), then one more round per
    path from the base prompt plus one suffix, each on its own new
    session (adopting the base prompt's cached pages), so that the four
    paths' temperature-0 tokens can be compared; ``keep`` (a dict) keeps
    the kernels' inputs during those rounds. Returns the size's report
    and its params."""
    cfg = depth_cut(MODEL)
    pool = BL.session_bytes(cfg, resident, CALIB_ROUNDS, CALIB_NEW_TOKENS)
    t0 = time.monotonic()
    eng, tok = BL.build_engine(resident, CALIB_ROUNDS, CALIB_NEW_TOKENS,
                               f"xla:{cfg.name}", session_max_bytes=pool,
                               params=params, device="cuda")
    params = eng.params
    kernels.reset_launch_counts()
    res = BL.measure_paths(eng, tok, resident, CALIB_ROUNDS,
                           CALIB_NEW_TOKENS)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    agree_prompt = BL.base_prompt(tok, resident) + tok.encode(
        " continue with the same step.")
    cur = {"path": None}
    orig = (long_recorders(torch, F, P, keep, cur) if keep is not None
            else None)
    same: dict = {}
    tiers: list = []
    tier_spy(eng, lambda c: isinstance(c, str) and tiers.append(c))
    try:
        for path in BL.PATHS:
            BL._set_path(eng, path)
            cur["path"] = path
            (r,) = eng.generate([agree_prompt], temperature=0.0,
                                max_new_tokens=CALIB_NEW_TOKENS,
                                session_ids=[f"agree-{path}"])
            same[path] = (list(r.token_ids), r.n_cached_tokens)
            eng.drop_session(f"agree-{path}")
        torch.cuda.synchronize()
    finally:
        untier_spy(eng)
        if orig is not None:
            restore_wrappers(F, P, orig)
    ref = same["gather"][0]
    paths = {}
    for path, v in res.items():
        timed = v["round_ms"][1:]
        toks = same[path][0]
        first = next((i for i, (a, b) in enumerate(zip(toks, ref))
                      if a != b), None)
        paths[path] = {
            "p50_round_ms": v["p50_round_ms"],
            "spread_ms": max(timed) - min(timed),
            "round_ms": v["round_ms"], "peak_gb": v["peak_hbm_gb"],
            "reused_tokens": v["reused_tokens"],
            "same_prompt_cached_tokens": same[path][1],
            "tokens_agree_with_gather": toks == ref,
            "first_divergence": first}
    report = {"pool_gib": pool / (1 << 30), "max_seq": eng.max_seq,
              "seconds": time.monotonic() - t0, "launches": launches,
              "same_prompt_tiers": tiers, "paths": paths}
    if not (tiers == list(BL.PATHS) and min(
            launches[k] for k in ("ragged_fwd", "paged_fwd",
                                  "paged_prefill_fwd", "flash_fwd")) > 0
            and launches["ragged_q8_fwd"] == 0):
        emit({"phase": "calib", "resident": resident, **report})
        raise AssertionError("a path missed its tier or its kernel")
    del eng, tok
    CP.free_device("cuda")
    return report, params


def gated_path(gates, max_prompt: int) -> str:
    """The path a calibration file's gates name for a resumed bf16 call
    whose longest prompt has ``max_prompt`` tokens (the engine's
    ``_run_paged`` rule, for rows that own their pages and a suffix chunk
    under ``prefill_max_chunk``; AUTO unified is on for the card)."""
    unified = (0 if gates.unified_min_resident is None
               else gates.unified_min_resident)
    if max_prompt >= unified:
        return "unified"
    if max_prompt >= gates.decode_min_resident:
        return ("direct_full" if max_prompt >= gates.prefill_min_resident
                else "direct_decode")
    return "gather"


def calib_tiers(torch, BL, params) -> dict:
    """One engine that loads GATES_FILE through QUORACLE_PAGED_CALIB (the
    normal loader): at each size a session built under those gates, then
    one resumed round, whose tier must be the one the gates name."""
    prev = os.environ["QUORACLE_PAGED_CALIB"]
    os.environ["QUORACLE_PAGED_CALIB"] = GATES_FILE
    try:
        eng, tok = BL.build_engine(max(CALIB_SIZES), CALIB_ROUNDS,
                                   CALIB_NEW_TOKENS,
                                   f"xla:{depth_cut(MODEL).name}",
                                   params=params, device="cuda")
    finally:
        os.environ["QUORACLE_PAGED_CALIB"] = prev
    if eng.paged_gates.source != GATES_FILE:
        raise AssertionError(f"gates not loaded: {eng.paged_gates}")
    out = {"gates": dataclasses.asdict(eng.paged_gates),
           "unified_min_tokens": eng.unified_min_tokens}
    for resident in CALIB_SIZES:
        conv = BL.build_session(eng, tok, resident, CALIB_NEW_TOKENS,
                                sid="tiers")
        nxt = conv + tok.encode(" continue gated 0.")
        calls: list = []
        tier_spy(eng, lambda c: isinstance(c, str) and calls.append(c))
        try:
            (r,) = eng.generate([nxt], temperature=0.0,
                                max_new_tokens=CALIB_NEW_TOKENS,
                                session_ids=["tiers"])
        finally:
            untier_spy(eng)
        want = gated_path(eng.paged_gates, len(nxt))
        out[str(resident)] = {"prompt_tokens": len(nxt), "gated": want,
                              "took": calls,
                              "cached_tokens": r.n_cached_tokens}
        if calls != [want]:
            emit({"phase": "calib", "tier_check": out})
            raise AssertionError(f"resident {resident}: the round took "
                                 f"{calls}, the gates name {want}")
    eng.drop_session("tiers")
    del eng, tok
    torch.cuda.empty_cache()
    return out


def phase_calib(torch, F, P, kernels, params=None) -> dict:
    """The port's calibration at long context, llama-3-8b at full width
    cut to DEPTH_CUT layers in bf16 over ``params`` (a view of the serve
    phase's first layers; None: drawn from seed 0): the sweep over CALIB_SIZES on a fresh engine a
    size, the gates it decides written to GATES_FILE (never the default
    path) and loaded back, and the four kernels of the sweep's paths held
    against their twins on inputs kept at the largest size."""
    from quoracle_tpu_torch.tools import bench_longctx as BL
    from quoracle_tpu_torch.tools import calibrate_paged as CP
    from quoracle_tpu_torch.utils.calibration import save_paged_gates
    report = {"phase": "calib", "model": f"xla:{depth_cut(MODEL).name}",
              "rounds": CALIB_ROUNDS,
              "new_tokens": CALIB_NEW_TOKENS, "sizes": {}}
    by_size, kept = {}, {}
    for resident in CALIB_SIZES:
        size, params = calib_size(
            torch, F, P, kernels, BL, CP, resident, params,
            kept if resident == max(CALIB_SIZES) else None)
        report["sizes"][str(resident)] = size
        by_size[resident] = {p: {"p50_round_ms": v["p50_round_ms"]}
                             for p, v in size["paths"].items()}
        emit({"phase": "calib_size", "resident": resident, **size})
    gates = CP.decide_gates(by_size)
    save_paged_gates(GATES_FILE, **gates,
                     device_kind=torch.cuda.get_device_name(0),
                     note=CP.gate_note(by_size))
    report["gates"] = gates
    report["gates_file"] = os.path.relpath(GATES_FILE, REPO)
    report["tier_check"] = calib_tiers(torch, BL, params)
    entries = [
        flash_entry(torch, F, kernels, kept["flash_fwd"], 1),
        ragged_entry(torch, P, kernels.RAGGED, kept, 1),
        *paged_entries(torch, P, kernels, kept,
                       {"paged_fwd": 1, "paged_prefill_fwd": 1})]
    for e in entries:       # one kept call each, not a launch count
        del e["launches"]
    report["long_kernels"] = {"resident": max(CALIB_SIZES),
                              "kernels": entries}
    del kept
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# batch: cross-caller baton batching, members served concurrently, deadlines
# ---------------------------------------------------------------------------

class HeldGenerate:
    """Wraps a member engine's ``generate`` (in this script, not in the
    package): records each call's batch size and, while armed, holds the
    next call until its rows and the rows queued in the member's batcher
    number ``rows`` (and ``until()`` holds), so that the callers of a
    round that are not in this call are queued behind it and merge, never
    left to timing."""

    def __init__(self, backend, spec=MODEL):
        self.engine = backend.engines[spec]
        self.batcher = backend._batchers[spec]
        self.sizes: list[int] = []
        self.armed = None
        orig = self.engine.generate

        def generate(prompts, **kw):
            self.sizes.append(len(prompts))
            arm, self.armed = self.armed, None
            if arm is not None:
                rows, until = arm
                t_end = time.monotonic() + 60
                while not (len(prompts) + self.pending_rows() >= rows
                           and until()):
                    if time.monotonic() > t_end:
                        raise AssertionError("the held generate timed out")
                    time.sleep(0.001)
            return orig(prompts, **kw)
        self.engine.generate = generate

    def pending_rows(self) -> int:
        with self.batcher._plock:
            return sum(len(sub) for sub, _ in self.batcher._pending)

    def arm(self, rows: int, until=lambda: True) -> None:
        self.armed = (rows, until)

    def remove(self) -> None:
        del self.engine.generate


def agents_round(R, backend, hists, sids, concurrent: bool, spy=None):
    """One round of the serve traffic's JSON rows, one agent (session)
    each: from one thread per agent at once (the first generate held
    until the others have queued), or in turn. Returns the wall ms, the
    results and each call's ms."""
    def one(k):
        t0 = time.monotonic()
        (r,) = backend.query([R.QueryRequest(
            MODEL, hists[k], temperature=TEMPS[k], max_tokens=MAX_TOKENS,
            session_id=sids[k], constrain_json=True)])
        if not r.ok:
            raise AssertionError(f"row error: {r.error}")
        return r, (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    if concurrent:
        spy.arm(len(hists))
        with ThreadPoolExecutor(max_workers=len(hists)) as ex:
            out = [f.result(timeout=600) for f in
                   [ex.submit(one, k) for k in range(len(hists))]]
    else:
        out = [one(k) for k in range(len(hists))]
    return (time.monotonic() - t0) * 1e3, [r for r, _ in out], \
        [ms for _, ms in out]


def batch_coalescing(torch, R, dfa, base) -> tuple:
    """Three agents on a fresh llama-3-8b engine over the serve phase's
    weights: round 1 and the resumed round 2 from three threads (merged),
    then three more agents' same two rounds in turn; the resumed rounds
    timed side by side. Returns the report, the backend and its spy."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    eng = GenerateEngine(base.cfg, base.params, base.tokenizer, seed=0,
                         device="cuda")
    backend = R.TorchBackend([MODEL], device="cuda", engines={MODEL: eng})
    spy = HeldGenerate(backend)
    # the JSON grammar table first (seconds on the host), outside the
    # timed rounds
    backend.query([R.QueryRequest(MODEL, chat("warm up", 1),
                                  temperature=0.0, max_tokens=1,
                                  constrain_json=True)])
    users = ["pick the next action", "decide what to do next",
             "propose one step"]
    out = {}
    for label, concurrent in (("concurrent", True), ("in_turn", False)):
        sids = [f"{label}-{k}" for k in range(3)]
        hists = [chat(u, N_RULES) for u in users]
        rounds = []
        for rnd in (1, 2):
            n0 = len(spy.sizes)
            torch.cuda.synchronize()
            wall, res, ms = agents_round(R, backend, hists, sids,
                                         concurrent, spy)
            check_json([res], dfa)
            rounds.append({"round": rnd, "wall_ms": wall, "call_ms": ms,
                           "batch_sizes": spy.sizes[n0:],
                           "prefill_ms": [r.prefill_ms for r in res],
                           "decode_ms": [r.decode_ms for r in res],
                           "cached_tokens": [r.cached_tokens for r in res],
                           "new_tokens": [r.usage.completion_tokens
                                          for r in res]})
            hists = [h + [{"role": "assistant", "content": r.text},
                          {"role": "user", "content": "refine your proposal"}]
                     for h, r in zip(hists, res)]
        out[label] = {"rounds": rounds,
                      "sessions": [eng.sessions.get(s) is not None
                                   for s in sids]}
    for rnd in out["concurrent"]["rounds"]:
        sizes = rnd["batch_sizes"]
        if not (len(sizes) < 3 and sum(sizes) == 3):
            raise AssertionError(f"three agents were not merged: {out}")
    if not all(out["concurrent"]["sessions"] + out["in_turn"]["sessions"]):
        raise AssertionError(f"a session was not stored: {out}")
    out["resumed_round_ms"] = {
        "concurrent": out["concurrent"]["rounds"][1]["wall_ms"],
        "in_turn": out["in_turn"]["rounds"][1]["wall_ms"]}
    return out, backend, spy


def batch_deadlines(R, backend, spy) -> dict:
    """A row with deadline_ms=0 never reaches generate; a row whose
    deadline lapses while another caller holds the baton is dropped from
    the batch, which runs without it."""
    hist = chat("pick the next action", N_RULES)
    n0 = len(spy.sizes)
    (r0,) = backend.query([R.QueryRequest(MODEL, hist, temperature=0.0,
                                          max_tokens=4, deadline_ms=0)])
    build = {"error": r0.error, "generate_calls": len(spy.sizes) - n0}
    if not (r0.error or "").startswith("deadline_exceeded:") or \
            build["generate_calls"] != 0:
        raise AssertionError(f"build-time deadline: {build}")

    def late_lapsed():
        with spy.batcher._plock:
            rows = [r for sub, _ in spy.batcher._pending for r in sub]
        return any(r["deadline_s"] is not None
                   and time.monotonic() > r["deadline_s"] for r in rows)
    n0 = len(spy.sizes)
    spy.arm(3, late_lapsed)
    with ThreadPoolExecutor(max_workers=2) as ex:
        holder = ex.submit(backend.query, [R.QueryRequest(
            MODEL, hist, temperature=0.0, max_tokens=4,
            session_id="deadline-holder")])
        t_end = time.monotonic() + 60
        while spy.armed is not None:       # the holder is inside generate
            if time.monotonic() > t_end:
                raise AssertionError("the holder never reached generate")
            time.sleep(0.001)
        late = ex.submit(backend.query, [
            R.QueryRequest(MODEL, hist, temperature=0.0, max_tokens=4,
                           session_id="deadline-late", deadline_ms=2000),
            R.QueryRequest(MODEL, hist, temperature=0.0, max_tokens=4,
                           session_id="deadline-next")])
        (h,) = holder.result(timeout=600)
        lr, nr = late.result(timeout=600)
    serve = {"late_error": lr.error, "next_ok": nr.ok, "holder_ok": h.ok,
             "batch_sizes": spy.sizes[n0:]}
    if not ((lr.error or "").startswith("deadline_exceeded:") and nr.ok
            and h.ok and serve["batch_sizes"] == [1, 1]):
        raise AssertionError(f"serve-time deadline: {serve}")
    return {"build_time": build, "serve_time": serve}


def batch_overlap(torch, R, kernels, pool_backend) -> dict:
    """One consensus-shaped round over the decide pool (one greedy JSON
    row a member, the decide's system prompt and action set, 32 new
    tokens, fresh sessions each run, dropped after it) with the members
    served concurrently (overlap) and in turn, alternating, twice each,
    after a warm-up run that builds the grammar tables and caches the
    prompt's pages: round wall ms, each member's prefill and decode ms,
    and the launches of each run, which must be equal."""
    messages = [{"role": "system", "content": wait_only_system_prompt()},
                {"role": "user", "content": "Task: keep the build green. "
                                            "Decide the next step."}]
    runs = []
    for k, overlap in enumerate((False, True, False, True, False)):
        pool_backend.overlap = overlap
        sid = f"overlap-{k}"
        reqs = [R.QueryRequest(m, messages, temperature=0.0,
                               max_tokens=MAX_TOKENS, session_id=sid,
                               constrain_json=True, action_enum=("wait",))
                for m in DECIDE_POOL]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        res = pool_backend.query(reqs)
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
        if not all(r.ok for r in res):
            raise AssertionError(f"overlap row error: {res}")
        runs.append({"overlap": overlap, "warm_up": k == 0,
                     "wall_ms": wall,
                     "launches": kernels.launch_counts(),
                     "members": {r.model_spec: {
                         "prefill_ms": r.prefill_ms,
                         "decode_ms": r.decode_ms,
                         "latency_ms": r.latency_ms,
                         "cached_tokens": r.cached_tokens,
                         "new_tokens": r.usage.completion_tokens}
                         for r in res},
                     "texts": [r.text for r in res]})
        pool_backend.drop_session(sid)
    pool_backend.overlap = True
    timed = runs[1:]
    if not all(r["launches"] == timed[0]["launches"]
               and r["texts"] == timed[0]["texts"] for r in timed):
        raise AssertionError(f"overlap changed the launches or the texts: "
                             f"{[(r['launches'], r['texts']) for r in timed]}")
    for r in runs:
        r["texts"] = [t[:48] for t in r["texts"]]
    return {"runs": runs,
            "wall_ms": {"overlap": [r["wall_ms"] for r in timed
                                    if r["overlap"]],
                        "in_turn": [r["wall_ms"] for r in timed
                                    if not r["overlap"]]}}


def phase_batch(torch, R, kernels, dfa, backend, pool_backend) -> dict:
    """The JAX backend's default dispatch on the card: three agents'
    rounds merged by llama-3-8b's baton batcher against the same rounds
    in turn, the decide pool's members served concurrently against in
    turn (equal launches), and the two deadline checks."""
    report = {"phase": "batch", "model": MODEL}
    kernels.reset_launch_counts()
    report["coalescing"], b, spy = batch_coalescing(
        torch, R, dfa, backend.engines[MODEL])
    report["coalescing_launches"] = kernels.launch_counts()
    report["deadlines"] = batch_deadlines(R, b, spy)
    spy.remove()
    del b, spy
    torch.cuda.empty_cache()
    report["overlap"] = batch_overlap(torch, R, kernels, pool_backend)
    return report


# -- the continuous phase ----------------------------------------------------

CONT_CHUNK = 32             # TorchBackend's continuous_chunk default
LATE_A_TOKENS = 256         # agent A's row in the late-arrival schedule
LATE_B_TOKENS = 8           # agent B's row


class GenerateLog:
    """Wraps an engine's ``generate`` (in this script, not in the
    package): records each call's batch size and, once ``hold()`` is
    called, holds the next call until ``release()``, so that rows are
    queued behind it and never left to timing."""

    def __init__(self, engine):
        self.engine = engine
        self.sizes: list[int] = []
        self._hold = None
        self.entered = threading.Event()
        orig = engine.generate

        def generate(prompts, **kw):
            self.sizes.append(len(prompts))
            gate, self._hold = self._hold, None
            if gate is not None:
                self.entered.set()
                if not gate.wait(120):
                    raise AssertionError("the held generate timed out")
            return orig(prompts, **kw)
        engine.generate = generate

    def hold(self) -> threading.Event:
        self.entered.clear()
        self._hold = threading.Event()
        return self._hold

    def remove(self) -> None:
        del self.engine.generate


def wait_until(pred, what: str, timeout: float = 120.0) -> None:
    """Poll ``pred`` every 5 ms: a poller takes the GIL from the decode
    threads it watches, so it stays coarse."""
    t_end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def first_diff(a: list, b: list):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def fp32_cut(torch, cfg, seed: int, cpu_copy: bool = False):
    """Random fp32 weights of ``cfg`` drawn on the card from a generator
    seeded ``seed`` (a CPU draw of a full-width cut takes ~10 s); with
    ``cpu_copy``, (card weights, an identical copy on the CPU)."""
    from quoracle_tpu_torch.models.transformer import (
        Transformer, init_params,
    )
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device="cuda", dtype=torch.float32)
    if not cpu_copy:
        return params
    cpu = Transformer.empty(cfg, "cpu", torch.float32)
    cpu.load_state_dict(params.state_dict())
    return params, cpu


def continuous_equality(torch, R, kernels) -> dict:
    """The loop against one-shot ``engine.generate`` at temperature 0, on
    a 2-layer fp32 cut of llama-3-8b (full width) on the card: an
    unconstrained row, a JSON row, and two JSON rows with different action
    enums, all four sharing each chunk, at chunk 4 and at chunk 32. Tokens
    must be equal, the loop's owned sessions gone after each run, and
    ragged_fwd must have run in the loop."""
    from quoracle_tpu_torch.models import config as C
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.scheduler import ContinuousBatcher
    from quoracle_tpu_torch.models.tokenizer import get_tokenizer
    cfg = C.register_model(dataclasses.replace(
        C.get_model_config(MODEL), name="llama-3-8b-2layer", n_layers=2))
    spec = f"xla:{cfg.name}"
    params = fp32_cut(torch, cfg, 1)
    eng = GenerateEngine(cfg, params, get_tokenizer(spec), device="cuda")
    tok = eng.tokenizer
    rows = [("state the plan", False, None),
            ("pick the next action", True, None),
            ("decide what to do next", True, ("wait",)),
            ("propose one step", True, ("orient", "todo", "wait"))]
    prompts = [tok.encode_chat(chat(u, 8)) for u, _, _ in rows]
    n_new = 40
    # one-shot rows sessioned too, so both sides serve on the unified
    # tier: what differs is only the chunk boundary (a 1-token chunk tick
    # where one-shot runs a decode tick)
    want = [eng.generate([p], temperature=0.0, max_new_tokens=n_new,
                         session_ids=[f"one-shot-{i}"], constrain_json=[c],
                         action_enums=[e])[0]
            for i, (p, (_, c, e)) in enumerate(zip(prompts, rows))]
    for i in range(len(rows)):
        eng.drop_session(f"one-shot-{i}")
    out = {"model": spec, "dtype": "float32", "new_tokens": n_new,
           "prompt_tokens": [len(p) for p in prompts], "chunks": {}}
    for chunk in (4, CONT_CHUNK):
        sessions0 = len(eng.sessions)
        log = GenerateLog(eng)
        kernels.reset_launch_counts()
        cb = ContinuousBatcher(eng, chunk=chunk)
        try:
            futs = [cb.submit(p, temperature=0.0, max_new_tokens=n_new,
                              constrain_json=c, action_enum=e)
                    for p, (_, c, e) in zip(prompts, rows)]
            got = [f.result(timeout=300) for f in futs]
        finally:
            cb.close()
            log.remove()
        torch.cuda.synchronize()
        out["chunks"][chunk] = {
            "equal": [g.token_ids == w.token_ids for g, w in zip(got, want)],
            "first_diff": [first_diff(g.token_ids, w.token_ids)
                           for g, w in zip(got, want)],
            "new_tokens": [g.n_gen_tokens for g in got],
            "json_state": [g.json_state for g in got],
            "batch_sizes": log.sizes, "steps": cb.stats()["steps"],
            "sessions_back": len(eng.sessions) == sessions0,
            "launches": kernels.launch_counts()}
    for chunk, r in out["chunks"].items():
        if not (all(r["equal"]) and r["sessions_back"]
                and r["launches"]["ragged_fwd"] > 0):
            emit({"phase": "continuous", "equality": out})
            raise AssertionError(f"chunk {chunk}: the loop and one-shot "
                                 f"disagree")
    return out


def late_arrival(torch, R, kernels, eng, mode: str, trigger: dict) -> dict:
    """Agent A's JSON row of LATE_A_TOKENS new tokens, then agent B's row
    of LATE_B_TOKENS, sent once A's work has gone two chunks: in
    ``continuous`` mode once A's loop has stepped twice (and the ragged
    launches made by then are noted in ``trigger``); in ``baton`` mode
    once the same number of ragged launches has been made inside A's
    generate. Returns both rows' latencies, A's chunks and ms per chunk,
    and the loop's rows per step."""
    kw = {"continuous": True, "continuous_chunk": CONT_CHUNK, "qos": True} \
        if mode == "continuous" else {}
    backend = R.TorchBackend([MODEL], device="cuda", engines={MODEL: eng},
                             **kw)
    log = GenerateLog(eng)
    res = {}

    def send(key, user, n, constrain):
        t0 = time.monotonic()
        (r,) = backend.query([R.QueryRequest(
            MODEL, chat(user, N_RULES), temperature=0.0, max_tokens=n,
            session_id=f"late-{key}-{mode}", constrain_json=constrain)])
        res[key] = (r, (time.monotonic() - t0) * 1e3)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        a = threading.Thread(target=send, args=(
            "A", "write the full plan as JSON", LATE_A_TOKENS, True))
        a.start()
        if mode == "continuous":
            cb = backend._cbatchers[MODEL]
            wait_until(lambda: cb.stats()["steps"] >= 2, "two loop steps")
            trigger["ragged_fwd"] = kernels.launch_counts()["ragged_fwd"]
        else:
            wait_until(lambda: kernels.launch_counts()["ragged_fwd"]
                       >= trigger["ragged_fwd"], "A's first two chunks")
        b_at = kernels.launch_counts()["ragged_fwd"]
        b = threading.Thread(target=send, args=(
            "B", "one quick word", LATE_B_TOKENS, False))
        b.start()
        for t in (a, b):
            t.join(600)
            if t.is_alive():
                raise AssertionError("a late-arrival row hung")
        torch.cuda.synchronize()
        stats = backend.scheduler_stats().get(MODEL)
    finally:
        log.remove()
        backend.close()
    (ra, a_ms), (rb, b_ms) = res["A"], res["B"]
    if not (ra.ok and rb.ok):
        raise AssertionError(f"late arrival {mode}: {ra.error} {rb.error}")
    out = {"b_ms": b_ms, "a_ms": a_ms,
           "a_new_tokens": ra.usage.completion_tokens,
           "b_new_tokens": rb.usage.completion_tokens,
           "b_sent_at_ragged_launches": b_at,
           "generate_calls": len(log.sizes), "rows_per_call": log.sizes,
           "launches": kernels.launch_counts()}
    if mode == "continuous":
        out["a_chunks"] = -(-ra.usage.completion_tokens // CONT_CHUNK)
        out["a_ms_per_chunk"] = a_ms / out["a_chunks"]
        out["steps"] = stats["steps"]
    eng.drop_session(f"late-A-{mode}")
    eng.drop_session(f"late-B-{mode}")
    return out


def continuous_serve(torch, R, kernels, dfa, eng) -> dict:
    """The serve traffic's three agents, round 1 and the resumed round 2,
    through llama-3-8b's loop: every text a JSON prefix, round 2 resumes,
    ragged_fwd runs and the paged kernels never do."""
    backend = R.TorchBackend([MODEL], device="cuda", engines={MODEL: eng},
                             continuous=True, continuous_chunk=CONT_CHUNK,
                             qos=True)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        rounds, results, _ = run_rounds(R, backend, MODEL, TEMPS,
                                        MAX_TOKENS, N_RULES,
                                        sessionless=False)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        stats = backend.scheduler_stats()[MODEL]
    finally:
        backend.close()
    check_json(results, dfa)
    out = {"rounds": rounds, "launches": launches,
           "loop": {k: stats[k] for k in ("steps", "retired", "failed")}}
    if min(rounds[1]["cached_tokens"]) <= 0 or not (
            launches["ragged_fwd"] > 0 and launches["paged_fwd"]
            == launches["paged_prefill_fwd"] == 0):
        emit({"phase": "continuous", "serve": out})
        raise AssertionError("the continuous serve rounds failed a check")
    for i in range(3):
        eng.drop_session(f"agent-{i}")
    return out


def continuous_qos(torch, R, kernels, eng) -> dict:
    """QoS on the card, on llama-3-8b. Order: one slot, a long BATCH row
    in it (its first chunk held) while six BATCH rows and then one
    INTERACTIVE row queue; the INTERACTIVE row must be popped first of
    the queued rows (BATCH weight 1, so the long row's admission spent
    BATCH's DRR credit; aging floor 600 s). Shed: a BATCH row past
    max_queue_depth=2 comes back admission_rejected with its retry hint.
    Deadlines: deadline_ms=0 fails at row build (no generate call, the
    loop untouched); a row whose deadline lapses in the queue fails at
    admit and is never retired."""
    from quoracle_tpu_torch.infra import telemetry as T
    from quoracle_tpu_torch.models.scheduler import ContinuousBatcher
    from quoracle_tpu_torch.serving import admission as A
    from quoracle_tpu_torch.serving import qos as Q
    from quoracle_tpu_torch.serving.slo import SLOTracker
    out = {}
    # -- order
    pol = Q.WeightedFairPolicy(weights={Q.Priority.BATCH: 1.0},
                               aging_floor_s=600.0, model=eng.cfg.name)
    popped = []
    pop = pol.pop

    def spy_pop():
        r = pop()
        if r is not None:
            popped.append(Q.class_name(r.priority))
        return r
    pol.pop = spy_pop
    waits0 = {c: T.QOS_ADMIT_WAIT_MS.counts(cls=c)[1:]
              for c in ("interactive", "batch")}
    log = GenerateLog(eng)
    cb = ContinuousBatcher(eng, chunk=CONT_CHUNK, max_slots=1, policy=pol,
                           admission=A.AdmissionController(),
                           slo=SLOTracker())
    tok = eng.tokenizer
    try:
        gate = log.hold()
        long = cb.submit(tok.encode_chat(chat("a long batch job", 4)),
                         temperature=0.0, max_new_tokens=CONT_CHUNK,
                         priority=Q.Priority.BATCH)
        if not log.entered.wait(120):
            raise AssertionError("the long row never reached generate")
        futs = [cb.submit(tok.encode_chat(chat(f"batch item {i}", 4)),
                          temperature=0.0, max_new_tokens=4,
                          priority=Q.Priority.BATCH) for i in range(6)]
        futs.append(cb.submit(tok.encode_chat(chat("a human waits", 4)),
                              temperature=0.0, max_new_tokens=4,
                              priority=Q.Priority.INTERACTIVE))
        queued = cb.stats()["queued"]
        gate.set()
        for f in [long] + futs:
            f.result(timeout=300)
    finally:
        log.remove()
        cb.close()
    waits = {}
    for c, (s0, n0) in waits0.items():
        _, s1, n1 = T.QOS_ADMIT_WAIT_MS.counts(cls=c)
        waits[c] = {"rows": n1 - n0, "mean_wait_ms": (s1 - s0) / max(
            1, n1 - n0)}
    out["order"] = {"queued_behind_long_row": queued, "popped": popped,
                    "served": {Q.class_name(k): v
                               for k, v in pol.served.items()},
                    "admit_wait": waits, "rows_per_call": log.sizes}
    if not (queued == 7 and popped[:2] == ["batch", "interactive"]
            and popped[2:] == ["batch"] * 6):
        emit({"phase": "continuous", "qos": out})
        raise AssertionError("INTERACTIVE was not admitted before the "
                             "queued BATCH rows")
    # -- shed and deadlines, through the backend
    backend = R.TorchBackend(
        [MODEL], device="cuda", engines={MODEL: eng}, continuous=True,
        continuous_chunk=CONT_CHUNK, continuous_slots=1,
        qos=Q.QoSConfig(admission=A.AdmissionConfig(max_queue_depth=2)))
    cb = backend._cbatchers[MODEL]
    log = GenerateLog(eng)
    hist = chat("pick the next action", 4)
    res = {}

    def query(key, reqs):
        res[key] = backend.query(reqs)
    try:
        gate = log.hold()
        holder = threading.Thread(target=query, args=("holder", [
            R.QueryRequest(MODEL, hist, temperature=0.0, max_tokens=4,
                           session_id="qos-holder")]))
        holder.start()
        if not log.entered.wait(120):
            raise AssertionError("the holder never reached generate")
        shed = threading.Thread(target=query, args=("shed", [
            R.QueryRequest(MODEL, hist, temperature=0.0, max_tokens=4,
                           session_id=f"qos-batch-{i}", priority=2)
            for i in range(3)]))
        shed.start()
        wait_until(lambda: cb.stats()["queued"] == 2
                   and cb.stats()["failed"] == 1, "two queued, one shed")
        gate.set()
        for t in (holder, shed):
            t.join(600)
        n_calls, st0 = len(log.sizes), cb.stats()
        res["zero"] = backend.query([R.QueryRequest(
            MODEL, hist, temperature=0.0, max_tokens=4, deadline_ms=0)])
        st1 = cb.stats()
        zero = {"error": res["zero"][0].error,
                "generate_calls": len(log.sizes) - n_calls,
                "loop_unchanged": all(st0[k] == st1[k] for k in (
                    "retired", "failed", "steps"))}
        # a row whose deadline lapses while the holder's chunk is held
        gate = log.hold()
        holder = threading.Thread(target=query, args=("holder2", [
            R.QueryRequest(MODEL, hist, temperature=0.0, max_tokens=4,
                           session_id="qos-holder")]))
        holder.start()
        if not log.entered.wait(120):
            raise AssertionError("the second holder never reached generate")
        late = threading.Thread(target=query, args=("late", [
            R.QueryRequest(MODEL, hist, temperature=0.0, max_tokens=4,
                           session_id="qos-late", deadline_ms=1500)]))
        late.start()
        wait_until(lambda: cb.stats()["queued"] == 1, "the late row queued")
        t_lapse = time.monotonic() + 1.6
        wait_until(lambda: time.monotonic() > t_lapse, "its deadline", 10)
        st2 = cb.stats()
        gate.set()
        for t in (holder, late):
            t.join(600)
        st3 = cb.stats()
        queued_row = {"error": res["late"][0].error,
                      "retired_delta": st3["retired"] - st2["retired"],
                      "failed_delta": st3["failed"] - st2["failed"]}
        qstats = backend.qos_stats()
    finally:
        log.remove()
        backend.close()
    rej = res["shed"][2].error or ""
    out["shed"] = {"errors": [r.error for r in res["shed"]],
                   "holder_ok": res["holder"][0].ok}
    out["deadline"] = {"at_build": zero, "in_queue": queued_row}
    out["qos_stats"] = qstats
    if not (rej.startswith("admission_rejected:")
            and "retry_after_ms=" in rej
            and res["shed"][0].ok and res["shed"][1].ok
            and (zero["error"] or "").startswith("deadline_exceeded:")
            and zero["generate_calls"] == 0 and zero["loop_unchanged"]
            and (queued_row["error"] or "").startswith(
                "deadline_exceeded:")
            and queued_row["retired_delta"] == 1
            and queued_row["failed_delta"] == 1
            and qstats["admission"]["hbm_headroom"] is not None):
        emit({"phase": "continuous", "qos": out})
        raise AssertionError("a QoS check failed on the card")
    return out


def continuous_pool(torch, R, kernels, pool_backend) -> dict:
    """The decide pool under continuous batching (the pool backend's
    engines, grammar tables already built; one loop a member): one decide
    of the decide phase's agent set, which must end "ok" with a decision,
    then the embedder on the system prompt and its texts (flash); then
    one consensus-shaped greedy round (one JSON row a member, 32 new
    tokens, fresh sessions) with all three members' loops running, and
    each member's row with its loop alone, twice each in turns: what
    three decode threads cost each other."""
    from quoracle_tpu_torch.consensus import engine as CE
    cpool = R.TorchBackend(DECIDE_POOL, device="cuda",
                           engines=pool_backend.engines,
                           embedder=pool_backend.embedder,
                           continuous=True, continuous_chunk=CONT_CHUNK,
                           qos=True)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outcomes, records = run_decides(
            R, CE, cpool, DECIDE_POOL, DECIDE_MAX_TOKENS,
            session_key="agent-continuous", steps=1)
        # a text the embedder's cache has not seen (the decide phase
        # embedded the bare system prompt), long enough for a 256-token
        # chunk: flash
        texts = [wait_only_system_prompt() + "\n(continuous phase)"]
        if outcomes[0].decision is not None:
            texts += decide_texts(outcomes[0])
        vecs = cpool.embed(texts)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        decide = decide_summary(outcomes[0], records[0])
        steps = {m: st["steps"] for m, st in
                 cpool.scheduler_stats().items()}
        messages = [{"role": "system", "content": wait_only_system_prompt()},
                    {"role": "user", "content": "Task: keep the build "
                                                "green. Decide the next "
                                                "step."}]
        runs = []
        alone = [[m] for m in DECIDE_POOL]
        for k, members in enumerate(([DECIDE_POOL] + alone) * 2):
            sid = f"cont-round-{k}"
            torch.cuda.synchronize()
            t0 = time.monotonic()
            res = cpool.query([R.QueryRequest(
                m, messages, temperature=0.0, max_tokens=MAX_TOKENS,
                session_id=sid, constrain_json=True, action_enum=("wait",))
                for m in members])
            torch.cuda.synchronize()
            wall = (time.monotonic() - t0) * 1e3
            if not all(r.ok for r in res):
                raise AssertionError(f"continuous pool row error: {res}")
            runs.append({"members": len(members), "wall_ms": wall,
                         "latency_ms": {r.model_spec: r.latency_ms
                                        for r in res},
                         "new_tokens": {r.model_spec:
                                        r.usage.completion_tokens
                                        for r in res}})
            cpool.drop_session(sid)
        qstats = cpool.qos_stats()
    finally:
        cpool.close()
    out = {"decide": decide, "loop_steps": steps, "launches": launches,
           "embed_texts": len(vecs), "rounds": runs,
           "member_ms": {m: {"all_loops": [r["latency_ms"][m] for r in runs
                                           if r["members"] > 1],
                             "alone": [r["latency_ms"][m] for r in runs
                                       if r["members"] == 1
                                       and m in r["latency_ms"]]}
                         for m in DECIDE_POOL},
           "wall_ms": {"all_loops": [r["wall_ms"] for r in runs
                                     if r["members"] > 1],
                       "members_alone_summed": [
                           sum(r["wall_ms"] for r in runs[i + 1:i + 1
                                                           + len(alone)])
                           for i in range(0, len(runs), 1 + len(alone))]},
           "admission": {k: qstats["admission"][k] for k in (
               "admitted", "shed", "hbm_headroom")}}
    if decide["status"] != "ok" or decide["decision"] is None or not (
            launches["ragged_fwd"] > 0 and launches["flash_fwd"] > 0):
        emit({"phase": "continuous", "pool": out})
        raise AssertionError("the continuous decide failed its checks")
    return out


def phase_continuous(torch, R, kernels, dfa, backend, pool_backend,
                     baton_decide_ms=None) -> dict:
    """Continuous batching with QoS admission on the card: equality with
    one-shot generate (fp32 cut), a late arrival under the loop and under
    the baton batcher, the serve traffic through the loop, the QoS order,
    shed and deadline checks, and the decide pool under the loop. Every
    backend it builds is closed, and no ``batcher-`` thread outlives it."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    report = {"phase": "continuous", "model": MODEL, "chunk": CONT_CHUNK}
    report["equality"] = continuous_equality(torch, R, kernels)
    torch.cuda.empty_cache()
    base = backend.engines[MODEL]

    def fresh():
        return GenerateEngine(base.cfg, base.params, base.tokenizer, seed=0,
                              device="cuda")
    eng = fresh()
    # the JSON grammar table first (seconds on the host), outside the
    # timed rows
    eng.generate([eng.tokenizer.encode_chat(chat("warm up", 1))],
                 temperature=0.0, max_new_tokens=1, constrain_json=[True])
    trigger: dict = {}
    late = {"continuous": late_arrival(torch, R, kernels, eng, "continuous",
                                       trigger)}
    beng = fresh()
    # the same grammar table, so the baton run pays no build either
    beng._json_cache = eng._json_cache
    late["baton"] = late_arrival(torch, R, kernels, beng, "baton", trigger)
    del beng
    torch.cuda.empty_cache()
    report["late_arrival"] = late
    report["serve"] = continuous_serve(torch, R, kernels, dfa, eng)
    report["qos"] = continuous_qos(torch, R, kernels, eng)
    del eng
    torch.cuda.empty_cache()
    report["pool"] = continuous_pool(torch, R, kernels, pool_backend)
    report["pool"]["baton_decide_ms"] = baton_decide_ms
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("batcher-")]
    report["batcher_threads_alive"] = alive
    if alive:
        emit(report)
        raise AssertionError(f"batcher threads outlived close(): {alive}")
    return report


# -- the spec phase ----------------------------------------------------------

SPEC_K = 6                  # TorchBackend's draft_k default
SPEC_CUT_TOKENS = 40        # new tokens a row of the fp32 cut
# the bf16 JSON row's new tokens, cut for the script's 1,200 s (at 256,
# its three runs took 75 s of one slow H100 host's whole run)
SPEC_LONG_TOKENS = 128
CUT_POOL_BYTES = 512 << 20  # session pool of an fp32-cut engine


class VerifyLog:
    """Wraps an engine's ``verify_chunk`` (in this script, not in the
    package): counts its calls and the kernel launches made inside them
    (one loop thread drives the engine), and holds ``active`` while one
    runs, so that ``verify_recorder`` keeps a verify tick's inputs."""

    def __init__(self, engine, kernels):
        self.engine = engine
        self.active = False
        self.calls = 0
        self.launches = dict.fromkeys(kernels.launch_counts(), 0)
        orig = engine.verify_chunk

        def verify_chunk(*a, **kw):
            before = kernels.launch_counts()
            self.active = True
            try:
                return orig(*a, **kw)
            finally:
                self.active = False
                self.calls += 1
                for k, v in kernels.launch_counts().items():
                    self.launches[k] += v - before[k]
        engine.verify_chunk = verify_chunk

    def remove(self) -> None:
        del self.engine.verify_chunk


def verify_recorder(torch, P, kept: dict, key: str, log: VerifyLog):
    """A stand-in for ``P.ragged_attend`` that keeps (cloned) the inputs
    of the first ragged call made inside a verify chunk under
    kept[key]; restore with ``P.ragged_attend = rec.orig``."""
    orig = P.ragged_attend

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def rec(q, k_pages, v_pages, tables, meta, tq, sliding_window=None,
            **kw):
        if log.active and key not in kept:
            kept[key] = ([clone(x) for x in (q, k_pages, v_pages, tables,
                                             meta, tq, sliding_window)],
                         {n: clone(x) for n, x in kw.items()})
        return orig(q, k_pages, v_pages, tables, meta, tq, sliding_window,
                    **kw)
    rec.orig = orig
    return rec


def spec_loop(torch, eng, prompts, cons, n_new, speculator=None) -> tuple:
    """The rows through one ContinuousBatcher at CONT_CHUNK (with the
    speculator, or spec off); returns the results and the wall ms."""
    from quoracle_tpu_torch.models.scheduler import ContinuousBatcher
    torch.cuda.synchronize()
    t0 = time.monotonic()
    cb = ContinuousBatcher(eng, chunk=CONT_CHUNK, speculator=speculator)
    try:
        futs = [cb.submit(p, temperature=0.0, max_new_tokens=n_new,
                          constrain_json=c) for p, c in zip(prompts, cons)]
        got = [f.result(timeout=600) for f in futs]
    finally:
        cb.close()
    torch.cuda.synchronize()
    return got, (time.monotonic() - t0) * 1e3


def spec_compare(off, on) -> dict:
    return {"equal": [a.token_ids == b.token_ids for a, b in zip(off, on)],
            "first_diff": [first_diff(a.token_ids, b.token_ids)
                           for a, b in zip(off, on)],
            "new_tokens": [g.n_gen_tokens for g in on],
            "spec_rounds": [g.spec_rounds for g in on],
            "drafted": [g.spec_drafted_tokens for g in on],
            "accepted": [g.spec_accepted_tokens for g in on]}


def spec_errors(stats: dict) -> int:
    return stats["fallbacks"].get("error", 0)


def spec_cut_params(torch, seed: int):
    """A 2-layer fp32 cut of llama-3-8b (full width), drawn on the card."""
    from quoracle_tpu_torch.models import config as C
    cfg = C.register_model(dataclasses.replace(
        C.get_model_config(MODEL), name="llama-3-8b-2layer", n_layers=2))
    return cfg, fp32_cut(torch, cfg, seed)


def share_grammar(dec, eng) -> None:
    """Hand the batch-1 decoder the engine's plain-JSON table (same
    tokenizer and vocab), so it builds none of its own."""
    eng._json_table_device((None,))
    dec._grammar_cache[None] = (eng._json_cache[("one", None)].table,
                                eng._json_cache[("one", None)].start_state,
                                eng._json_cache[("dev", None)])


def spec_fp32_cut(torch, R, P, kernels, base, kept: dict) -> dict:
    """Speculation on and off through the loop over a 2-layer fp32 cut of
    llama-3-8b on the card, an unconstrained and a JSON row at temperature
    0 (self-draft, K 6): on the unified tier, the forced gather tier and
    int8 pools the tokens must equal spec off. A hopeless draft (a second
    cut from another seed) must disengage and re-probe with the tokens
    still equal. Then the batch-1 decoder over a prompt of 300+ tokens
    must equal vanilla and launch flash. The first verify tick's ragged
    inputs are kept (float pages, int8 pages)."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.speculative import (
        BatchedSpeculator, SpeculativeDecoder,
    )
    cfg, params = spec_cut_params(torch, 1)
    tok = base.tokenizer

    def engine(**kw):
        eng = GenerateEngine(cfg, params, tok, device="cuda",
                             session_max_bytes=CUT_POOL_BYTES, **kw)
        eng._json_cache = base._json_cache       # same tokenizer and vocab
        return eng
    users = [("state the plan", False), ("pick the next action", True)]
    prompts = [tok.encode_chat(chat(u, 8)) for u, _ in users]
    cons = [c for _, c in users]
    out = {"model": f"xla:{cfg.name}", "dtype": "float32", "k": SPEC_K,
           "new_tokens": SPEC_CUT_TOKENS,
           "prompt_tokens": [len(p) for p in prompts], "tiers": {}}
    eng = engine()
    for tier in ("unified", "gather", "int8"):
        e = engine(quantize_kv=True) if tier == "int8" else eng
        e._force_gather_decode = tier == "gather"
        key = {"unified": "ragged_fwd", "int8": "ragged_q8_fwd"}.get(tier)
        off, off_ms = spec_loop(torch, e, prompts, cons, SPEC_CUT_TOKENS)
        log = VerifyLog(e, kernels)
        if key:
            P.ragged_attend = verify_recorder(torch, P, kept, key, log)
        spec = BatchedSpeculator(e, e, k=SPEC_K)
        try:
            on, on_ms = spec_loop(torch, e, prompts, cons, SPEC_CUT_TOKENS,
                                  spec)
        finally:
            log.remove()
            if key:
                P.ragged_attend = P.ragged_attend.orig
        e._force_gather_decode = False
        out["tiers"][tier] = {**spec_compare(off, on), "off_ms": off_ms,
                              "on_ms": on_ms, "stats": spec.stats(),
                              "verify_calls": log.calls,
                              "verify_launches": log.launches}
        del e
    # the hopeless draft: another cut, one unconstrained row long enough
    # to collapse, run vanilla two ticks and re-probe
    _, dparams = spec_cut_params(torch, 2)
    draft = GenerateEngine(cfg, dparams, tok, device="cuda",
                           session_max_bytes=CUT_POOL_BYTES)
    n_long = 2 * CONT_CHUNK + 8
    off, _ = spec_loop(torch, eng, prompts[:1], cons[:1], n_long)
    spec = BatchedSpeculator(eng, draft, k=4, k_min=2, reprobe_after=2)
    on, _ = spec_loop(torch, eng, prompts[:1], cons[:1], n_long, spec)
    out["hopeless"] = {**spec_compare(off, on), "new_tokens": n_long,
                       "stats": spec.stats(),
                       "draft_sessions_left": len(draft.sessions)}
    del draft, dparams
    torch.cuda.empty_cache()
    # the batch-1 decoder: a JSON row over a prompt of 300+ tokens
    dec = SpeculativeDecoder(cfg, params, cfg, params, tok, k=SPEC_K,
                             max_seq=eng.max_seq)
    share_grammar(dec, eng)
    prompt = tok.encode_chat(chat("pick the next action", 12))
    want = eng.generate([prompt], temperature=0.0,
                        max_new_tokens=SPEC_CUT_TOKENS,
                        constrain_json=[True])[0]
    before = kernels.launch_counts()
    got = dec.generate(prompt, temperature=0.0,
                       max_new_tokens=SPEC_CUT_TOKENS, constrain_json=True)
    torch.cuda.synchronize()
    out["decoder"] = {
        "prompt_tokens": len(prompt),
        "equal": got.token_ids == want.token_ids,
        "first_diff": first_diff(got.token_ids, want.token_ids),
        "new_tokens": got.n_gen_tokens, "rounds": got.rounds,
        "acceptance": got.acceptance_rate,
        "launches": {k: v - before[k]
                     for k, v in kernels.launch_counts().items()}}
    bad = [t for t, r in out["tiers"].items()
           if not (all(r["equal"]) and min(r["spec_rounds"]) > 0
                   and spec_errors(r["stats"]) == 0)]
    if (bad or not out["tiers"]["unified"]["verify_launches"]["ragged_fwd"]
            or not out["tiers"]["int8"]["verify_launches"]["ragged_q8_fwd"]
            or not all(out["hopeless"]["equal"])
            or out["hopeless"]["stats"]["disengages"] < 1
            or out["hopeless"]["stats"]["reprobes"] < 1
            or spec_errors(out["hopeless"]["stats"])
            or not out["decoder"]["equal"]
            or out["decoder"]["prompt_tokens"] < 300
            or not out["decoder"]["launches"]["flash_fwd"]
            or "ragged_fwd" not in kept or "ragged_q8_fwd" not in kept):
        emit({"phase": "spec", "fp32_cut": out})
        raise AssertionError(f"the fp32 cut failed its checks: {bad}")
    return out


def spec_bf16(torch, R, P, kernels, base, kept: dict) -> dict:
    """llama-3-8b in bf16 at full depth over the serve phase's weights,
    self-draft: one JSON row of SPEC_LONG_TOKENS through the loop, spec
    off and then on (wall ms, ms per committed token, rounds, acceptance,
    tokens a round, K after every round, the first differing token: not
    failed), the first bf16 verify tick's ragged inputs kept; then the
    same row through the batch-1 decoder."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.speculative import (
        BatchedSpeculator, SpeculativeDecoder,
    )
    eng = GenerateEngine(base.cfg, base.params, base.tokenizer, seed=0,
                         device="cuda")
    eng._json_cache = base._json_cache
    prompt = eng.tokenizer.encode_chat(chat("write the full plan as JSON",
                                            N_RULES))
    n = SPEC_LONG_TOKENS
    (off,), off_ms = spec_loop(torch, eng, [prompt], [True], n)
    log = VerifyLog(eng, kernels)
    P.ragged_attend = verify_recorder(torch, P, kept, "ragged_fwd_bf16", log)
    spec = BatchedSpeculator(eng, eng, k=SPEC_K)
    ks = []
    run_round = spec.run_round

    def traced_round(rows):
        done = sum(len(r.emitted) for r in rows)
        fin = run_round(rows)
        ks.append([spec.k, sum(len(r.emitted) for r in rows) - done])
        return fin
    spec.run_round = traced_round
    try:
        (on,), on_ms = spec_loop(torch, eng, [prompt], [True], n, spec)
    finally:
        log.remove()
        P.ragged_attend = P.ragged_attend.orig
    st = spec.stats()
    out = {"model": MODEL, "dtype": "bfloat16", "prompt_tokens": len(prompt),
           "loop": {"off_ms": off_ms, "on_ms": on_ms,
                    "off_new_tokens": off.n_gen_tokens,
                    "on_new_tokens": on.n_gen_tokens,
                    "off_ms_per_token": off_ms / max(1, off.n_gen_tokens),
                    "on_ms_per_token": on_ms / max(1, on.n_gen_tokens),
                    "equal": on.token_ids == off.token_ids,
                    "first_diff": first_diff(on.token_ids, off.token_ids),
                    "rounds": on.spec_rounds,
                    "acceptance": on.spec_accepted_tokens
                    / max(1, on.spec_drafted_tokens),
                    "tokens_per_round": st["tokens_per_round"],
                    "k_and_committed_per_round": ks, "stats": st,
                    "verify_calls": log.calls,
                    "verify_launches": log.launches}}
    dec = SpeculativeDecoder(base.cfg, base.params, base.cfg, base.params,
                             base.tokenizer, k=SPEC_K, max_seq=eng.max_seq)
    share_grammar(dec, eng)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    got = dec.generate(prompt, temperature=0.0, max_new_tokens=n,
                       constrain_json=True)
    torch.cuda.synchronize()
    dec_ms = (time.monotonic() - t0) * 1e3
    out["decoder"] = {"ms": dec_ms, "new_tokens": got.n_gen_tokens,
                      "ms_per_token": dec_ms / max(1, got.n_gen_tokens),
                      "rounds": got.rounds, "acceptance": got.acceptance_rate,
                      "tokens_per_round": got.tokens_per_round,
                      "equal": got.token_ids == off.token_ids,
                      "first_diff": first_diff(got.token_ids,
                                               off.token_ids)}
    if (on.spec_rounds <= 0 or spec_errors(st)
            or not log.launches["ragged_fwd"]):
        emit({"phase": "spec", "bf16": out})
        raise AssertionError("the bf16 speculative row failed its checks")
    return out


def spec_pool(torch, R, kernels, pool_backend) -> dict:
    """The decide pool under the loop with llama-3-8b drafted by itself
    (draft_map, QoS on): one decide that must end "ok" with llama-3-8b's
    spec rounds above 0 and the speculator in spec_stats(); then, on a
    fresh speculator, llama-3-8b's greedy JSON row (32 new tokens) with
    the other two members' loops running (an unconstrained row each) and
    with its loop alone, twice each in turns."""
    from quoracle_tpu_torch.consensus import engine as CE
    cpool = R.TorchBackend(DECIDE_POOL, device="cuda",
                           engines=pool_backend.engines,
                           embedder=pool_backend.embedder,
                           continuous=True, continuous_chunk=CONT_CHUNK,
                           qos=True, draft_map={MODEL: MODEL},
                           draft_k=SPEC_K)
    rows = []
    orig_query = cpool.query

    def spy(requests):
        res = orig_query(requests)
        rows.append({r.model_spec: [r.spec_rounds, r.spec_accepted_tokens]
                     for r in res})
        return res
    cpool.query = spy
    try:
        outcomes, records = run_decides(
            R, CE, cpool, DECIDE_POOL, DECIDE_MAX_TOKENS,
            session_key="agent-spec", steps=1)
        cpool.query = spy
        decide = decide_summary(outcomes[0], records[0])
        decide["spec_per_round"] = rows
        stats = cpool.spec_stats()
    finally:
        cpool.__dict__.pop("query", None)
        cpool.close()
    # the timed rows get a fresh speculator (a new backend over the same
    # engines): the decide's sampled rows may have disengaged the first
    tpool = R.TorchBackend(DECIDE_POOL, device="cuda",
                           engines=pool_backend.engines,
                           embedder=pool_backend.embedder,
                           continuous=True, continuous_chunk=CONT_CHUNK,
                           qos=True, draft_map={MODEL: MODEL},
                           draft_k=SPEC_K)
    messages = [{"role": "system", "content": wait_only_system_prompt()},
                {"role": "user", "content": "Task: keep the build green. "
                                            "Decide the next step."}]
    runs = []
    try:
        for k, members in enumerate(([DECIDE_POOL, [MODEL]]) * 2):
            sid = f"spec-round-{k}"
            torch.cuda.synchronize()
            # llama-3-8b's row JSON (its plain-JSON table is built), the
            # others unconstrained: no grammar build inside the timing,
            # and their loops run for the whole row
            res = tpool.query([R.QueryRequest(
                m, messages, temperature=0.0, max_tokens=MAX_TOKENS,
                session_id=sid, constrain_json=m == MODEL)
                for m in members])
            if not all(r.ok for r in res):
                raise AssertionError(f"spec pool row error: {res}")
            r0 = next(r for r in res if r.model_spec == MODEL)
            runs.append({"members": len(members), "ms": r0.latency_ms,
                         "new_tokens": r0.usage.completion_tokens,
                         "spec_rounds": r0.spec_rounds,
                         "accepted": r0.spec_accepted_tokens})
            tpool.drop_session(sid)
        row_stats = tpool.spec_stats()["members"][MODEL]
    finally:
        tpool.close()
    llama_rounds = sum(r.get(MODEL, [0])[0] for r in rows)
    member = stats["members"].get(MODEL, {})
    out = {"decide": decide, "llama_spec_rounds": llama_rounds,
           "spec_stats": stats, "llama_row": runs,
           "llama_row_spec_stats": row_stats,
           "llama_row_ms": {"all_loops": [r["ms"] for r in runs
                                          if r["members"] > 1],
                            "alone": [r["ms"] for r in runs
                                      if r["members"] == 1]}}
    if (decide["status"] != "ok" or llama_rounds <= 0
            or member.get("mode") != "continuous" or spec_errors(member)
            or spec_errors(row_stats)):
        emit({"phase": "spec", "pool": out})
        raise AssertionError("the speculative decide failed its checks")
    return out


def verify_entry(torch, P, kernel, a, kw) -> dict:
    """A ragged kernel on a kept verify tick: error against the twin
    (raises past the tolerance), device times, the bound from these
    inputs, SDPA's time, and the live blocks' query counts."""
    bm = a[4]
    return {"name": kernel.name,
            **ragged_tick_numbers(torch, P, kernel, a, kw),
            "nq": [int(x) for x in bm[:, 2] if int(x) > 0]}


def phase_spec(torch, R, kernels, P, backend, pools: list) -> dict:
    """Speculative serving on the card: the decide pool with llama-3-8b
    drafted (run first: the pool's members are then released, which
    ``pools`` holds, to give the fp32 cuts room), the fp32 cut's equality
    on three tiers, the hopeless draft and the batch-1 decoder, and the
    bf16 row at full depth, spec on and off. The launch counts are zeroed
    before and read after all three; the kept verify ticks are then held
    against the twins. No ``batcher-`` thread may outlive it."""
    base = backend.engines[MODEL]
    report = {"phase": "spec", "model": MODEL, "k": SPEC_K,
              "chunk": CONT_CHUNK}
    kept: dict = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    report["pool"] = spec_pool(torch, R, kernels, pools.pop())
    gc.collect()
    torch.cuda.empty_cache()
    report["fp32_cut"] = spec_fp32_cut(torch, R, P, kernels, base, kept)
    torch.cuda.empty_cache()
    report["bf16"] = spec_bf16(torch, R, P, kernels, base, kept)
    torch.cuda.synchronize()
    report["launches"] = kernels.launch_counts()
    report["verify_ticks"] = {
        name: verify_entry(torch, P, k, *kept[name]) for name, k in (
            ("ragged_fwd", kernels.RAGGED),
            ("ragged_q8_fwd", kernels.RAGGED_Q8),
            ("ragged_fwd_bf16", kernels.RAGGED))}
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("batcher-")]
    report["batcher_threads_alive"] = alive
    if alive or not all(report["launches"][k] for k in (
            "ragged_fwd", "ragged_q8_fwd", "flash_fwd")):
        emit(report)
        raise AssertionError(f"spec phase: threads {alive} alive, or a "
                             f"kernel of the path never launched")
    return report


def paged_library(torch, kernel, q, kp, vp, tables, ints, window,
                  k_scale=None, v_scale=None):
    """scaled_dot_product_attention on a paged kernel's work: each row's
    K/V gathered (int8 pages: and dequantized) beforehand, not timed, its
    ``paged_mask`` as attn_mask; q is [rows, n_q, H, hd]."""
    k, v = gathered_kv(torch, kp, vp, tables, q.dtype, k_scale,
                       v_scale)                        # [rows, KV, S, hd]
    mask = paged_mask(torch, kernel, kp.shape[1], tables, ints, q.shape[1],
                      window)
    qb = q.transpose(1, 2).contiguous()                # [rows, H, n_q, hd]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qb, k, v, attn_mask=mask[:, None], enable_gqa=True)


def flash_library(torch, q, k, v, qp, kv_len, window, off):
    """scaled_dot_product_attention on flash_fwd's work, in its layout
    ([B, H, T, hd], transposed beforehand, not timed) with the same
    mask."""
    from quoracle_tpu_torch.ops.attention import attention_mask
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = attention_mask(qp, kv_len, k.shape[1], window, off)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def ragged_library(torch, q, kp, vp, bt, bm, tq, window, **scales):
    return paged_library(torch, "ragged_fwd",
                         q.reshape(bt.shape[0], tq, *q.shape[1:]), kp, vp,
                         bt, (bm,), window, **scales)


def paged_entries(torch, P, kernels, kept, launches) -> list:
    """The direct tier's kernels on the inputs the main path gave them
    (round 2 of the direct engine). The library yardstick is
    scaled_dot_product_attention over K/V gathered beforehand (not
    timed) with the same mask; it returns a normalized output, where the
    kernels return partials."""
    entries = []
    a, kw = kept["paged_attend"]
    q, kp, vp, tables, kv_lens, kv_off, q_pos, window = a
    err = check_partials(torch, "paged_fwd", P.paged_attend(*a, **kw),
                         P.paged_attend_ref(*a),
                         {"dtype": dtype_name(q)})["max_abs_err"]
    nbytes, flops = paged_work(torch, q, kp, tables, kv_lens, kv_off, q_pos,
                               window)
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    entries.append({
        "name": "paged_fwd", "route": "cuda",
        "source": kernels.PAGED.source, "replaces": kernels.PAGED.replaces,
        "launches": launches["paged_fwd"], "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: P.paged_attend(*a, **kw)),
        "plain_ms": cuda_ms(torch, lambda: P.paged_attend_ref(*a)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, paged_library(
            torch, "paged_fwd", q[:, None], kp, vp, tables,
            (kv_lens, kv_off, q_pos), window)),
        "shape": {"q": list(q.shape), "pages": list(kp.shape),
                  "tables": list(tables.shape),
                  "kv_lens": kv_lens.tolist(), "dtype": dtype_name(q),
                  **split_grid(torch, P, q.shape[0], kp.shape[2],
                               tables.shape[1], kp.shape[1]),
                  "bytes": nbytes, "flops": flops}})

    a, kw = kept["paged_prefill_attend"]
    q, kp, vp, tables, kv_lens, window = a
    row = check_partials(torch, "paged_prefill_fwd",
                         P.paged_prefill_attend(*a),
                         P.paged_prefill_attend_ref(*a),
                         {"dtype": dtype_name(q)},
                         P.paged_prefill_attend_ref(q, kp, vp.abs(), tables,
                                                    kv_lens, window)[0])
    err = row["max_abs_err"]
    nbytes, flops = paged_prefill_work(torch, q, kp, tables, kv_lens, window)
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    entries.append({
        "name": "paged_prefill_fwd", "route": "cuda",
        "source": kernels.PAGED_PREFILL.source,
        "replaces": kernels.PAGED_PREFILL.replaces,
        "launches": launches["paged_prefill_fwd"], "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: P.paged_prefill_attend(*a)),
        "plain_ms": cuda_ms(torch, lambda: P.paged_prefill_attend_ref(*a)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, paged_library(
            torch, "paged_prefill_fwd", q, kp, vp, tables, (kv_lens,),
            window)),
        "bar_used": {f: row[f"bar_used_{f}"] for f in ("acc", "m", "l")},
        "shape": {"q": list(q.shape), "pages": list(kp.shape),
                  "tables": list(tables.shape),
                  "kv_lens": kv_lens.tolist(), "dtype": dtype_name(q),
                  "blocks": prefill_blocks(P, q, kp), "bytes": nbytes,
                  "flops": flops}})
    return entries


def ragged_entry(torch, P, kernel, kept: dict, launches: int) -> dict:
    """A ragged kernel (``ragged_fwd``, or ``ragged_q8_fwd`` whose kept
    inputs carry the scale pools) on its kept decode and chunk ticks. The
    decode tick is the one the main path launches most; the chunk tick's
    numbers ride beside it."""
    ticks = {key: ragged_tick_numbers(torch, P, kernel, *kept[key])
             for key in ("decode", "chunk")}
    return {"name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": launches,
            **ticks["decode"], "chunk": ticks["chunk"]}


def ragged_tick_numbers(torch, P, kernel, a, kw) -> dict:
    """One kept ragged tick: error against the twin (raises past the
    tolerance), the kernel's, the twin's and SDPA's device times, the
    bound from these inputs, and the tick's shape."""
    q, kp, vp, bt, bm, tq, window = a
    got = P.ragged_attend(*a, **kw)
    err = check(torch, kernel.name, got, P.ragged_attend_ref(*a, **kw),
                {"dtype": dtype_name(q), "tq": tq})["max_abs_err"]
    scaled = kw.get("k_scale") is not None
    nbytes, flops = ragged_work(torch, q, kp, bt, bm, tq, window,
                                scales=scaled)
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    return {
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: P.ragged_attend(*a, **kw)),
        "plain_ms": cuda_ms(torch, lambda: P.ragged_attend_ref(*a, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, ragged_library(torch, *a, **kw)),
        "shape": {"q": list(q.shape), "pages": list(kp.shape),
                  "page_dtype": dtype_name(kp),
                  "tables": list(bt.shape), "tq": tq,
                  "live_blocks": int((bm[:, 2] > 0).sum()),
                  "dtype": dtype_name(q), "bytes": nbytes,
                  "flops": flops,
                  **split_grid(torch, P, bt.shape[0], kp.shape[2],
                               bt.shape[1], kp.shape[1])}}


def flash_entry(torch, F, kernels, kept, launches: int) -> dict:
    """flash_fwd on kept inputs: error against the twin, device times,
    and the bound from these inputs."""
    a, kw = kept
    q, k, v, qp, kv_len = a
    window, off = kw.get("sliding_window"), kw.get("kv_pos_offset")
    got = F.flash_attend(*a, **kw)
    row = check(torch, "flash_fwd", got, F.flash_attend_ref(*a, **kw),
                {"dtype": dtype_name(q)},
                F.flash_attend_ref(q, k, v.abs(), qp, kv_len, **kw))
    err = row["max_abs_err"]
    nbytes, flops = flash_work(q, k, qp, kv_len, window, off)
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": kernels.FLASH.source, "replaces": kernels.FLASH.replaces,
        "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: F.flash_attend(*a, **kw)),
        "plain_ms": cuda_ms(torch, lambda: F.flash_attend_ref(*a, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, flash_library(torch, q, k, v, qp,
                                                   kv_len, window, off)),
        "bar_used": row["bar_used"],
        "shape": {"q": list(q.shape), "k": list(k.shape),
                  "dtype": dtype_name(q), "bytes": nbytes,
                  "flops": flops}}


def phase_mainpath(torch, F, P, kernels, kept, launches) -> list:
    """Each kernel on the inputs the main path gave it: error against the
    twin, device times, and the bound from these inputs."""
    entries = [flash_entry(torch, F, kernels, kept["flash_fwd"],
                           launches["flash_fwd"])]
    for kernel in (kernels.RAGGED, kernels.RAGGED_Q8):
        entries.append(ragged_entry(torch, P, kernel, kept[kernel.name],
                                    launches[kernel.name]))
    return entries + paged_entries(torch, P, kernels, kept, launches)


def busy_ms(events) -> float:
    """Union of the device intervals of the traced kernels, in ms."""
    busy, lo, hi = 0.0, None, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += 0.0 if hi is None else hi - lo
    return busy / 1e3                        # profiler times are in us


def traced(torch, label: str, fn) -> dict:
    """Run ``fn`` under torch.profiler: wall and device busy time, idle
    share, launch count, and the kernels that take the most device time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError(f"the profiler saw no device work in {label}")
    busy = busy_ms(events)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"call": label, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall, "kernel_launches": len(events),
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


def phase_trace(torch, R, backend, hist) -> dict:
    """Where the time of a resumed round and of a sessionless row goes,
    after the serve phase has paid every first-call cost."""
    eng = backend.engines[MODEL]
    calls = []
    for label, fn in (
            ("resumed consensus round", lambda: consensus_round(
                R, backend, MODEL, hist, TEMPS, TRACE_TOKENS)),
            ("sessionless long row", lambda: sessionless_row(
                R, backend, MODEL, TRACE_TOKENS, N_RULES))):
        row = traced(torch, label, fn)
        row.update(prefill_ms=eng.last_prefill_s * 1e3,
                   decode_ms=eng.last_decode_s * 1e3,
                   prefill_tokens=eng.last_prefill_tokens)
        calls.append(row)
    return {"phase": "trace", "model": MODEL, "calls": calls}


# -- the obs phase -------------------------------------------------------------

OBS_TRACE_DIR = os.path.join(REPO, "build", "obs_trace")
OBS_TIER_PROMPT = 600       # the demote and restore session's prompt
OBS_TIER_BYTES = 256 << 20  # its engine's session pool: 16 bf16 pages
# new tokens a member in the obs decide: the span tree needs rows, not
# answers that parse (at 256 the decide took 48.9 s in one H100 run with
# the loop's first calls and grammar tables)
OBS_DECIDE_TOKENS = 64


def obs_modules():
    from quoracle_tpu_torch.infra import (
        costobs, fleetobs, flightrec, introspect, resources, telemetry,
        treeobs,
    )
    return types.SimpleNamespace(tel=telemetry, co=costobs, tree=treeobs,
                                 intro=introspect, fleet=fleetobs,
                                 fr=flightrec, res=resources)


def obs_planes(O, on: bool, sink=None) -> None:
    """Every plane on (``sink`` and the span ring and flight recorder as
    tracer sinks; the cost, tree and introspect planes, the wall
    profiler) or off (no sink, the three planes disabled, the profiler
    stopped)."""
    for fn in list(O.tel.TRACER._sinks):
        O.tel.TRACER.remove_sink(fn)
    for mod in (O.co, O.tree, O.intro):
        (mod.enable if on else mod.disable)()
    if on:
        for fn in (sink, O.fleet.SPANS.record, O.fr.FLIGHT.record_span):
            O.tel.TRACER.add_sink(fn)
        O.intro.start()
    else:
        O.intro.shutdown()


def hist_delta(h, before) -> tuple:
    """(count, sum) a histogram gained since ``before`` = h.counts()."""
    _, s, n = h.counts()
    return n - before[2], s - before[1]


def obs_serve_run(torch, R, O, base, on: bool) -> dict:
    """The serve traffic (round 1, the sessionless row, the resumed round)
    on a fresh engine over ``base``'s weights, seed 0 (so the same
    generator state), planes on or off. Returns what must be identical,
    the timings and, when on, the spans, MFU readings and charges."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    eng = GenerateEngine(base.cfg, base.params, base.tokenizer, seed=0,
                         device="cuda")
    # the serve engine's grammar tables (same tokenizer and device): each
    # run pays no table build
    eng._json_cache = base._json_cache
    backend = R.TorchBackend([MODEL], device="cuda", engines={MODEL: eng})
    events, mfu = [], []
    orig = O.co.Roofline.observe

    def spy(self, stage, real_tokens, steps, ctx, wall_s, bucket):
        got = orig(self, stage, real_tokens, steps, ctx, wall_s, bucket)
        if got is not None:
            mfu.append({"stage": stage, "mfu": got["mfu"],
                        "hbm_bound": got["hbm_bound"],
                        "tokens": real_tokens, "ctx": ctx,
                        "wall_ms": wall_s * 1e3})
        return got

    step_h = O.tel.DECODE_STEP_MS.counts()
    led0 = O.co.ledger_for(eng.cfg.name).snapshot()
    obs_planes(O, on, events.append)
    O.co.Roofline.observe = spy
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rounds, results, _ = run_rounds(R, backend, MODEL, TEMPS,
                                        MAX_TOKENS, N_RULES)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        prof = O.intro.PROFILER.snapshot()
    finally:
        O.co.Roofline.observe = orig
        obs_planes(O, False)
    led1 = O.co.ledger_for(eng.cfg.name).snapshot()
    n_steps, step_ms = hist_delta(O.tel.DECODE_STEP_MS, step_h)
    flat = [r for res in results for r in res]
    out = {
        "same": {"texts": [[r.text for r in res] for res in results],
                 "tokens": [[r.usage.completion_tokens for r in res]
                            for res in results],
                 "cached": [[r.cached_tokens for r in res]
                            for res in results]},
        "wall_s": wall_s,
        "round2": {"prefill_ms": rounds[1]["prefill_ms"],
                   "decode_ms": rounds[1]["decode_ms"],
                   "ms_per_step": rounds[1]["decode_ms"] / max(
                       rounds[1]["new_tokens"])},
        "decode_step_ms_mean": step_ms / max(1, n_steps),
        "chip_ms": [r.chip_ms for r in flat],
        "charged_ms": sum(r.chip_ms for r in flat),
        "phase_walls_ms": sum(rd["prefill_ms"] + rd["decode_ms"]
                              for rd in rounds)
        + rounds[0]["sessionless"]["prefill_ms"]
        + rounds[0]["sessionless"]["decode_ms"],
        "ledger_busy_ms": led1["busy_chip_ms"] - led0["busy_chip_ms"],
        "ledger_overhead_ms": led1["overhead_chip_ms"]
        - led0["overhead_chip_ms"],
        "mfu": mfu, "events": events,
        "profiler": {k: prof[k] for k in ("hz", "running", "samples",
                                          "overhead_frac")}}
    del backend, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def span_counts(events) -> dict:
    out: dict = {}
    for e in events:
        out[e["name"]] = out.get(e["name"], 0) + 1
    return dict(sorted(out.items()))


def obs_decide(torch, R, O, pool_backend) -> dict:
    """One decide over the decide pool (DEPTH_CUT layers, full width)
    under the continuous loop, inside an ``agent.decide_tick`` span, the
    planes on: the span tree decide → round → member → the loop's spans,
    DECIDE_MS, ROUNDS_TOTAL and the audit record's task_id."""
    from quoracle_tpu_torch.consensus import engine as CE
    from quoracle_tpu_torch.consensus import quality as Q
    cpool = R.TorchBackend(DECIDE_POOL, device="cuda",
                           engines=pool_backend.engines,
                           embedder=pool_backend.embedder,
                           continuous=True, continuous_chunk=CONT_CHUNK,
                           qos=True)
    events = []
    d0 = O.tel.DECIDE_MS.counts()
    r0 = O.tel.ROUNDS_TOTAL.total()
    q0 = Q.QUALITY.scorecards()["n_decides"]
    messages = [{"role": "system", "content": wait_only_system_prompt()},
                {"role": "user", "content": "Task: keep the build green. "
                                            "Decide the next step."}]
    obs_planes(O, True, events.append)
    try:
        engine = CE.ConsensusEngine(cpool, CE.ConsensusConfig(
            model_pool=list(DECIDE_POOL), max_refinement_rounds=1,
            session_key="agent-obs", allowed_actions={"wait"},
            max_tokens=OBS_DECIDE_TOKENS))
        with O.tel.TRACER.span("agent.decide_tick", trace_id="task-obs",
                               agent_id="agent-obs"):
            out = engine.decide({m: list(messages) for m in DECIDE_POOL})
    finally:
        obs_planes(O, False)
        cpool.close()
    mine = [e for e in events if e.get("trace_id") == "task-obs"]
    by_id = {e["span_id"]: e for e in mine}

    def parent_name(e):
        p = by_id.get(e["parent_id"])
        return p["name"] if p is not None else None

    edges = sorted({(e["name"], parent_name(e)) for e in mine})
    n_dec, ms_dec = hist_delta(O.tel.DECIDE_MS, d0)
    report = {"status": out.status, "rounds_used": out.rounds_used,
              "task_id": out.audit["task_id"] if out.audit else None,
              "trace_spans": span_counts(mine),
              "all_spans": span_counts(events), "edges": edges,
              "decide_ms": ms_dec, "decides_observed": n_dec,
              "rounds_total": O.tel.ROUNDS_TOTAL.total() - r0,
              "quality_decides": Q.QUALITY.scorecards()["n_decides"] - q0,
              "chip_ms": out.chip_ms, "member_chip_ms": out.member_chip_ms}
    need = {("consensus.decide", "agent.decide_tick"),
            ("consensus.round", "consensus.decide"),
            ("backend.member", "consensus.round"),
            ("sched.queue_wait", "backend.member"),
            ("sched.decode", "backend.member")}
    if (report["task_id"] != "task-obs" or not need <= set(edges)
            or n_dec != 1 or report["rounds_total"] != out.rounds_used
            or report["quality_decides"] != 1):
        emit({"phase": "obs", "decide": report})
        raise AssertionError("the decide's span tree or counters are off")
    return report


def obs_tiers(torch, O, base) -> dict:
    """A demote and a restore on a small pool (a fresh engine over the
    serve weights, a host tier), planes on: the KV_* counters, the
    kv.restore span, the kv_demote and kv_restore records and the
    restore's charge; then one resumed round of 4 tokens inside a
    torch_trace_window writing under build/."""
    eng = tier_engine(base, base.params, session_max_bytes=OBS_TIER_BYTES)
    eng.attach_tier(host_mb=1024)
    name = eng.cfg.name
    prompt = tier_prompt(7, OBS_TIER_PROMPT, base.cfg.vocab_size)
    kinds = ("KV_DEMOTES_TOTAL", "KV_RESTORES_TOTAL",
             "KV_HOST_EVICTIONS_TOTAL")
    c0 = {k: getattr(O.tel, k).total() for k in kinds}
    r0 = O.tel.KV_RESTORE_MS.counts()
    restore0 = O.co.ledger_for(name).stage_ns().get("restore", 0)
    events = []
    O.fr.FLIGHT.record("obs_marker")
    obs_planes(O, True, events.append)
    try:
        g1 = eng.generate([prompt], temperature=0.0, max_new_tokens=8,
                          session_ids=["obs-a"])[0]
        hibernate_all(eng)
        g2 = eng.generate([prompt + g1.token_ids + prompt[:20]],
                          temperature=0.0, max_new_tokens=8,
                          session_ids=["obs-a"])[0]
        shutil.rmtree(OBS_TRACE_DIR, ignore_errors=True)
        with O.intro.torch_trace_window(OBS_TRACE_DIR) as armed:
            eng.generate([prompt + g1.token_ids + prompt[:40]],
                         temperature=0.0, max_new_tokens=4,
                         session_ids=["obs-a"])
            torch.cuda.synchronize()
    finally:
        obs_planes(O, False)
    files = (sorted(os.listdir(OBS_TRACE_DIR))
             if os.path.isdir(OBS_TRACE_DIR) else [])
    trace_bytes = sum(os.path.getsize(os.path.join(OBS_TRACE_DIR, f))
                      for f in files)
    shutil.rmtree(OBS_TRACE_DIR, ignore_errors=True)
    ev = O.fr.FLIGHT.snapshot()
    i = max(j for j, e in enumerate(ev) if e["kind"] == "obs_marker")
    flights = sorted({e["kind"] for e in ev[i + 1:]} - {"span"})
    report = {"counters": {k: getattr(O.tel, k).total() - c0[k]
                           for k in kinds},
              "restore_ms": hist_delta(O.tel.KV_RESTORE_MS, r0)[1],
              "restore_charge_ms": (O.co.ledger_for(name).stage_ns().get(
                  "restore", 0) - restore0) / 1e6,
              "cached_after_restore": g2.n_cached_tokens,
              "spans": span_counts(events), "flight_kinds": flights,
              "trace_window": {"armed": armed, "files": files,
                               "bytes": trace_bytes,
                               "dir": os.path.relpath(OBS_TRACE_DIR, REPO)},
              "tier": eng.sessions.tier.stats()["restored_sessions"]}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if (report["counters"]["KV_DEMOTES_TOTAL"] < 1
            or report["counters"]["KV_RESTORES_TOTAL"] < 1
            or "kv.restore" not in report["spans"]
            or not {"kv_demote", "kv_restore"} <= set(flights)
            or report["restore_charge_ms"] <= 0 or g2.n_cached_tokens <= 0
            or armed is not True or not files or trace_bytes <= 0):
        emit({"phase": "obs", "tiers": report})
        raise AssertionError("the tier part of the obs phase failed")
    return report


def attribution_view(O, backend) -> dict:
    att = O.res.hbm_attribution(backend)
    dev = att["device"]
    if (dev is None or not dev["consistent"]
            or any(v < 0 for v in dev["parts"].values()) or dev["other"] < 0
            or sum(dev["parts"].values()) + dev["other"]
            != dev["used_bytes"]):
        raise AssertionError(f"attribution does not add up: {dev}")
    return {"device": dev,
            "members": {m: {k: v[k] for k in ("role", "params_bytes",
                                              "kv_pool_bytes", "sessions")}
                        for m, v in att["members"].items()}}


def phase_obs(torch, R, backend, pool_backend) -> dict:
    """Observability on the serving path at llama-3-8b width and depth
    (the serve phase's bf16 weights): the serve traffic with every plane
    off, on and off again (identical texts, token and cached counts; the
    wall ms a decode step of each), every row's chip-ms and the MFU
    readings of the on run, the span tree of one decide of the pool, a
    demote and restore, a profiler window, the memory attribution and
    the exposition. No plane may fail to arm."""
    O = obs_modules()
    base = backend.engines[MODEL]
    runs = [obs_serve_run(torch, R, O, base, on)
            for on in (False, True, False)]
    same = [r["same"] for r in runs]
    on = runs[1]
    baton_spans = span_counts(on["events"])
    serve = {"identical": all(x == same[0] for x in same),
             "wall_s": [r["wall_s"] for r in runs],
             "round2_ms_per_step": [r["round2"]["ms_per_step"]
                                    for r in runs],
             "decode_step_ms_mean": [r["decode_step_ms_mean"]
                                     for r in runs],
             "round2": [r["round2"] for r in runs],
             "chip_ms": on["chip_ms"],
             "charged_ms": on["charged_ms"],
             "phase_walls_ms": on["phase_walls_ms"],
             "ledger_busy_ms": on["ledger_busy_ms"],
             "ledger_overhead_ms": on["ledger_overhead_ms"],
             "off_chip_ms": [sum(r["chip_ms"]) for r in (runs[0], runs[2])],
             "mfu": on["mfu"],
             "profiler": on["profiler"],
             "mfu_hbm_bound": {k: v for k, v in O.tel.MFU_HBM_BOUND.
                               _snapshot()["series"].items()
                               if f"model={base.cfg.name}," in k},
             "spans": baton_spans}
    mfu_ok = all(0.0 < m["mfu"] <= 1.0 for m in on["mfu"]) and {
        m["stage"] for m in on["mfu"]} >= {"prefill", "decode"}
    if (not serve["identical"] or min(on["chip_ms"]) <= 0
            or max(serve["off_chip_ms"]) != 0 or not mfu_ok
            or "generate.prefill" not in baton_spans
            or "backend.member" not in baton_spans):
        emit({"phase": "obs", "serve": {**serve, "same": same}})
        raise AssertionError("the obs serve runs failed their checks")
    decide = obs_decide(torch, R, O, pool_backend)
    tiers = obs_tiers(torch, O, base)
    text = O.tel.METRICS.render_prometheus()
    series = sum(1 for line in text.splitlines()
                 if line and not line.startswith("#"))
    return {"phase": "obs", "model": MODEL, "nvidia_smi": nvidia_smi(),
            "serve": serve, "decide": decide, "tiers": tiers,
            "attribution": {"serve": attribution_view(O, backend),
                            "pool": attribution_view(O, pool_backend)},
            "exposition": {"series": series,
                           "metrics": len(O.tel.METRICS._metrics)}}


# ---------------------------------------------------------------------------
# agent: the agent layer's decide loop on the card
# ---------------------------------------------------------------------------

AGENT_TASK = "task-agent"
AGENT_HISTORY_ROOM = 1500   # history tokens llama-3-8b's cut window leaves
                            # above the output floor (the condensing agent)
AGENT_SEED_ENTRIES = 14     # seeded user entries of the condensing agent
AGENT_HUNG_S = 600.0        # declares a tick hung; never decides a result
# new tokens of the condensing tick's reflection queries (the reflector's
# own budget is 1,024): with random weights they never parse, so the
# reflector runs three of them to the budget; at 1,024 they took 54.5 s
# of the agent phase on the H100. Cut for the runtime phase
AGENT_REFLECTION_TOKENS = 128


def agent_modules():
    from quoracle_tpu_torch.actions.schema import ACTIONS
    from quoracle_tpu_torch.agent import (
        AgentConfig, AgentDeps, AgentRegistry, AgentSupervisor,
    )
    from quoracle_tpu_torch.consensus.engine import ConsensusOutcome
    from quoracle_tpu_torch.consensus.result import Decision
    from quoracle_tpu_torch.context.history import (
        SUMMARY, USER, AgentContext, HistoryEntry,
    )
    from quoracle_tpu_torch.context import reflector
    from quoracle_tpu_torch.context.token_manager import TokenManager
    from quoracle_tpu_torch.infra import telemetry, treeobs
    from quoracle_tpu_torch.infra.budget import Escrow
    from quoracle_tpu_torch.infra.bus import AgentEvents, EventBus
    from quoracle_tpu_torch.infra.costs import CostRecorder
    from quoracle_tpu_torch.models.config import OUTPUT_FLOOR
    from decimal import Decimal
    return types.SimpleNamespace(**{k: v for k, v in locals().items()})


class AgentWatch:
    """What an agent phase observes, through the port's own seams: each
    ``backend.query`` call (its session, each member's cached tokens,
    prefill and decode ms, the call's ms), each ``backend.embed`` call's
    ms, the bus's events and the tracer's spans. The supervisor it
    returns wraps every agent it starts (children too): the consensus
    budget is set to DECIDE_MAX_TOKENS (random-weight members rarely
    close their JSON early), each decide's outcome is kept (a scripted
    one is returned instead when the phase queued one for that agent),
    and each handled mailbox message wakes the phase's loop."""

    def __init__(self, A, backends: list, bus):
        self.A = A
        self.calls: list = []
        self.embed_ms: list = []
        self.events: list = []
        self.spans: list = []
        self.outcomes: dict = {}
        self.scripts: dict = {}
        self.busy: dict = {}
        self.configured: dict = {}      # agent id -> forbidden as spawned
        self.wake = None
        self.loop = None
        self.backends = backends
        for b in backends:
            self._spy(b)
        bus.subscribe("*", self._on_event)
        A.telemetry.TRACER.add_sink(self.spans.append)

    def _spy(self, b) -> None:
        query, embed = b.query, b.embed

        def timed_query(requests):
            t0 = time.monotonic()
            res = query(requests)
            self.calls.append({
                "session": requests[0].session_id if requests else None,
                "ms": (time.monotonic() - t0) * 1e3,
                "members": {r.model_spec: {
                    "prompt": r.usage.prompt_tokens,
                    "completion": r.usage.completion_tokens,
                    "cached": r.cached_tokens, "prefill_ms": r.prefill_ms,
                    "decode_ms": r.decode_ms, "ok": r.ok}
                    for r in res}})
            return res

        def timed_embed(texts):
            t0 = time.monotonic()
            try:
                return embed(texts)
            finally:
                self.embed_ms.append((time.monotonic() - t0) * 1e3)
        b.query, b.embed = timed_query, timed_embed

    def _on_event(self, topic, event) -> None:
        self.events.append((topic, event))
        self._poke()

    def _poke(self) -> None:
        if self.wake is not None:
            self.loop.call_soon_threadsafe(self.wake.set)

    def close(self) -> None:
        for b in self.backends:
            del b.query, b.embed
        self.A.telemetry.TRACER.remove_sink(self.spans.append)

    def supervisor(self, deps, forbidden: Optional[tuple] = None):
        """An AgentSupervisor of ``deps`` (it becomes ``deps.supervisor``)
        that instruments every agent it starts; with ``forbidden``, each
        one (created, restored or revived) gets those forbidden
        actions first."""
        watch, A = self, self.A

        class Supervisor(A.AgentSupervisor):
            async def start_agent(self, config):
                watch.configured[config.agent_id] = tuple(
                    config.forbidden_actions)
                if forbidden is not None:
                    config.forbidden_actions = forbidden
                core = await super().start_agent(config)
                watch.instrument(core)
                return core
        return Supervisor(deps)

    def instrument(self, core) -> None:
        aid = core.agent_id
        core.engine.config.max_tokens = DECIDE_MAX_TOKENS
        decide = core.engine.decide

        def kept_decide(messages):
            queued = self.scripts.get(aid)
            out = queued.pop(0) if queued else decide(messages)
            self.outcomes.setdefault(aid, []).append(out)
            return out
        core.engine.decide = kept_decide
        dispatch = core._dispatch

        async def woken_dispatch(msg):
            self.busy[aid] = self.busy.get(aid, 0) + 1
            try:
                await dispatch(msg)
            finally:
                self.busy[aid] -= 1
                self._poke()
        core._dispatch = woken_dispatch

    def idle(self, core) -> bool:
        return (not core.pending_actions and not core.consensus_scheduled
                and not self.busy.get(core.agent_id) and core.mailbox.empty())

    async def until(self, cond) -> None:
        self.loop = asyncio.get_running_loop()
        if self.wake is None:
            self.wake = asyncio.Event()
        deadline = self.loop.time() + AGENT_HUNG_S
        while not cond():
            self.wake.clear()
            if cond():
                return
            left = deadline - self.loop.time()
            if left <= 0:
                raise AssertionError("an agent tick hung")
            try:
                await asyncio.wait_for(self.wake.wait(), left)
            except asyncio.TimeoutError:
                pass

    def mark(self) -> tuple:
        """Where the watch's records stand (calls, spans, embeds,
        events), for a tick that starts before its agent exists."""
        return (len(self.calls), len(self.spans), len(self.embed_ms),
                len(self.events), time.monotonic())

    async def tick(self, core, msg: Optional[dict],
                   since: Optional[tuple] = None) -> dict:
        """Post ``msg`` (None: the caller already posted the message the
        agent has not handled yet, as ``TaskManager.create_task`` does)
        and wait for the agent to execute a decision and go idle. Returns
        the tick's record: the decide spans, the backend calls and the
        decision. ``since`` (a ``mark()`` taken before the agent was
        created, as over HTTP, where its first tick may end before the
        caller holds the agent) counts the tick from that moment."""
        pool = core.config.model_pool

        def n_results():
            return [sum(1 for e in core.ctx.history(m) if e.kind == "result")
                    for m in pool]
        if since is None:
            since = self.mark()
            mark = since[:4] + (len(self.outcomes.get(core.agent_id, [])),)
            before = n_results()
        else:
            mark, before = since[:4] + (0,), [0] * len(pool)
        t0 = since[4]
        if msg is not None:
            core.post(msg)
        await self.until(lambda: all(a > b for a, b in zip(
            n_results(), before)) and self.idle(core))
        wall_ms = (time.monotonic() - t0) * 1e3
        mine = [s for s in self.spans[mark[1]:]
                if s.get("agent_id") == core.agent_id]
        ticks = [s for s in mine if s["name"] == "agent.decide_tick"]
        tick_ids = {s["span_id"] for s in ticks}
        decides = [s for s in self.spans[mark[1]:]
                   if s["name"] == "consensus.decide"
                   and s["parent_id"] in tick_ids]
        outs = self.outcomes.get(core.agent_id, [])[mark[4]:]
        calls = [c for c in self.calls[mark[0]:]
                 if c["session"] in (core.agent_id, None)]
        events = self.events[mark[3]:]
        last = {m: [e.kind for e in core.ctx.history(m)][-2:] for m in pool}
        return {
            "agent": core.agent_id, "wall_ms": wall_ms, "posted": msg,
            "tick_spans": [{"trace_id": s["trace_id"],
                            "ms": s["duration_ms"]} for s in ticks],
            "decide_spans": len(decides),
            "outcomes": [{"status": o.status, "rounds": o.rounds_used,
                          "scripted": o.decide_id is None and not o.audit,
                          "task_id": (o.audit or {}).get("task_id"),
                          "cached_tokens": o.cached_tokens,
                          "prefill_ms": o.prefill_ms,
                          "decode_ms": o.decode_ms,
                          "decision": None if o.decision is None else
                          {"action": o.decision.action,
                           "params": o.decision.params}}
                         for o in outs],
            "calls": calls,
            "serving_rounds": sum(1 for t, e in events
                                  if e["event"] == "serving_round"),
            "queries": sum(1 for c in self.calls[mark[0]:]),
            "embed_ms": self.embed_ms[mark[2]:],
            "events": sorted({e["event"] for t, e in events
                              if e.get("agent_id") == core.agent_id}),
            "history_tail": last}


def agent_tick_ok(rec: dict, task: str) -> bool:
    """A model-decided tick: every cycle opened one agent.decide_tick
    span traced to the task with one consensus.decide under it, the last
    decide ended "ok" with its audit under the task, and every member's
    history gained a DECISION and its RESULT."""
    outs = rec["outcomes"]
    return (outs and outs[-1]["status"] == "ok"
            and len(rec["tick_spans"]) == len(outs) == rec["decide_spans"]
            and all(s["trace_id"] == task for s in rec["tick_spans"])
            and all(o["task_id"] == task for o in outs)
            and all(t == ["decision", "result"]
                    for t in rec["history_tail"].values())
            and {"action_started", "action_completed"} <= set(rec["events"]))


def scripted_outcome(A, action: str, params: dict):
    """A decide the phase scripts for the root (the spawn and the
    dismissal; random-weight members cannot write their params)."""
    return A.ConsensusOutcome(status="ok", decision=A.Decision(
        kind="consensus", action=action, params=params, wait=True,
        confidence=1.0, cluster_size=1, total_responses=1, rounds_used=1,
        reasoning="scripted by chip_smoke"))


def pages_view(backend) -> dict:
    return {spec: {"free": e.sessions.free_pages(),
                   "cached": e.sessions.prefix_cache.stats()["cached_pages"],
                   "sessions": len(e.sessions)}
            for spec, e in backend.engines.items()}


def condense_context(A, backend, pool: list):
    """AGENT_SEED_ENTRIES distinct user entries (a long status log) for
    every member: about 1,800 tokens of history under llama-3-8b's
    tokenizer, past the cut window's AGENT_HISTORY_ROOM."""
    ctx = A.AgentContext()
    for k in range(AGENT_SEED_ENTRIES):
        text = (f"Status report {k}: build {1000 + 37 * k} finished; "
                + " ".join(f"module-{k}-{i} passed {3 * i + k} checks in "
                           f"{11 * i + k} ms;" for i in range(8)))
        ctx.append_all(A.HistoryEntry(kind=A.USER, content=text), pool)
    return ctx


def agent_backend(R, base_backend, pool: list, overlap: bool = True):
    """A TorchBackend over engines of its own that share ``base_backend``'s
    weights (no copy), embedder and grammar tables, seeded as its engines
    were: the agent phase samples and fills prefix caches, and the phases
    after it must find the base engines as they left them (over the
    decide pool's own engines, the spec phase's sampled decide drew
    other tokens on the H100 and ended all_invalid). ``overlap`` as
    TorchBackend's."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    engines = {}
    for spec in pool:
        base = base_backend.engines[spec]
        engines[spec] = GenerateEngine(
            base.cfg, base.params, base.tokenizer,
            seed=base._generator.initial_seed(), device=base.device)
        engines[spec]._json_cache = base._json_cache
    return R.TorchBackend(pool, device=base_backend.device, engines=engines,
                          embedder=base_backend.embedder, overlap=overlap)


def phase_agent(torch, R, kernels, serve_backend, decide_backend) -> dict:
    """The agent layer on the card: AgentCore's decide loop through the
    supervisor, the action router and the bus, over the decide pool
    (llama-3-8b, mistral-7b, gemma-7b at full width, DEPTH_CUT layers)
    and, for one tick, over the serve phase's llama-3-8b at full depth,
    each on engines of the phase's own over those weights
    (``agent_backend``).
    Allowed actions {"wait"} (build_system_prompt's prompt for that set).
    A root agent runs two ticks (the second resumes), a second root
    condenses a seeded history under a cut llama window (the reflector's
    query on the card, flash from its sessionless prefill), the first
    root spawns a child (its decision scripted) whose tick is the
    model's, then dismisses it (scripted), and one agent ticks at full
    depth. Every tick must execute its decision; the spans, the bus's
    serving rounds, the tree registry, the escrow, the child's pages and
    the kernels' launches are checked."""
    A = agent_modules()
    t_phase = time.monotonic()
    pool_backend = agent_backend(R, decide_backend, DECIDE_POOL)
    backend = agent_backend(R, serve_backend, [MODEL])
    # the obs phase leaves the tree plane off; this phase reads it
    tree_was_on = A.treeobs.enabled()
    A.treeobs.reset()
    A.treeobs.enable()
    # the members' grammar tables for {"wait"}, as the decide phase
    # builds them (a hit after it): built at first use on the members'
    # threads they cost tick 1 ~40 s on the H100 (--only agent)
    t0 = time.monotonic()
    for b, pool in ((pool_backend, DECIDE_POOL), (backend, [MODEL])):
        for spec in pool:
            b.engines[spec]._json_table_device((("wait",),))
    grammar_s = time.monotonic() - t0
    bus = A.EventBus()
    events = A.AgentEvents(bus)
    registry, escrow = A.AgentRegistry(), A.Escrow()
    costs = A.CostRecorder(escrow=escrow, events=events)
    forbidden = tuple(a for a in A.ACTIONS if a != "wait")
    for b in (pool_backend, backend):
        b.attach_bus(bus)
    watch = AgentWatch(A, [pool_backend, backend], bus)

    def deps_for(b, limit_fn=None):
        return A.AgentDeps(
            backend=b, registry=registry, supervisor=None, events=events,
            escrow=escrow, costs=costs, token_manager=A.TokenManager(
                b.count_tokens,
                context_limit_fn=limit_fn or b.context_window))

    cut_window = A.OUTPUT_FLOOR + AGENT_HISTORY_ROOM

    def cut_llama(spec):
        return cut_window if spec == MODEL else \
            pool_backend.context_window(spec)

    report = {"phase": "agent", "pool": DECIDE_POOL,
              "depth": DEPTH_CUT, "max_tokens": DECIDE_MAX_TOKENS,
              "grammar_prebuild_s": grammar_s}

    marks = {}

    def mark(name):
        marks[name] = kernels.launch_counts()

    async def main():
        deps = deps_for(pool_backend)
        sup = watch.supervisor(deps)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        mark("start")
        root = await sup.start_agent(A.AgentConfig(
            agent_id="agent-root", task_id=AGENT_TASK,
            model_pool=list(DECIDE_POOL), forbidden_actions=forbidden,
            budget_mode="root", budget_limit="100"))
        ticks = []
        for text in ("Task: keep the build green. Decide the next step.",
                     "The build is still green. Decide the next step."):
            ticks.append(await watch.tick(root, {
                "type": "user_message", "from": "user", "content": text}))
        mark("root")
        report["root_ticks"] = ticks

        # condensation: a second root, its llama window cut
        cdeps = deps_for(pool_backend, cut_llama)
        csup = watch.supervisor(cdeps)
        ccore = await csup.start_agent(A.AgentConfig(
            agent_id="agent-condense", task_id="task-condense",
            model_pool=list(DECIDE_POOL), forbidden_actions=forbidden,
            restored_context=condense_context(A, pool_backend,
                                              DECIDE_POOL)))
        tm = cdeps.token_manager
        before = tm.history_tokens(MODEL, ccore.ctx.history(MODEL))
        budget = A.reflector.REFLECTION_MAX_OUTPUT_TOKENS
        A.reflector.REFLECTION_MAX_OUTPUT_TOKENS = AGENT_REFLECTION_TOKENS
        try:
            crec = await watch.tick(ccore, {
                "type": "user_message", "from": "user",
                "content": "Summarize where the build stands, then "
                           "decide."})
        finally:
            A.reflector.REFLECTION_MAX_OUTPUT_TOKENS = budget
        hist = ccore.ctx.history(MODEL)
        after = tm.history_tokens(MODEL, hist)
        reflect = [c for c in crec["calls"] if c["session"] is None]
        report["condense"] = {
            "window": cut_window, "history_tokens": [before, after],
            "summary_head": hist[0].kind == A.SUMMARY,
            "fits": tm.dynamic_max_tokens(
                MODEL, after, pool_backend.output_limit(MODEL)) is not None,
            "reflect_queries": len(reflect),
            "reflect_ms": sum(c["ms"] for c in reflect),
            "reflect_tokens": AGENT_REFLECTION_TOKENS,
            "embed_ms": crec["embed_ms"], "lessons": len(
                ccore.ctx.context_lessons.get(MODEL, [])),
            "tick": crec}
        mark("condense")
        await csup.terminate_agent("agent-condense")

        # a child: spawned and dismissed by scripted root decisions
        pages0 = pages_view(pool_backend)
        root_spent0 = escrow.get("agent-root").spent
        watch.scripts["agent-root"] = [scripted_outcome(
            A, "spawn_child", {
                "task_description": "Keep the build green: decide your "
                                    "next step.",
                "success_criteria": "a decision executed",
                "immediate_context": "you were just spawned",
                "approach_guidance": "wait for events", "profile": "worker",
                "budget": "1"})]
        spawn = await watch.tick(root, {
            "type": "user_message", "from": "user",
            "content": "Spawn a worker."})
        spawn_result = str(root.ctx.history(MODEL)[-1].content)[:200]
        await watch.until(lambda: len(registry) >= 2 and root.children)
        child_id = root.children[0]["agent_id"]
        child = registry.lookup(child_id).core
        await watch.until(lambda: any(
            e.kind == "result" for e in child.ctx.history(MODEL))
            and watch.idle(child))
        cticks = [s for s in watch.spans
                  if s["name"] == "agent.decide_tick"
                  and s.get("agent_id") == child_id]
        couts = watch.outcomes.get(child_id, [])
        tree = A.treeobs.tree_payload(AGENT_TASK)
        child_cost = costs.total_for(child_id)
        mark("child")
        watch.scripts["agent-root"] = [scripted_outcome(
            A, "dismiss_child", {"child_id": child_id})]
        dismiss = await watch.tick(root, {
            "type": "user_message", "from": "user",
            "content": "The worker is done: dismiss it."})
        pages1 = pages_view(pool_backend)
        root_b = escrow.get("agent-root")
        report["child"] = {
            "spawn_result": spawn_result,
            "ticks": len(cticks), "tick_ms": [s["duration_ms"]
                                              for s in cticks],
            "outcomes": [{"status": o.status, "rounds": o.rounds_used,
                          "task_id": (o.audit or {}).get("task_id")}
                         for o in couts],
            "priority": child.engine.config.priority,
            "root_priority": root.engine.config.priority,
            "calls": [c for c in watch.calls if c["session"] == child_id],
            "tree": {n["node_id"]: [n["parent_id"], n["depth"]]
                     for n in tree.get("nodes", [])},
            "registered": [r.agent_id for r in registry.all()],
            "child_cost": str(child_cost),
            "escrow": root_b.snapshot(),
            "root_spent": [str(root_spent0), str(root_b.spent)],
            "conserved": (root_b.committed == 0
                          and root_b.spent == root_spent0
                          + min(A.Decimal("1"), child_cost)
                          and root_b.available
                          == root_b.limit - root_b.spent),
            "pages": [pages0, pages1],
            "dismiss": str(root.ctx.history(MODEL)[-1].content)[:200]}
        report["spawn_tick"], report["dismiss_tick"] = spawn, dismiss
        mark("dismiss")

        # one tick at full depth over the serve phase's backend
        fdeps = deps_for(backend)
        fsup = watch.supervisor(fdeps)
        fcore = await fsup.start_agent(A.AgentConfig(
            agent_id="agent-full", task_id="task-full",
            model_pool=[MODEL], forbidden_actions=forbidden))
        report["full_depth"] = await watch.tick(fcore, {
            "type": "user_message", "from": "user",
            "content": "Task: keep the build green. Decide the next step."})
        torch.cuda.synchronize()
        mark("full")
        await fsup.terminate_agent("agent-full")
        await sup.terminate_tree("agent-root", by="chip_smoke")
        report["costs"] = {a: str(costs.total_for(a)) for a in (
            "agent-root", child_id, "agent-condense", "agent-full")}
        return child_id

    try:
        child_id = asyncio.run(main())
    finally:
        watch.close()
        if not tree_was_on:
            A.treeobs.disable()
    report["seconds"] = time.monotonic() - t_phase
    order = ["start", "root", "condense", "child", "dismiss", "full"]
    report["section_launches"] = {
        b: {k: marks[b][k] - marks[a][k] for k in marks[b]}
        for a, b in zip(order, order[1:])}
    report["launches"] = marks["full"]
    root_l = report["section_launches"]["root"]
    report["nvidia_smi"] = nvidia_smi()
    ticks = report["root_ticks"]
    tick2 = ticks[1]["calls"][0]["members"] if ticks[1]["calls"] else {}
    child = report["child"]
    pages_ok = all(
        p1["free"] + p1["cached"] == p0["free"] + p0["cached"]
        for p0, p1 in zip(child["pages"][0].values(),
                          child["pages"][1].values()))
    checks = {
        "root_ticks": all(agent_tick_ok(t, AGENT_TASK) for t in ticks),
        "resumed": all(tick2.get(m, {}).get("cached", 0) > 0
                       for m in (MODEL, DECIDE_POOL[-1])),
        "serving_rounds": all(t["serving_rounds"] == t["queries"] >= 1
                              for t in ticks),
        "lifecycle": {"agent_spawned", "action_started",
                      "action_completed"} <= {e["event"] for _, e in
                                              watch.events},
        "root_kernels": (root_l["ragged_fwd"] > 0 and all(
            root_l[k] == 0 for k in
            ("paged_fwd", "paged_prefill_fwd", "ragged_q8_fwd"))),
        "condensed": (report["condense"]["summary_head"]
                      and report["condense"]["fits"]
                      and report["condense"]["reflect_queries"] >= 1
                      and agent_tick_ok(report["condense"]["tick"],
                                        "task-condense")),
        "condense_flash":
            report["section_launches"]["condense"]["flash_fwd"] > 0,
        "child": (child["ticks"] >= 1 and child["outcomes"]
                  and child["outcomes"][-1]["status"] == "ok"
                  and child["outcomes"][-1]["task_id"] == AGENT_TASK
                  and child["tree"] == {"agent-root": [None, 0],
                                        child_id: ["agent-root", 1]}
                  and child["priority"] > child["root_priority"]),
        "scripted_executed": all(
            t["outcomes"] and t["outcomes"][-1]["status"] == "ok"
            and all(h == ["decision", "result"]
                    for h in t["history_tail"].values())
            for t in (report["spawn_tick"], report["dismiss_tick"])),
        "dismissed": (child_id not in child["registered"]
                      and all(pool_backend.engines[s].sessions.get(child_id)
                              is None for s in DECIDE_POOL)),
        "pages_back": pages_ok, "escrow": child["conserved"],
        "full_depth": agent_tick_ok(report["full_depth"], "task-full"),
    }
    report["checks"] = checks
    del pool_backend, backend, watch
    torch.cuda.empty_cache()
    if not all(checks.values()):
        emit(report)
        raise AssertionError(f"the agent phase failed its checks: "
                             f"{[k for k, v in checks.items() if not v]}")
    return report


# the runtime phase's three messages: the task's description, then the
# user's message to the restored agent and to the revived one. With
# "The build is green again. Decide the next step." the revived tick's
# first decide ended all_invalid (36.5 of its 43.1 s on the H100); with
# this one all three ticks were "ok" in one round
RUNTIME_MESSAGES = ("Task: keep the build green. Decide the next step.",
                    "The build is still green. Decide the next step.",
                    "Decide the next step.")


def json_entries(core, pool: list) -> dict:
    """Each member's history, entry for entry, as JSON (what the
    database holds: kind, content, ts, action_type)."""
    return {m: [json.dumps([e.kind, e.content, e.ts, e.action_type],
                           sort_keys=True, default=str)
                for e in core.ctx.history(m)] for m in pool}


def decode_steps(tick: dict) -> dict:
    """Each member's decode in one tick: the agent's query calls, the
    tokens decoded (one step each), their decode ms and ms a step."""
    out = {}
    for c in tick["calls"]:
        if c["session"] != tick["agent"]:
            continue
        for m, st in c["members"].items():
            d = out.setdefault(m, {"calls": 0, "steps": 0, "decode_ms": 0.0})
            d["calls"] += 1
            d["steps"] += st["completion"]
            d["decode_ms"] += st["decode_ms"]
    for d in out.values():
        d["ms_per_step"] = d["decode_ms"] / d["steps"] if d["steps"] else None
    return out


def phase_runtime(torch, R, kernels, decide_backend) -> dict:
    """The runtime and what it wires (runtime.py's Runtime over
    persistence/, the world actions' seams, EventHistory and the
    StallWatchdog) on the card, over the decide pool (llama-3-8b,
    mistral-7b, gemma-7b at full width, DEPTH_CUT layers) on engines of
    the phase's own over its weights (``agent_backend``), allowed actions
    {"wait"}, DECIDE_MAX_TOKENS a member. The database is a file in a
    temporary directory outside the checkout (removed after), its vault
    keyed. Runtime A creates a task (TaskManager.create_task: the row,
    the root agent, its first message); its first tick must end "ok"
    with a DECISION and its RESULT; then pause_task: the agent stops, its
    KV sessions are dropped, every member's free + cached pages are as
    before the task, the row reads "paused". Runtime B, a new stack over
    the same file and backend, restore_task's the tree: every member's
    history equal, entry for entry, to A's at the pause; a user message
    gives a second tick ("ok"; its prefill and cached tokens and wall ms
    reported). The task, left "running" (its agents stopped without a
    status change: a crash), is revived by runtime C's boot() and decides
    once more. Each tick's decode steps and ms a step are reported a
    member. The costs persisted for the task equal the escrow's spent;
    EventHistory holds the task's lifecycle and action events; the
    StallWatchdog has the backend's sources (none under the baton
    batcher) and no trip. ragged_fwd must have launched and the paged and
    int8 kernels not (flash_fwd counted). Last,
    Runtime(RuntimeConfig(backend="torch", continuous=True,
    model_pool=["xla:tiny", <tiny at head dim 128>])) builds its own
    TorchBackend, whose engines must sit on cuda (the entry point's
    device default); its watchdog holds the continuous loops' sources,
    one of which a query advances with no trip; closed at once."""
    import importlib.util
    from quoracle_tpu_torch import runtime as RT
    A = agent_modules()
    t_phase = time.monotonic()
    # members in turn, as in the web phase (the agent phase keeps the
    # default, overlap on)
    pool_backend = agent_backend(R, decide_backend, DECIDE_POOL,
                                 overlap=False)
    t0 = time.monotonic()
    for spec in DECIDE_POOL:
        pool_backend.engines[spec]._json_table_device((("wait",),))
    grammar_s = time.monotonic() - t0
    forbidden = tuple(a for a in A.ACTIONS if a != "wait")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-runtime-")
    config = RT.RuntimeConfig(db_path=os.path.join(tmp, "runtime.db"),
                              encryption_key="chip-smoke-runtime",
                              backend="torch")
    report = {"phase": "runtime", "pool": DECIDE_POOL, "depth": DEPTH_CUT,
              "max_tokens": DECIDE_MAX_TOKENS, "overlap": False,
              "grammar_prebuild_s": grammar_s,
              "cryptography": importlib.util.find_spec("cryptography")
              is not None}
    watchdogs = []

    def stack():
        rt = RT.Runtime(config, backend=pool_backend)
        watch = AgentWatch(A, [pool_backend], rt.bus)
        # TaskManager starts agents through deps.supervisor
        rt.supervisor = watch.supervisor(rt.deps, forbidden)
        return rt, watch

    def close(rt, watch):
        watchdogs.append({"status": rt.watchdog.status(),
                          "backend_sources": sorted(
                              n for n, _ in pool_backend.watchdog_sources())})
        watch.close()
        rt.close()

    async def main():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        pages0 = pages_view(pool_backend)
        # A: create, the first tick, pause
        rt, watch = stack()
        report["vault_active"] = rt.db.vault.active
        t0 = time.monotonic()
        task_id, root = await rt.tasks.create_task(
            RUNTIME_MESSAGES[0], model_pool=list(DECIDE_POOL))
        report["create_ms"] = (time.monotonic() - t0) * 1e3
        tick1 = await watch.tick(root, None)
        t0 = time.monotonic()
        stopped = await rt.tasks.pause_task(task_id)
        report["pause"] = {
            "ms": (time.monotonic() - t0) * 1e3, "stopped": stopped,
            "row": rt.store.get_task(task_id)["status"],
            "sessions_dropped": all(
                e.sessions.get(root.agent_id) is None
                for e in pool_backend.engines.values()),
            "pages": [pages0, pages_view(pool_backend)]}
        at_pause = json_entries(root, DECIDE_POOL)
        report["history_a"] = {
            "lifecycle": [(e["event"], e.get("status"))
                          for e in rt.history.replay_lifecycle()],
            "actions": [(e["event"], e.get("action"))
                        for e in rt.history.replay_actions()
                        if e.get("agent_id") == root.agent_id],
            "traces": len(rt.history.replay_traces(task_id))}
        close(rt, watch)

        # B: a new stack over the same file and backend
        rt, watch = stack()
        t0 = time.monotonic()
        restored_n = await rt.tasks.restore_task(task_id)
        report["restore_ms"] = (time.monotonic() - t0) * 1e3
        core = rt.registry.lookup(root.agent_id).core
        report["restored"] = {
            "agents": restored_n,
            "equal": json_entries(core, DECIDE_POOL) == at_pause,
            "entries": {m: len(v) for m, v in at_pause.items()}}
        tick2 = await watch.tick(core, {
            "type": "user_message", "from": "user",
            "content": RUNTIME_MESSAGES[1]})
        calls = [c for c in tick2["calls"] if c["session"] == core.agent_id]
        report["restored_tick"] = {
            "wall_ms": tick2["wall_ms"],
            "members": {m: {"prefill": st["prompt"] - st["cached"],
                            "cached": st["cached"]}
                        for m, st in calls[0]["members"].items()}
            if calls else {}}
        await rt.supervisor.stop_all(task_id)     # a crash: still running
        report["left_running"] = rt.store.get_task(task_id)["status"]
        close(rt, watch)

        # C: boot revival
        rt, watch = stack()
        revival = await rt.boot()
        core = rt.registry.lookup(root.agent_id).core
        tick3 = await watch.tick(core, {
            "type": "user_message", "from": "user",
            "content": RUNTIME_MESSAGES[2]})
        torch.cuda.synchronize()
        report["launches"] = kernels.launch_counts()
        report["revival"] = {"revived": [t == task_id
                                         for t in revival["revived"]],
                             "failed": revival["failed"]}
        report["costs"] = {
            "persisted": str(rt.store.costs_for_task(task_id)),
            "escrow_spent": str(rt.escrow.get(root.agent_id).spent)}
        await rt.tasks.pause_task(task_id)
        report["status"] = rt.status()
        close(rt, watch)
        report["ticks"] = [tick1, tick2, tick3]
        report["decode"] = [decode_steps(t) for t in report["ticks"]]
        return task_id

    try:
        task_id = asyncio.run(main())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the entry point's device default: its own backend, on the card.
    # The pool's baton batcher has no decode loop, so the watchdogs
    # above have no source to watch; this backend runs the continuous
    # loop, whose sources the watchdog holds, and one query of tiny at
    # the kernels' head dim 128 (tiny's own 16 is below it) must
    # advance its source without a trip
    from quoracle_tpu_torch.models import config as C
    tiny128 = "xla:" + C.register_model(dataclasses.replace(
        C.get_model_config("xla:tiny"), name="tiny-hd128", dim=256,
        n_heads=2, n_kv_heads=1, head_dim=128)).name
    rt = RT.Runtime(RT.RuntimeConfig(backend="torch", continuous=True,
                                     model_pool=["xla:tiny", tiny128]))
    report["device_default"] = {spec: e.device.type
                                for spec, e in rt.backend.engines.items()}
    progress = dict(rt.backend.watchdog_sources())[f"decode-loop:{tiny128}"]
    p0 = progress()
    res = rt.backend.query([R.QueryRequest(
        tiny128, [{"role": "user", "content": RUNTIME_MESSAGES[2]}],
        temperature=0.0, max_tokens=16)])
    report["loop_watchdog"] = {
        "ok": res[0].ok, "error": res[0].error,
        "progress": [p0, progress()],
        "scan_tripped": rt.watchdog.check_now(),
        "status": rt.watchdog.status()}
    rt.close()
    rt.backend.close()
    del rt
    report["seconds"] = time.monotonic() - t_phase
    report["nvidia_smi"] = nvidia_smi()
    report["watchdogs"] = watchdogs
    pause, launches = report["pause"], report["launches"]
    checks = {
        "tick1": agent_tick_ok(report["ticks"][0], task_id),
        "paused": (pause["stopped"] == 1 and pause["row"] == "paused"
                   and pause["sessions_dropped"]),
        "pages_back": all(
            p1["free"] + p1["cached"] == p0["free"] + p0["cached"]
            for p0, p1 in zip(pause["pages"][0].values(),
                              pause["pages"][1].values())),
        "restored": (report["restored"]["agents"] == 1
                     and report["restored"]["equal"]),
        "tick2": agent_tick_ok(report["ticks"][1], task_id),
        "left_running": report["left_running"] == "running",
        "revived": report["revival"] == {"revived": [True], "failed": []},
        "tick3": agent_tick_ok(report["ticks"][2], task_id),
        "costs": (report["costs"]["persisted"]
                  == report["costs"]["escrow_spent"]
                  and A.Decimal(report["costs"]["persisted"]) > 0),
        "event_history": (
            {("agent_spawned", None), ("task_status_changed", "running"),
             ("task_status_changed", "paused")}
            <= set(map(tuple, report["history_a"]["lifecycle"]))
            and {("action_started", "wait"), ("action_completed", "wait")}
            <= set(map(tuple, report["history_a"]["actions"]))
            and report["history_a"]["traces"] > 0),
        # vacuous under the baton batcher (no sources on either side)
        "watchdog_baton": len(watchdogs) == 3 and all(
            w["status"]["sources"] == w["backend_sources"]
            and w["status"]["trips"] == 0 for w in watchdogs),
        "watchdog_loop": (
            report["loop_watchdog"]["ok"]
            and report["loop_watchdog"]["status"]["sources"]
            == sorted(f"decode-loop:{m}" for m in ("xla:tiny", tiny128))
            and report["loop_watchdog"]["status"]["running"]
            and report["loop_watchdog"]["progress"][1][1]
            > report["loop_watchdog"]["progress"][0][1]
            and report["loop_watchdog"]["scan_tripped"] == []
            and report["loop_watchdog"]["status"]["trips"] == 0),
        "status": report["status"]["tasks"].get(task_id) == "paused",
        "kernels": launches["ragged_fwd"] > 0 and all(
            launches[k] == 0 for k in
            ("paged_fwd", "paged_prefill_fwd", "ragged_q8_fwd")),
        "device_default": report["device_default"] == {
            "xla:tiny": "cuda", tiny128: "cuda"},
        "cleaned": not os.path.exists(tmp),
    }
    report["checks"] = checks
    del pool_backend
    torch.cuda.empty_cache()
    if not all(checks.values()):
        emit(report)
        raise AssertionError(f"the runtime phase failed its checks: "
                             f"{[k for k, v in checks.items() if not v]}")
    return report


WEB_GROVE = """---
name: chip-smoke-grove
description: the web phase's grove
version: "1.0"
topology:
  root: coordinator
  edges:
    - parent: coordinator
      child: worker
      auto_inject:
        skills: [worker-skill]
        constraints: "Answer only from provided data."
governance:
  hard_rules:
    - type: shell_pattern_block
      pattern: "curl|wget"
      message: "no network"
      scope: [worker]
    - type: action_block
      actions: [fetch_web, call_api]
      message: "no external sources"
      scope: [worker]
  injections:
    - source: governance/integrity.md
      inject_into: [coordinator, worker]
      priority: high
schemas:
  - name: report
    definition: schemas/report.schema.json
    validate_on: file_write
    path_pattern: "{ws}/runs/*/report.json"
workspace: "{ws}"
confinement_mode: strict
confinement:
  worker:
    paths:
      - {ws}/runs/**
    read_only_paths:
      - {ws}/data/**
bootstrap:
  skills: [coord-skill]
  role: "Benchmark Coordinator"
  cognitive_style: systematic
  task_description_file: bootstrap/task.md
---
"""
WEB_FILES = {
    "governance/integrity.md": "Never fabricate results.",
    "schemas/report.schema.json": json.dumps({
        "type": "object", "required": ["score"],
        "properties": {"score": {"type": "number"}}}),
    "bootstrap/task.md": "Keep the build green: decide your next step.",
    "skills/worker-skill/SKILL.md": "---\nname: worker-skill\ndescription: "
                                    "how to answer\n---\n\nAlways answer "
                                    "with a single letter.",
    "skills/coord-skill/SKILL.md": "---\nname: coord-skill\ndescription: "
                                   "how to coordinate\n---\n\nSpawn one "
                                   "worker per question.",
}
WEB_CLI_WATCH_S = 5.0       # the cli run's watch
# the cli run's output limit: its member decides at most this many tokens
# a round (a random-weight answer closes its JSON or not; the run needs a
# served query and the kernel's launches, not an "ok")
WEB_CLI_OUTPUT_LIMIT = 64
# /api/resources' device used bytes against the script's own
# torch.cuda.mem_get_info, read just after with every agent idle
WEB_MEM_MARGIN = 256 << 20


def web_grove(root: str) -> tuple:
    """The web phase's grove under ``root`` (the shape of
    tests/test_governance_grove.py's write_grove): (grove dir,
    workspace)."""
    grove, ws = os.path.join(root, "groves", "bench"), os.path.join(
        root, "workspace")
    for rel, text in {"GROVE.md": WEB_GROVE.format(ws=ws),
                      **WEB_FILES}.items():
        path = os.path.join(grove, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return grove, ws


def web_call(url: str, method: str = "GET", body=None):
    """(status, JSON body or text) of one request to the dashboard."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, method=method, headers={"content-type": "application/json"},
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=AGENT_HUNG_S) as r:
            status, ctype, raw = (r.status, r.headers["content-type"],
                                  r.read().decode())
    except urllib.error.HTTPError as e:
        status, ctype, raw = (e.code, e.headers["content-type"],
                              e.read().decode())
    return status, (json.loads(raw) if ctype.startswith("application/json")
                    else raw)


def phase_web(torch, R, kernels, decide_backend) -> dict:
    """The front doors (web/server.py's DashboardServer, cli.py) and
    groves on the card: see the module docstring's web entry."""
    from quoracle_tpu_torch import cli
    from quoracle_tpu_torch import runtime as RT
    from quoracle_tpu_torch.governance.grove import list_groves
    from quoracle_tpu_torch.models import config as C
    from quoracle_tpu_torch.web import DashboardServer
    A = agent_modules()
    t_phase = time.monotonic()
    # /api/tree reads the session-graph plane, which the obs phase leaves
    # off: on for this phase (the package's default), as it was after
    tree_was_on = A.treeobs.enabled()
    A.treeobs.enable()
    # members in turn: with three member threads each one's decode step
    # takes 103-133 ms against 15-18 alone at this depth (the GIL at every
    # eager launch; PERF.md section 5), so a round takes about twice as
    # long; the phase's subject is the host layer above the backend
    pool_backend = agent_backend(R, decide_backend, DECIDE_POOL,
                                 overlap=False)
    for spec in DECIDE_POOL:
        pool_backend.engines[spec]._json_table_device((("wait",),))
    forbidden = tuple(a for a in A.ACTIONS if a != "wait")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-web-")
    grove_dir, ws = web_grove(tmp)
    report = {"phase": "web", "pool": DECIDE_POOL, "depth": DEPTH_CUT,
              "max_tokens": DECIDE_MAX_TOKENS, "overlap": False,
              "shipped": {g.name: {"root": g.root_node,
                                   "edges": [(e.parent, e.child)
                                             for e in g.edges],
                                   "schemas": sorted(s.name
                                                     for s in g.schemas)}
                          for g in list_groves(os.path.join(REPO,
                                                            "groves"))}}
    report_path = os.path.join(ws, "runs", "r1", "report.json")

    async def main():
        rt = RT.Runtime(RT.RuntimeConfig(
            backend="torch", groves_dir=os.path.dirname(grove_dir),
            db_path=os.path.join(tmp, "web.db")), backend=pool_backend)
        watch = AgentWatch(A, [pool_backend], rt.bus)
        rt.supervisor = watch.supervisor(rt.deps, forbidden)
        server = None
        loop = asyncio.get_running_loop()

        async def call(path, method="GET", body=None):
            return await loop.run_in_executor(
                None, web_call, server.url + path, method, body)
        # the SSE reader stops at the first action_completed (or, when
        # the phase fails first, at its next heartbeat)
        attached, sse, seen = threading.Event(), [], threading.Event()
        try:
            server = await DashboardServer(rt, host="127.0.0.1",
                                           port=0).start()
            report["groves"] = await call("/api/groves")
            # the SSE reader subscribes before the task is created
            subscribe = rt.bus.subscribe

            def spy(topic, fn):
                sub = subscribe(topic, fn)
                attached.set()
                return sub
            rt.bus.subscribe = spy

            def read_sse():
                import urllib.request
                with urllib.request.urlopen(server.url + "/events",
                                            timeout=AGENT_HUNG_S) as resp:
                    while not seen.is_set():
                        line = resp.readline()
                        if line.startswith(b"data: "):
                            e = json.loads(line[6:])
                            sse.append((e["topic"], e["event"],
                                        e.get("agent_id")))
                            if e["event"] == "action_completed":
                                seen.set()
            reader = loop.run_in_executor(None, read_sse)
            await loop.run_in_executor(None, attached.wait, 60)
            rt.bus.subscribe = subscribe
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            pages0 = pages_view(pool_backend)
            since = watch.mark()
            status, made = await call("/api/tasks", "POST", {
                "grove": grove_dir, "model_pool": list(DECIDE_POOL)})
            report["create"] = {"status": status, "body": made,
                                "ms": (time.monotonic() - since[4]) * 1e3}
            task_id, root_id = made["task_id"], made["root_agent"]
            root = rt.registry.lookup(root_id).core
            tick1 = await watch.tick(root, None, since=since)
            await asyncio.wait_for(reader, AGENT_HUNG_S)
            report["sse"] = sorted({(t, e) for t, e, a in sse
                                    if t in ("agents:lifecycle",
                                             "actions:all")
                                    and a == root_id})
            report["root"] = {
                "node": root.config.grove_node,
                "skills": list(root.active_skills),
                "prompt": [x in root._system_prompt for x in (
                    "Spawn one worker per question.", "worker-skill",
                    "Never fabricate results.", "Benchmark Coordinator")],
                "working_dir": root.config.working_dir == ws}

            # a child along the edge: a scripted spawn, a tick on the card
            watch.scripts[root_id] = [scripted_outcome(A, "spawn_child", {
                "task_description": "Write the run's report.",
                "success_criteria": "report written",
                "immediate_context": f"the report goes to {report_path}",
                "approach_guidance": "one file"})]
            spawn = await watch.tick(root, {
                "type": "user_message", "from": "user",
                "content": "Spawn a worker."})
            await watch.until(lambda: root.children)
            child_id = root.children[0]["agent_id"]
            child = rt.registry.lookup(child_id).core
            await watch.until(lambda: any(
                e.kind == "result" for e in child.ctx.history(MODEL))
                and watch.idle(child))
            couts = watch.outcomes.get(child_id, [])
            child_calls = [c for c in watch.calls if c["session"] == child_id]
            report["child"] = {
                "tick_ms": [sp["duration_ms"] for sp in watch.spans
                            if sp["name"] == "agent.decide_tick"
                            and sp.get("agent_id") == child_id],
                "decode": decode_steps({"agent": child_id,
                                        "calls": child_calls}),
                "spawn_result": str(root.ctx.history(MODEL)[-1].content),
                "node": child.config.grove_node,
                "skills": list(child.active_skills),
                "blocked": sorted(set(watch.configured[child_id])
                                  & {"fetch_web", "call_api"}),
                "constraint": "Answer only from provided data."
                in (child.config.field_system_prompt or ""),
                "outcomes": [{"status": o.status, "rounds": o.rounds_used,
                              "scripted": o.decide_id is None}
                             for o in couts]}
            # the child's grove branches, one scripted decide a tick
            refusals, grove_ms = [], []
            for action, params in (
                    ("file_write", {"path": os.path.join(tmp, "outside.txt"),
                                    "content": "x"}),
                    ("file_write", {"path": report_path,
                                    "content": '{"score": "high"}'}),
                    ("file_write", {"path": report_path,
                                    "content": '{"score": 0.5}'}),
                    # matches the hard rule; harmless if it ran
                    ("execute_shell", {"command": "echo curl"})):
                watch.scripts[child_id] = [scripted_outcome(A, action,
                                                            params)]
                rec = await watch.tick(child, {"type": "user_message",
                                               "from": "user",
                                               "content": "Go on."})
                grove_ms.append(rec["wall_ms"])
                refusals.append(str(child.ctx.history(MODEL)[-1].content))
            report["grove_actions"] = [r[:400] for r in refusals]
            report["grove_tick_ms"] = grove_ms
            report["written"] = (open(report_path).read()
                                 if os.path.exists(report_path) else None)
            report["outside_exists"] = os.path.exists(
                os.path.join(tmp, "outside.txt"))

            # the read routes, each with the port's own numbers
            routes = {}
            for path in ("/api/status", f"/api/agents?task_id={task_id}",
                         "/api/kv", "/api/resources", "/api/costs",
                         "/api/models", f"/api/tree?tree_id={task_id}",
                         f"/api/trace?task_id={task_id}", "/metrics",
                         "/api/chaos", "/api/sim", "/api/train"):
                routes[path.split("?")[0]] = await call(path)
            free, total = torch.cuda.mem_get_info()
            res_body = routes["/api/resources"][1]
            device = res_body["hbm"]["device"]
            metrics = {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
                       for line in routes["/metrics"][1].splitlines()
                       if line.startswith("quoracle_")}
            report["routes"] = {p: s for p, (s, _) in routes.items()}
            report["resources"] = {
                "device": device, "mem_get_info_used": int(total - free)}
            report["agents"] = [{k: a.get(k) for k in (
                "grove_node", "todos", "budget", "cost", "active_skills")}
                for a in routes["/api/agents"][1]]
            report["metrics"] = {k: metrics.get(k) for k in (
                "quoracle_decide_ms_count", "quoracle_round_ms_count",
                "quoracle_consensus_rounds_total")}
            report["trace_spans"] = routes["/api/trace"][1]["n_spans"]
            report["tree_nodes"] = len(routes["/api/tree"][1].get("nodes")
                                       or [])
            report["not_ported"] = {p: routes[p][1] for p in (
                "/api/sim", "/api/train")}
            report["costs_nominal"] = routes["/api/costs"][1]["nominal"][
                "total_amount"]

            # pause and resume over HTTP
            t0 = time.monotonic()
            status, paused = await call(f"/api/tasks/{task_id}/pause",
                                        "POST")
            pause_ms = (time.monotonic() - t0) * 1e3
            _, tasks = await call("/api/tasks")
            report["pause"] = {
                "status": status, "stopped": paused.get("stopped"),
                "ms": pause_ms,
                "row": [t["status"] for t in tasks if t["id"] == task_id],
                "sessions_dropped": all(
                    e.sessions.get(a) is None
                    for e in pool_backend.engines.values()
                    for a in (root_id, child_id)),
                "pages": [pages0, pages_view(pool_backend)]}
            t0 = time.monotonic()
            status, resumed = await call(f"/api/tasks/{task_id}/resume",
                                         "POST")
            resume_ms = (time.monotonic() - t0) * 1e3
            core = rt.registry.lookup(root_id).core
            tick2 = await watch.tick(core, {
                "type": "user_message", "from": "user",
                "content": RUNTIME_MESSAGES[1]})
            calls = [c for c in tick2["calls"] if c["session"] == root_id]
            report["resume"] = {
                "status": status, "restored": resumed.get("restored"),
                "ms": resume_ms,
                "wall_ms": tick2["wall_ms"],
                "members": {m: {"prefill": st["prompt"] - st["cached"],
                                "cached": st["cached"]}
                            for m, st in calls[0]["members"].items()}
                if calls else {}}
            torch.cuda.synchronize()
            report["launches"] = kernels.launch_counts()
            await rt.tasks.pause_task(task_id)
            report["ticks"] = {"root": tick1, "spawn": spawn,
                               "restored": tick2}
            report["decode"] = {k: decode_steps(t)
                                for k, t in report["ticks"].items()}
            report["child_tick_ok"] = any(
                o.status == "ok" and o.decide_id is not None for o in couts)
            return task_id
        finally:
            seen.set()
            if server is not None:
                await server.stop()
            watch.close()
            await rt.shutdown()

    try:
        task_id = asyncio.run(main())
        # the CLI over the card (its default device) with the grove: its
        # pool llama-3-8b at full width cut to DEPTH_CUT layers, with a
        # short output limit, drawn by the CLI's own TorchBackend; its
        # agents decide only "wait", as the phase's do
        cli_spec = "xla:" + C.register_model(dataclasses.replace(
            depth_cut(MODEL), name=f"llama-3-8b-{DEPTH_CUT}layer-cli",
            output_limit=WEB_CLI_OUTPUT_LIMIT)).name
        built, watches = [], []

        class Runtime(cli.Runtime):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                built.append(self)
                # the pool's llama-3-8b grammar tables (the same tokenizer,
                # vocab and stop ids), as agent_backend shares them: a new
                # engine's first decide walks the 128,256 tokens on the
                # host first (~5 s, the whole watch)
                for e in self.backend.engines.values():
                    e._json_cache = pool_backend.engines[MODEL]._json_cache
                watches.append(AgentWatch(A, [self.backend], self.bus))
                self.supervisor = watches[-1].supervisor(self.deps,
                                                         forbidden)
        cli_db = os.path.join(tmp, "cli.db")
        cli_runtime, cli.Runtime = cli.Runtime, Runtime
        out = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(["run", "Keep the build green.", "--backend",
                               "torch", "--pool", cli_spec, "--grove",
                               grove_dir, "--db", cli_db, "--watch-seconds",
                               str(WEB_CLI_WATCH_S)])
        finally:
            cli.Runtime = cli_runtime
            for w in watches:
                w.close()
            for rt in built:
                rt.backend.close()
        torch.cuda.synchronize()
        cli_launches = kernels.launch_counts()
        status_out = io.StringIO()
        with contextlib.redirect_stdout(status_out):
            rc_status = cli.main(["status", "--db", cli_db])
        cli_calls = [c for w in watches for c in w.calls]
        report["cli"] = {
            "rc": [rc, rc_status], "seconds": time.monotonic() - t0,
            "pool": [cli_spec], "runtimes": len(built),
            "devices": {s: e.device.type for rt in built
                        for s, e in rt.backend.engines.items()},
            "lines": out.getvalue().splitlines()[:12],
            "status": json.loads(status_out.getvalue()),
            "queries": len(cli_calls),
            "outcomes": [o.status for w in watches
                         for outs in w.outcomes.values() for o in outs],
            "decode": {aid: decode_steps({"agent": aid, "calls": cli_calls})
                       for aid in {c["session"] for c in cli_calls}},
            "launches": cli_launches}
        del built
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if not tree_was_on:
            A.treeobs.disable()
    report["seconds"] = time.monotonic() - t_phase
    report["nvidia_smi"] = nvidia_smi()
    groves, launches, pause = report["groves"], report["launches"], \
        report["pause"]
    child, cli_report = report["child"], report["cli"]
    device = report["resources"]["device"]
    boot = (groves[1][0]["bootstrap"]
            if groves[0] == 200 and groves[1] else {})
    acts = report["grove_actions"]
    checks = {
        "shipped": report["shipped"] == {
            "livebench": {"root": "lb-coordinator",
                          "edges": [("lb-coordinator", "lb-solver")],
                          "schemas": ["answer", "benchmark-report"]},
            "mmlu-pro": {"root": "mmlu-coordinator",
                         "edges": [("mmlu-coordinator", "mmlu-answerer")],
                         "schemas": ["answer", "benchmark-report"]}},
        "groves": (groves[0] == 200 and len(groves[1]) == 1
                   and groves[1][0]["root_node"] == "coordinator"
                   and boot.get("role") == "Benchmark Coordinator"
                   and boot.get("task_description")
                   == WEB_FILES["bootstrap/task.md"]),
        "create": report["create"]["status"] == 201,
        "root": (report["root"]["node"] == "coordinator"
                 and report["root"]["skills"] == ["coord-skill"]
                 and all(report["root"]["prompt"])
                 and report["root"]["working_dir"]),
        "tick1": agent_tick_ok(report["ticks"]["root"], task_id),
        "sse": {("agents:lifecycle", "agent_spawned"),
                ("actions:all", "action_started"),
                ("actions:all", "action_completed")} <= set(
                    map(tuple, report["sse"])),
        "child": (child["node"] == "worker"
                  and "worker-skill" in child["skills"]
                  and child["blocked"] == ["call_api", "fetch_web"]
                  and child["constraint"] and report["child_tick_ok"]),
        "confinement": ("outside the allowed paths" in acts[0]
                        and not report["outside_exists"]),
        "schema": "schema report: 'high' is not of type 'number'" in acts[1],
        "written": (report["written"] == '{"score": 0.5}'
                    and "'status': 'ok'" in acts[2]),
        "hard_rule": "blocked by grove hard rule: no network" in acts[3],
        "routes": all(report["routes"][p] == 200 for p in report["routes"]
                      if p not in ("/api/sim", "/api/train")),
        "not_ported": all(
            report["routes"][p] == 501 and b["roadmap"].startswith(
                "ROADMAP Queue 1 item")
            for p, b in report["not_ported"].items()),
        "device_block": (device is not None and device["consistent"]
                         and sum(device["parts"].values())
                         <= device["used_bytes"]
                         and abs(device["used_bytes"]
                                 - report["resources"]["mem_get_info_used"])
                         <= WEB_MEM_MARGIN),
        "agents": sorted(a["grove_node"] for a in report["agents"])
        == ["coordinator", "worker"],
        "metrics": all(v and v > 0 for v in report["metrics"].values()),
        "trace": report["trace_spans"] > 0 and report["tree_nodes"] >= 2,
        "paused": (pause["status"] == 200 and pause["stopped"] == 2
                   and pause["row"] == ["paused"]
                   and pause["sessions_dropped"]),
        "pages_back": all(
            p1["free"] + p1["cached"] == p0["free"] + p0["cached"]
            for p0, p1 in zip(pause["pages"][0].values(),
                              pause["pages"][1].values())),
        "resumed": (report["resume"]["status"] == 200
                    and report["resume"]["restored"] == 2
                    and agent_tick_ok(report["ticks"]["restored"],
                                      task_id)),
        "kernels": launches["ragged_fwd"] > 0 and all(
            launches[k] == 0 for k in
            ("paged_fwd", "paged_prefill_fwd", "ragged_q8_fwd")),
        "cli": (cli_report["rc"] == [0, 0] and cli_report["runtimes"] == 1
                and cli_report["devices"] == {cli_spec: "cuda"}
                and cli_report["queries"] > 0
                and list(cli_report["status"]["tasks"].values())
                == ["paused"]
                and cli_report["launches"]["ragged_fwd"] > 0),
        "cleaned": not os.path.exists(tmp),
    }
    report["checks"] = checks
    del pool_backend
    torch.cuda.empty_cache()
    if not all(checks.values()):
        emit(report)
        raise AssertionError(f"the web phase failed its checks: "
                             f"{[k for k, v in checks.items() if not v]}")
    return report


CLUSTER_RULES = 12          # the cluster phase's chat prompt: ~320 tokens,
                            # past flash's 256-token chunk on the dense path
CLUSTER_TOKENS = 48         # new tokens a row of the cluster phase
CLUSTER_POOL_BYTES = 512 << 20   # each engine's session pool
CLUSTER_FP32_LAYERS = 2     # the fp32 cut of the cross-tick equalities


class ReplicaLaunches:
    """Kernel launches per replica: each replica engine's ``generate`` is
    wrapped to book the launch-count delta of its call. The phase serves
    one row at a time, so no two engines run at once."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.by: dict = {}

    def watch(self, label: str, eng) -> None:
        inner = eng.generate
        counts = self.kernels.launch_counts

        def generate(*a, **kw):
            c0 = counts()
            try:
                return inner(*a, **kw)
            finally:
                c1 = counts()
                mine = self.by.setdefault(label, dict.fromkeys(c1, 0))
                for k in c1:
                    mine[k] += c1[k] - c0[k]
        eng.generate = generate

    def watch_plane(self, cl) -> None:
        """Watch every engine of the plane's replicas not yet watched."""
        for rep in cl.replicas:
            for eng in rep.backend.engines.values():
                if not getattr(eng, "_launches_booked", False):
                    eng._launches_booked = True
                    self.watch(rep.replica_id, eng)


def cluster_factory(cfg, params, tokenizer, json_cache, devices: set):
    """``ClusterPlane.build``'s engine factory: each call a new engine
    over ``params`` (no copy) and the shared grammar tables, its own
    session pool, prefix sharing off (each row's prefill is then the same
    computation on any engine; a prefill over a cached prefix sums in
    another order)."""
    from quoracle_tpu_torch.models.generate import GenerateEngine

    def factory(spec, quantize_weights=False, quantize_kv=False):
        assert spec == MODEL and not (quantize_weights or quantize_kv)
        e = GenerateEngine(cfg, params, tokenizer, seed=0, device="cuda",
                           session_max_bytes=CLUSTER_POOL_BYTES)
        e._json_cache = json_cache
        e.prefix_sharing = False
        devices.add(e.device.type)
        return e
    return factory


def cluster_rows(R, sids: tuple, user: str = "pick the next action"):
    """The phase's three rows: a constrained JSON row and a greedy row on
    sessions ``sids``, and a sessionless row, all at temperature 0."""
    msgs = chat(user, CLUSTER_RULES)
    return [R.QueryRequest(MODEL, msgs, temperature=0.0,
                           max_tokens=CLUSTER_TOKENS, session_id=sids[0],
                           constrain_json=True),
            R.QueryRequest(MODEL, msgs, temperature=0.0,
                           max_tokens=CLUSTER_TOKENS, session_id=sids[1]),
            R.QueryRequest(MODEL, msgs, temperature=0.0,
                           max_tokens=CLUSTER_TOKENS)]


def round_two(R, row, first):
    """The greedy row's next round: its history and one more message."""
    msgs = list(row.messages) + [
        {"role": "assistant", "content": first.text},
        {"role": "user", "content": "continue with the next step"}]
    return R.QueryRequest(MODEL, msgs, temperature=0.0,
                          max_tokens=CLUSTER_TOKENS,
                          session_id=row.session_id)


def serve_each(backend, rows) -> tuple:
    """Each row as its own query (one row at a time, as every plane of
    the phase serves them); the results and each one's wall ms."""
    out, ms = [], []
    for r in rows:
        t0 = time.monotonic()
        (one,) = backend.query([r])
        ms.append((time.monotonic() - t0) * 1e3)
        if not one.ok:
            raise AssertionError(f"cluster phase row error: {one.error}")
        out.append(one)
    return out, ms


def same_rows(got, want) -> list:
    """Per row: the texts and cached counts equal."""
    return [a.text == b.text and a.cached_tokens == b.cached_tokens
            for a, b in zip(got, want)]


def new_events(flight, before: set) -> list:
    return [e for e in flight.snapshot() if id(e) not in before]


def cluster_unified(R, kernels, factory, embedder, per) -> dict:
    """(a) two unified replicas in baton mode against one backend."""
    from quoracle_tpu_torch.serving.cluster import ClusterPlane
    mono = R.TorchBackend([MODEL], device="cuda",
                          engines={MODEL: factory(MODEL)}, embedder=embedder)
    rows = cluster_rows(R, ("u-c", "u-g"))
    want, _ = serve_each(mono, rows)
    want2, _ = serve_each(mono, [round_two(R, rows[1], want[1])])
    cl = ClusterPlane.build([MODEL], replicas=2, disaggregate=False,
                            device="cuda", engine_factory=factory,
                            continuous=False)
    try:
        per.watch_plane(cl)
        got, ms = serve_each(cl, rows[:2])
        flash0 = kernels.launch_counts()["flash_fwd"]
        got += serve_each(cl, rows[2:])[0]
        flash = kernels.launch_counts()["flash_fwd"] - flash0
        holder = cl.router.affinity_of("u-g").replica_id
        got2, _ = serve_each(cl, [round_two(R, rows[1], got[1])])
        return {
            "replicas": [(r.replica_id, r.role) for r in cl.replicas],
            "rows_equal": same_rows(got, want), "row_ms": ms,
            "round2": {"equal": same_rows(got2, want2)[0],
                       "cached_tokens": got2[0].cached_tokens,
                       "replica": cl.router.affinity_of("u-g").replica_id,
                       "held_by": holder},
            "exports": cl.handoff.exports,
            "sessionless_flash_launches": flash}
    finally:
        cl.close()


def cluster_disagg(R, factory, embedder, per) -> dict:
    """(b) 1 prefill + 2 decode replicas at the phase's width and depth
    against one continuous backend, then kill_mid_handoff over them."""
    from quoracle_tpu_torch.chaos import scenarios as S
    from quoracle_tpu_torch.infra.flightrec import FLIGHT
    from quoracle_tpu_torch.serving.cluster import ClusterPlane
    mono = R.TorchBackend([MODEL], device="cuda",
                          engines={MODEL: factory(MODEL)}, embedder=embedder,
                          continuous=True)
    rows = cluster_rows(R, ("d-c", "d-g"))
    try:
        want, _ = serve_each(mono, rows)
    finally:
        mono.close()
    cl = ClusterPlane.build([MODEL], replicas=3, disaggregate=True,
                            device="cuda", engine_factory=factory,
                            continuous=True)
    try:
        per.watch_plane(cl)
        envelopes = []
        export = cl.handoff.export

        def recording_export(*a, **kw):
            env = export(*a, **kw)
            envelopes.append((env.session_id, env.n_tokens,
                              int(env.entry.nbytes)))
            return env
        cl.handoff.export = recording_export
        before = {id(e) for e in FLIGHT.snapshot()}
        got, ms = serve_each(cl, rows)
        events = new_events(FLIGHT, before)
        out = {
            "replicas": [(r.replica_id, r.role) for r in cl.replicas],
            "row_ms": ms, "ledger": cl.handoff.stats(),
            "envelopes": list(envelopes),
            "export_ms": [e["ms"] for e in events
                          if e["kind"] == "kv_handoff_export"],
            "adopt_ms": [e["ms"] for e in events
                         if e["kind"] == "kv_handoff_adopt"],
            # recorded, not checked: in bf16 the decode replica's first
            # step is a 1-token chunk tick where the backend runs a
            # decode tick, and the two sum in another order (the fp32
            # cut below checks the equality)
            "bf16_rows_equal": same_rows(got, want),
            "bf16_first_diff": [first_diff(a.text, b.text)
                                for a, b in zip(got, want)]}
        t0 = time.monotonic()
        scen = S.run_scenario("kill_mid_handoff", seed=5, context={
            "cluster": cl, "backends": [cl], "member": MODEL})
        out["scenario"] = {
            "passed": scen.passed, "seconds": time.monotonic() - t0,
            "schedule": scen.schedule,
            "invariants": [(r.name, r.ok, r.detail)
                           for r in scen.invariants]}
        out["prefill_replica"] = next(r.replica_id for r in cl.replicas
                                      if r.role == "prefill")
        return out
    finally:
        cl.close()


def cluster_fp32(torch, R, kernels, json_cache, devices, per) -> dict:
    """(c) the cross-tick equalities on an fp32 cut of llama-3-8b at full
    width: the three rows through 1 prefill + 2 decode replicas against
    one continuous backend, a fleet drain of the replica holding the
    sessions (the greedy session's round 2 after it), a decode replica
    killed mid-row (the envelope re-places the row)."""
    from quoracle_tpu_torch.chaos.faults import CHAOS, FaultPlan, FaultRule
    from quoracle_tpu_torch.infra.flightrec import FLIGHT
    from quoracle_tpu_torch.models import config as C
    from quoracle_tpu_torch.models.tokenizer import get_tokenizer
    from quoracle_tpu_torch.serving.cluster import ClusterPlane
    from quoracle_tpu_torch.serving.fleet import FleetController
    cfg = C.register_model(dataclasses.replace(
        C.get_model_config(MODEL),
        name=f"llama-3-8b-{CLUSTER_FP32_LAYERS}layer",
        n_layers=CLUSTER_FP32_LAYERS))
    params = fp32_cut(torch, cfg, 1)
    factory = cluster_factory(cfg, params, get_tokenizer(MODEL),
                              json_cache, devices)
    mono = R.TorchBackend([MODEL], device="cuda",
                          engines={MODEL: factory(MODEL)}, continuous=True)
    rows = cluster_rows(R, ("f-c", "f-g"))
    crash = cluster_rows(R, ("f-x", "f-k"),
                         user="name the next file to open")[1]
    try:
        want, _ = serve_each(mono, rows)
        want2, _ = serve_each(mono, [round_two(R, rows[1], want[1])])
        want_k, _ = serve_each(mono, [crash])
    finally:
        mono.close()
    cl = ClusterPlane.build([MODEL], replicas=3, disaggregate=True,
                            device="cuda", engine_factory=factory,
                            continuous=True)
    try:
        per.watch_plane(cl)
        got, _ = serve_each(cl, rows)
        out = {"layers": CLUSTER_FP32_LAYERS,
               "rows_equal": same_rows(got, want)}
        holder = cl.router.affinity_of("f-g")
        eng = holder.backend.engines[MODEL]
        with eng.sessions.lock:
            resident = sorted(set(eng.sessions._sessions)
                              | set(eng.sessions.tier.host.sessions))
        t0 = time.monotonic()
        summary = FleetController(cl).drain(holder.replica_id,
                                            reason="chip-smoke")
        drain_ms = (time.monotonic() - t0) * 1e3
        with eng.sessions.lock:
            left = (len(eng.sessions._sessions)
                    + len(eng.sessions.tier.host.sessions))
        moved = cl.router.affinity_of("f-g").replica_id
        got2, _ = serve_each(cl, [round_two(R, rows[1], got[1])])
        out["fleet"] = {
            "held_by": holder.replica_id, "resident": resident,
            "summary": summary, "drain_ms": drain_ms,
            "left_on_source": left, "moved_to": moved,
            "inflight": cl.handoff.stats()["inflight"],
            "round2_equal": same_rows(got2, want2)[0],
            "round2_cached_tokens": got2[0].cached_tokens}
        before = {id(e) for e in FLIGHT.snapshot()}
        plan = FaultPlan(0, [FaultRule("cluster.decode", "crash",
                                       max_fires=1)])
        with CHAOS.arming(plan):
            got_k, _ = serve_each(cl, [crash])
        out["decode_death"] = {
            "schedule": plan.schedule(),
            "dead": [r.replica_id for r in cl.replicas if not r.alive],
            "equal": same_rows(got_k, want_k)[0],
            "replaced": cl.handoff.replaced,
            "flight": sorted({e["kind"] for e in new_events(FLIGHT, before)
                              if e["kind"] in ("kv_handoff_replace",
                                               "cluster_replica_dead")})}
        return out
    finally:
        cl.close()


def phase_cluster(torch, R, kernels, decide_backend) -> dict:
    """The multi-replica plane on the card (serving/cluster.py, router.py,
    fleet.py, chaos/): see the module docstring's cluster entry."""
    from quoracle_tpu_torch.infra import locks
    t_phase = time.monotonic()
    base = decide_backend.engines[MODEL]       # the 8-layer view
    devices: set = set()
    factory = cluster_factory(base.cfg, base.params, base.tokenizer,
                              base._json_cache, devices)
    report = {"phase": "cluster", "model": MODEL, "depth": DEPTH_CUT,
              "max_tokens": CLUSTER_TOKENS, "prefix_sharing": False}
    # the plain JSON grammar's tables, built once for every engine here
    t0 = time.monotonic()
    base._json_table_device((None,))
    report["grammar_s"] = time.monotonic() - t0
    was_checking = locks.enabled()
    locks.enable()                 # the scenario's lockdep_clean reads it
    locks.LOCKDEP.drain()
    per = ReplicaLaunches(kernels)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        u = report["unified"] = cluster_unified(
            R, kernels, factory, decide_backend.embedder, per)
        gc.collect()
        torch.cuda.empty_cache()
        d = report["disaggregated"] = cluster_disagg(
            R, factory, decide_backend.embedder, per)
        gc.collect()
        torch.cuda.empty_cache()
        f = report["fp32"] = cluster_fp32(torch, R, kernels,
                                          base._json_cache, devices, per)
        torch.cuda.synchronize()
    finally:
        if not was_checking:
            locks.disable()
    gc.collect()
    torch.cuda.empty_cache()
    launches = kernels.launch_counts()
    report["launches"] = launches
    report["replica_launches"] = per.by
    report["devices"] = sorted(devices)
    report["seconds"] = time.monotonic() - t_phase
    fl, death = f["fleet"], f["decode_death"]
    checks = {
        "unified_rows": all(u["rows_equal"]),
        "unified_round2": (u["round2"]["equal"]
                           and u["round2"]["cached_tokens"] > 0
                           and u["round2"]["replica"]
                           == u["round2"]["held_by"]
                           and u["exports"] == 0),
        "sessionless_flash": u["sessionless_flash_launches"] > 0,
        "handoffs": (d["ledger"]["exports"] == 3
                     and d["ledger"]["adopts"] == 3
                     and d["ledger"]["inflight"] == 0),
        "scenario": d["scenario"]["passed"],
        "disagg_rows_fp32": all(f["rows_equal"]),
        "drain": (fl["summary"]["migrated"] == len(fl["resident"]) > 0
                  and fl["summary"]["failed"] == 0
                  and not fl["summary"]["died"]
                  and fl["left_on_source"] == 0 and fl["inflight"] == 0
                  and fl["moved_to"] != fl["held_by"]),
        "migrated_round2": (fl["round2_equal"]
                            and fl["round2_cached_tokens"] > 0),
        "decode_death": (death["equal"] and len(death["dead"]) == 1
                         and death["replaced"] >= 1
                         and "kv_handoff_replace" in death["flight"]),
        "devices": report["devices"] == ["cuda"],
        "ragged_on_prefill": per.by.get(d["prefill_replica"], {}).get(
            "ragged_fwd", 0) > 0,
        "ragged_on_decode": sum(
            v["ragged_fwd"] for k, v in per.by.items()
            if k.startswith("decode-")) > 0,
        "kernels": (launches["ragged_fwd"] > 0 and launches["flash_fwd"] > 0
                    and all(launches[n] == 0 for n in (
                        "paged_fwd", "paged_prefill_fwd", "ragged_q8_fwd"))),
    }
    report["checks"] = checks
    if not all(checks.values()):
        emit(report)
        raise AssertionError(f"the cluster phase failed its checks: "
                             f"{[k for k, v in checks.items() if not v]}")
    return report


def phase_sweep(torch, F, P) -> dict:
    """Each kernel's time and bound over the lengths it serves, bf16 at
    llama-3-8b attention geometry: ragged decode ticks (tq=1, 3 live rows
    in 8 slots, the consensus round's shape) over resident lengths, over
    bf16 pages and over the same pages quantized to int8 (the int8
    kernel's time and bound beside ragged_fwd's) and the direct tier's
    paged decode over the same lengths (3 live rows in 4 slots), with each
    split-K launch's S and grid and, at 823 resident keys, the three
    split-K kernels at S forced to 1-32; flash prefill chunks (B=1, 64
    keys more than queries) over T, and paged prefill chunks of 16 and 128
    tokens over prefix lengths, each beside its bound and
    scaled_dot_product_attention's time on the same work."""
    from quoracle_tpu_torch.models.quant import kv_quant
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    H, KV, hd, page, n_pages = 32, 8, 128, 128, 129
    kp = torch.randn(n_pages, page, KV, hd, generator=g,
                     device=dev).bfloat16()
    vp = torch.randn(n_pages, page, KV, hd, generator=g,
                     device=dev).bfloat16()
    (kq, ks), (vq, vs) = (kv_quant(x) for x in (kp, vp))
    q8 = dict(k_scale=ks.transpose(1, 2).contiguous(),
              v_scale=vs.transpose(1, 2).contiguous())
    rows = []
    for resident in (128, 512, 823, 1800, 4000):
        slots, live, maxp = 8, 3, 32
        bt = torch.zeros(slots, maxp, dtype=torch.int32)
        bm = torch.zeros(slots, 3, dtype=torch.int32)
        for i in range(live):
            bt[i] = torch.arange(i * maxp, (i + 1) * maxp) % (n_pages - 1) + 1
            bm[i] = torch.tensor([resident, resident - 1, 1])
        bt, bm = bt.to(dev), bm.to(dev)
        q = torch.randn(slots, H, hd, generator=g, device=dev).bfloat16()
        b_ms, b_by = bound(*ragged_work(torch, q, kp, bt, bm, 1, None),
                           "bfloat16")
        q8_ms, q8_by = bound(*ragged_work(torch, q, kq, bt, bm, 1, None,
                                          scales=True), "bfloat16")
        rows.append({"kernel": "ragged_fwd", "tq": 1, "live_rows": live,
                     "resident": resident,
                     "ms": cuda_ms(torch, lambda: P.ragged_attend(
                         q, kp, vp, bt, bm, 1, None)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": cuda_ms(torch, ragged_library(
                         torch, q, kp, vp, bt, bm, 1, None)),
                     **split_grid(torch, P, slots, KV, maxp, page),
                     "ragged_q8_fwd": {
                         "ms": cuda_ms(torch, lambda: P.ragged_attend(
                             q, kq, vq, bt, bm, 1, None, **q8)),
                         "bound_ms": q8_ms, "bound_by": q8_by,
                         "library_ms": cuda_ms(torch, ragged_library(
                             torch, q, kq, vq, bt, bm, 1, None, **q8)),
                         **split_grid(torch, P, slots, KV, maxp, page)}})
        # the direct tier's decode over the same lengths: 3 live rows in
        # 4 slots, each query 16 tokens past its pool (a tail exists)
        tables = bt[:4].contiguous()
        lens = torch.tensor([resident] * live + [0], dtype=torch.int32,
                            device=dev)
        off = torch.zeros_like(lens)
        qpos = lens + 16
        qd = q[:4].contiguous()
        ints = (lens, off, qpos)
        pb_ms, pb_by = bound(*paged_work(torch, qd, kp, tables, *ints, None),
                             "bfloat16")
        rows.append({"kernel": "paged_fwd", "live_rows": live, "slots": 4,
                     "resident": resident,
                     "ms": cuda_ms(torch, lambda: P.paged_attend(
                         qd, kp, vp, tables, *ints)),
                     "bound_ms": pb_ms, "bound_by": pb_by,
                     "library_ms": cuda_ms(torch, paged_library(
                         torch, "paged_fwd", qd[:, None], kp, vp, tables,
                         ints, None)),
                     **split_grid(torch, P, 4, KV, maxp, page)})
        if resident == 823:
            # the share count by hand at the main path's length, for the
            # decode ticks and a chunk tick of 15 tokens a row (6 live
            # blocks of tq = 8 in 8): what split_count's target trades
            cbm = torch.zeros_like(bm)
            for i in range(2 * live):
                cbm[i] = torch.tensor([resident, resident - 15 + 8 * (i % 2),
                                       8 - (i % 2)])
            cbt = bt[[i // 2 if i < 2 * live else i for i in range(slots)]]
            qc = torch.randn(slots * 8, H, hd, generator=g,
                             device=dev).bfloat16()
            for S in (1, 2, 4, 8, 12, 16, 32):
                rows.append({
                    "kernel": "splits", "resident": resident,
                    "paged_fwd_ms": cuda_ms(torch, lambda: P.paged_attend(
                        qd, kp, vp, tables, *ints, splits=S)),
                    "ragged_fwd_ms": cuda_ms(
                        torch, lambda: P.ragged_attend(
                            q, kp, vp, bt, bm, 1, None, splits=S)),
                    "ragged_fwd_chunk_ms": cuda_ms(
                        torch, lambda: P.ragged_attend(
                            qc, kp, vp, cbt, cbm, 8, None, splits=S)),
                    "ragged_q8_fwd_ms": cuda_ms(
                        torch, lambda: P.ragged_attend(
                            q, kq, vq, bt, bm, 1, None, **q8, splits=S)),
                    "ragged_q8_fwd_chunk_ms": cuda_ms(
                        torch, lambda: P.ragged_attend(
                            qc, kq, vq, cbt, cbm, 8, None, **q8,
                            splits=S)),
                    "paged_fwd": split_grid(torch, P, 4, KV, maxp, page, S),
                    "ragged": split_grid(torch, P, slots, KV, maxp, page,
                                         S)})
    for T in (256, 512, 1024, 2048):
        q = torch.randn(1, T, H, hd, generator=g, device=dev).bfloat16()
        k = torch.randn(1, T + 64, KV, hd, generator=g,
                        device=dev).bfloat16()
        v = torch.randn(1, T + 64, KV, hd, generator=g,
                        device=dev).bfloat16()
        qp = torch.arange(T, device=dev, dtype=torch.int32)[None]
        kl = torch.tensor([T], device=dev, dtype=torch.int32)
        b_ms, b_by = bound(*flash_work(q, k, qp, kl, None, None),
                           "bfloat16")
        rows.append({"kernel": "flash_fwd", "T": T,
                     "ms": cuda_ms(torch, lambda: F.flash_attend(
                         q, k, v, qp, kl)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": cuda_ms(torch, flash_library(
                         torch, q, k, v, qp, kl, None, None))})
    # paged prefill: three rows resuming the same prefix length (the
    # consensus round's shape) with a chunk of T tokens, on scattered pages
    for T in (16, 128):
        for prefix in (128, 808, 1800, 4000):
            maxp = -(-prefix // page)
            tables = torch.stack([
                (torch.arange(maxp) * 3 + i) % (n_pages - 1) + 1
                for i in range(3)]).int().to(dev)
            lens = torch.full((3,), prefix, dtype=torch.int32, device=dev)
            q = torch.randn(3, T, H, hd, generator=g, device=dev).bfloat16()
            b_ms, b_by = bound(*paged_prefill_work(torch, q, kp, tables,
                                                   lens, None), "bfloat16")
            rows.append({
                "kernel": "paged_prefill_fwd", "T": T, "prefix": prefix,
                "rows": 3, "blocks": prefill_blocks(P, q, kp),
                "ms": cuda_ms(torch, lambda: P.paged_prefill_attend(
                    q, kp, vp, tables, lens)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": cuda_ms(torch, paged_library(
                    torch, "paged_prefill_fwd", q, kp, vp, tables, (lens,),
                    None))})
    return {"phase": "sweep", "cases": rows}


CKPT_MODEL = "llama-3-8b-ckpt"     # the catalog name of the exported copy
# the catalog fields a checkpoint's config.json must give back: widths,
# rope, norm and the family's switches
CONFIG_FIELDS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                 "ffn_dim", "head_dim", "rope_theta", "rope_scaling",
                 "norm_eps", "activation", "tie_embeddings",
                 "scale_embeddings", "rmsnorm_plus_one", "sliding_window",
                 "attn_bias", "context_window")
# make_checkpoint's tiny llama and gemma (2 layers, vocab 2048) at the
# CUDA kernels' head dims, 128 and 256: the tiny configs' 16 is below them
CKPT_TINY = {"llama": dict(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           head_dim=128),
             "gemma": dict(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=2,
                           head_dim=256)}
CKPT_TINY_TOKENS = 12               # new tokens a row of their rounds


def hf_config(cfg, ids: dict) -> dict:
    """A llama-family catalog entry as the config.json an HF export of it
    carries, with the checkpoint tokenizer's special ids."""
    if (cfg.activation, cfg.tie_embeddings, cfg.attn_bias,
            cfg.rope_scaling, cfg.sliding_window) != ("silu", False, False,
                                                      None, None):
        raise AssertionError(f"{cfg.name} is not a plain llama entry")
    return {"architectures": ["LlamaForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
            "intermediate_size": cfg.ffn_dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "max_position_embeddings": cfg.context_window,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "hidden_act": "silu", "tie_word_embeddings": False,
            "bos_token_id": ids["<|bos|>"], "eos_token_id": ids["<|eos|>"],
            "pad_token_id": ids["<|pad|>"], "torch_dtype": "bfloat16"}


def dense_logits(torch, params, cfg, ids: list):
    """fp32 logits of every position of one sequence (the dense path:
    flash from 256 tokens up on the card)."""
    from quoracle_tpu_torch.models import transformer as T
    n = len(ids)
    dev = params.final_norm.device
    tokens = torch.tensor([ids], dtype=torch.int32, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
    cache = T.init_cache(cfg, 1, n, dev, dtype=params.dtype)
    hidden, _ = T.forward_hidden(
        params, cfg, tokens, pos, cache,
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.full((1,), n, dtype=torch.int32, device=dev))
    return T.project_logits(params, cfg, hidden[0])


def ckpt_tiny_rounds(torch, R, root: str) -> dict:
    """make_checkpoint's tiny llama and gemma (CKPT_TINY), each loaded in
    fp32 on the card and on the CPU and served the same greedy traffic on
    the unified tier (the card's default, forced on the CPU): identical
    texts, token counts and cached counts."""
    from quoracle_tpu_torch.models import loader
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.make_checkpoint import make_checkpoint
    from quoracle_tpu_torch.models.tokenizer import get_tokenizer
    out = {}
    for i, (fam, widths) in enumerate(CKPT_TINY.items()):
        path = make_checkpoint(os.path.join(root, f"tiny-{fam}"),
                               family=fam, scale="tiny", seed=i,
                               overrides=widths)
        cfg = loader.register_hf_checkpoint(path, name=f"ckpt-tiny-{fam}")
        spec = f"xla:{cfg.name}"
        runs = {}
        for dev in ("cuda", "cpu"):
            eng = GenerateEngine(
                cfg, loader.load_params(path, cfg, device=dev,
                                        dtype=torch.float32),
                get_tokenizer(spec), device=dev)
            eng.unified_min_tokens = 0
            backend = R.TorchBackend([spec], device=dev,
                                     engines={spec: eng})
            t0 = time.monotonic()
            rounds, results, _ = run_rounds(
                R, backend, spec, [0.0] * 3, CKPT_TINY_TOKENS, n_rules=8)
            runs[dev] = {
                "s": time.monotonic() - t0,
                "texts": [[r.text for r in res] for res in results],
                "tokens": [[r.usage.completion_tokens for r in res]
                           for res in results],
                "cached": [rnd["cached_tokens"] for rnd in rounds]}
            backend.close()
            del backend, eng
        g, c = runs["cuda"], runs["cpu"]
        same = all(g[k] == c[k] for k in ("texts", "tokens", "cached"))
        row = {"identical": same, "gpu_s": g["s"], "cpu_s": c["s"],
               "cached_tokens": g["cached"][1], "new_tokens": g["tokens"]}
        if min(g["cached"][1]) <= 0:
            raise AssertionError(f"tiny {fam}: round 2 resumed nothing")
        if not same:
            row.update(gpu_texts=g["texts"], cpu_texts=c["texts"])
            emit({"phase": "ckpt", "tiny": {fam: row}})
            raise AssertionError(f"tiny {fam}: GPU and CPU disagree")
        out[fam] = row
    return out


def phase_ckpt(torch, R, kernels, dfa, backend, serve_report) -> dict:
    """Serve an HF checkpoint on the card: the serve phase's llama-3-8b
    bf16 weights exported at full width and depth to a temporary
    directory outside the checkout, with make_checkpoint's tokenizer files
    and a config.json of the catalog entry; registered, then served by a
    TorchBackend built over the name alone (the loader, the checkpoint's
    own tokenizer and chat template); the loaded weights and logits held
    bit for bit against the exported model's; then two tiny checkpoints
    on the card and the CPU. The launch counts are zeroed before the
    backend's build and read after its rounds."""
    from quoracle_tpu_torch.models import loader
    from quoracle_tpu_torch.models.make_checkpoint import (
        make_tokenizer_files,
    )
    t_phase = time.monotonic()
    src = backend.engines[MODEL]
    cfg = src.cfg
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    report = {"phase": "ckpt", "model": MODEL, "layers": cfg.n_layers}
    orig_load = R.loader.load_params
    ckpt_backend = None
    try:
        base = os.path.join(root, "base")
        os.makedirs(base)
        ids = make_tokenizer_files(base, cfg.vocab_size)
        with open(os.path.join(base, "config.json"), "w") as f:
            json.dump(hf_config(cfg, ids), f, indent=1)
        with open(os.path.join(base, "config.json")) as f:
            back = loader.config_from_hf(json.load(f), CKPT_MODEL)
        wrong = [k for k in CONFIG_FIELDS
                 if getattr(back, k) != getattr(cfg, k)]
        if wrong:
            raise AssertionError(f"config.json gives back other {wrong}")

        t0 = time.monotonic()
        out = loader.export_hf_checkpoint(src.params, cfg,
                                          os.path.join(root, "ckpt"), base)
        report["export_s"] = time.monotonic() - t0
        nbytes = os.path.getsize(os.path.join(out, "model.safetensors"))
        report["bytes_written"] = nbytes
        spec = f"xla:{loader.register_hf_checkpoint(out, CKPT_MODEL).name}"

        loads = []

        def timed_load(*a, **kw):
            t = time.monotonic()
            model = orig_load(*a, **kw)
            torch.cuda.synchronize()
            loads.append(time.monotonic() - t)
            return model
        R.loader.load_params = timed_load
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        ckpt_backend = R.TorchBackend([spec], seed=0)
        torch.cuda.synchronize()
        report["init_s"] = time.monotonic() - t0
        R.loader.load_params = orig_load
        if len(loads) != 1:
            raise AssertionError(f"the backend loaded {len(loads)} times")
        report["load_s"] = loads[0]
        report["load_gb_per_s"] = nbytes / loads[0] / 1e9
        eng = ckpt_backend.engines[spec]
        tok = type(eng.tokenizer).__name__
        if tok != "HFAutoTokenizer":
            raise AssertionError(f"the checkpoint serves a {tok}")
        rounds, results, _ = run_rounds(R, ckpt_backend, spec, TEMPS,
                                        MAX_TOKENS, N_RULES)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        if min(launches["flash_fwd"], launches["ragged_fwd"]) <= 0:
            raise AssertionError(f"the checkpoint missed a kernel: "
                                 f"{launches}")
        check_rounds(rounds, results, dfa, long_min=256)
        report.update(launches=launches, rounds=rounds,
                      texts=[r.text[:48] for r in results[0]])
        report["round2"] = round2_compare({
            "checkpoint": rounds[1],
            "random (serve phase)": serve_report["rounds"][1]})

        # every leaf bit for bit, then one sequence's logits
        got = eng.params.state_dict()
        for name, t in src.params.state_dict().items():
            if not torch.equal(got[name], t):
                raise AssertionError(f"loaded {name} differs from the "
                                     f"exported weight")
        seq = src.tokenizer.encode_chat(
            chat("summarize the rules above in one line", N_RULES + 6))
        a = dense_logits(torch, src.params, cfg, seq)
        b = dense_logits(torch, eng.params, eng.cfg, seq)
        if not torch.equal(a, b):
            raise AssertionError(
                f"logits differ: max {float((a - b).abs().max())}")
        report["logits"] = {"tokens": len(seq), "identical": True}
        del a, b, got, eng
        ckpt_backend.close()
        ckpt_backend = None
        torch.cuda.empty_cache()
        report["tiny"] = ckpt_tiny_rounds(torch, R, root)
    finally:
        R.loader.load_params = orig_load
        if ckpt_backend is not None:
            ckpt_backend.close()
        del ckpt_backend
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    report["seconds"] = time.monotonic() - t_phase
    return report


REFERENCE_TIERS = {
    # (int8 weights and pages, engine attributes)
    # the unified kernel (the card's default; forced on the CPU)
    "unified": (False, dict(unified_min_tokens=0)),
    # the direct tier's two kernels, unified off
    "direct": (False, dict(unified_min_tokens=1 << 30,
                           direct_decode_min_tokens=0,
                           direct_prefill_min_tokens=0)),
    # the gather tier (the JAX engine's seam)
    "gather": (False, dict(_force_gather_decode=True)),
    # int8: the int8 ragged kernel, then the dequantizing gather tier
    "int8_unified": (True, dict(unified_min_tokens=0)),
    "int8_gather": (True, dict(_force_gather_decode=True)),
}


def share_tables(engines: list, tables: dict, enum) -> None:
    """Engines of one tokenizer build the JSON grammar ``enum``'s host
    table once: the first engine that needs it builds it into ``tables``,
    the others take it from there and make only their device copy."""
    key = ("one", enum)
    for eng in engines:
        if key not in tables:
            eng._json_table_device((enum,))
            tables[key] = eng._json_cache[key]
        eng._json_cache[key] = tables[key]


def phase_reference(torch, R) -> dict:
    """The same traffic, greedy, through a 1-layer fp32 cut of llama-3-8b
    on the GPU (kernels) and on the CPU (plain twins), one set of
    weights, on each paged tier in turn (one float and one int8 engine,
    both ``quantize_weights`` and ``quantize_kv``, per device): the
    texts, token counts and cached-token counts must agree. Each
    engine's first tier (unified) runs the full traffic (round 1, the
    sessionless row on the float engine, the resumed round 2); each tier
    after it runs one more resumed round over the sessions the tier
    before left, so every tier's resume path runs on both devices."""
    from quoracle_tpu_torch.models import config as C
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.tokenizer import get_tokenizer
    cfg = C.register_model(dataclasses.replace(
        C.get_model_config(MODEL), name=f"llama-3-8b-{CPU_CUT_LAYERS}layer",
        n_layers=CPU_CUT_LAYERS))
    spec = f"xla:{cfg.name}"
    out = {}
    t0 = time.monotonic()
    cut = dict(zip(("cuda", "cpu"), fp32_cut(torch, cfg, 1, cpu_copy=True)))
    setup_s = {"cut": time.monotonic() - t0}
    tables: dict = {}
    for dev in ("cuda", "cpu"):
        t0 = time.monotonic()
        hist = {}
        params = cut.pop(dev)
        backends = {quant: R.TorchBackend([spec], device=dev, engines={
            spec: GenerateEngine(cfg, params, get_tokenizer(spec),
                                 device=dev, quantize_weights=quant,
                                 quantize_kv=quant)})
            for quant in (False, True)}
        share_tables([b.engines[spec] for b in backends.values()], tables,
                     None)
        setup_s[dev] = time.monotonic() - t0
        for tier, (quant, attrs) in REFERENCE_TIERS.items():
            backend = backends[quant]
            eng = backend.engines[spec]
            eng.unified_min_tokens = eng.direct_decode_min_tokens = \
                eng.direct_prefill_min_tokens = 1 << 30
            eng._force_gather_decode = False
            for k, v in attrs.items():
                setattr(eng, k, v)
            t0 = time.monotonic()
            if quant not in hist:
                rounds, results, hist[quant] = run_rounds(
                    R, backend, spec, [0.0] * 3,
                    max_tokens=REFERENCE_TOKENS, n_rules=8,
                    sessionless=tier == "unified")
            else:
                summary, res = consensus_round(
                    R, backend, spec, hist[quant], [0.0] * 3,
                    REFERENCE_TOKENS)
                rounds, results = [summary], [res]
                hist[quant] = [
                    h + [{"role": "assistant", "content": r.text},
                         {"role": "user", "content": "refine again"}]
                    for h, r in zip(hist[quant], res)]
            out[(dev, tier)] = {
                "s": time.monotonic() - t0, "rounds": rounds,
                "texts": [[r.text for r in res] for res in results],
                "tokens": [[r.usage.completion_tokens for r in res]
                           for res in results]}
        del backends, params
    report = {"phase": "reference", "model": spec, "dtype": "float32",
              "setup_s": setup_s, "tiers": {}}
    bad = []
    for tier in REFERENCE_TIERS:
        g, c = out[("cuda", tier)], out[("cpu", tier)]
        same = all(g[k] == c[k] for k in ("texts", "tokens")) and all(
            a["cached_tokens"] == b["cached_tokens"]
            for a, b in zip(g["rounds"], c["rounds"]))
        row = {"identical": same, "gpu_s": g["s"], "cpu_s": c["s"],
               "rounds": len(g["rounds"]),
               "cached_tokens": g["rounds"][-1]["cached_tokens"],
               "new_tokens": g["tokens"]}
        if tier == "unified":
            row["sessionless_prompt_tokens"] = \
                g["rounds"][0]["sessionless"]["prompt_tokens"]
        if min(g["rounds"][-1]["cached_tokens"]) <= 0:
            raise AssertionError(f"{tier}: its resumed round resumed "
                                 f"nothing: {row}")
        if not same:
            row.update(gpu_texts=g["texts"], cpu_texts=c["texts"])
            bad.append(tier)
        report["tiers"][tier] = row
    report["identical"] = not bad
    if bad:
        emit(report)
        raise AssertionError(f"GPU and CPU engines disagree on {bad}")
    report["decide"] = reference_decide(torch, R)
    return report


def decide_view(out) -> dict:
    """What two devices' decides must agree on: status, decision, rounds,
    cached tokens and every member's texts."""
    return {"status": out.status, "rounds_used": out.rounds_used,
            "decision": (None if out.decision is None
                         else dataclasses.asdict(out.decision)),
            "cached_tokens": out.cached_tokens,
            "completion_tokens": out.completion_tokens,
            "proposals": [[p.model_spec, p.raw_text] for p in out.proposals],
            "failures": [[f.model_spec, f.kind, f.error, f.raw_text]
                         for f in out.failures],
            "refinement_history": out.refinement_history}


def text_of_tokens(tok, lo: int, hi: int) -> str:
    """A deterministic text of lo..hi tokens (one embedder T bucket)."""
    words = []
    while len(tok.encode(" ".join(words))) < lo:
        words.append(f"step{len(words)} waits")
    text = " ".join(words)
    if not lo <= len(tok.encode(text)) <= hi:
        raise AssertionError(f"no text of {lo}..{hi} tokens")
    return text


def reference_decide(torch, R) -> dict:
    """The decide phase's two decides, greedy and small (one refinement
    round at most, REFERENCE_DECIDE_TOKENS new tokens), through fp32 cuts
    of the three members (REFERENCE_DECIDE_LAYERS layers, full width) on
    the GPU (kernels) and on the CPU (plain twins), one set of
    weights (``fp32_cut``: drawn on the card, copied to the CPU), the
    unified tier on both, members served in turn:
    identical outcomes. Then the
    embedder (llama's cut) on one text per T bucket, 8, 64 and 256 tokens
    (flash on the card): vectors within 1e-5. A decide never samples at
    temperature 0 by itself, so the port's engine module's
    ``temperature_for_round`` points at 0.0 for this phase only."""
    import numpy as np
    from quoracle_tpu_torch.consensus import engine as CE
    from quoracle_tpu_torch.models import config as C
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.tokenizer import get_tokenizer
    pool = []
    for spec in DECIDE_POOL:
        base = C.get_model_config(spec)
        pool.append("xla:" + C.register_model(dataclasses.replace(
            base, name=f"{base.name}-{REFERENCE_DECIDE_LAYERS}layer",
            n_layers=REFERENCE_DECIDE_LAYERS)).name)
    tok = get_tokenizer(pool[0])
    texts = {T: text_of_tokens(tok, lo, T)
             for T, lo in ((8, 1), (64, 33), (256, 129))}
    params = {spec: dict(zip(("cuda", "cpu"), fp32_cut(
        torch, C.get_model_config(spec), i + 1, cpu_copy=True)))
        for i, spec in enumerate(pool)}
    runs = {}
    tables: dict = {}
    orig = CE.temperature_for_round
    CE.temperature_for_round = lambda *a, **kw: 0.0
    try:
        for dev in ("cuda", "cpu"):
            engines = {}
            for i, spec in enumerate(pool):
                eng = GenerateEngine(C.get_model_config(spec),
                                     params[spec][dev], get_tokenizer(spec),
                                     seed=i, device=dev)
                eng.unified_min_tokens = 0    # the CPU default is gather
                share_tables([eng], tables.setdefault(spec, {}), ("wait",))
                engines[spec] = eng
            # members in turn: this phase compares the devices, and the
            # decide phase drives the overlap default; three members
            # building their grammar tables at once on host threads took
            # 42 s here against 12 s in turn (an H100 run)
            backend = R.TorchBackend(pool, device=dev, engines=engines,
                                     overlap=False)
            t0 = time.monotonic()
            outcomes, records = run_decides(
                R, CE, backend, pool, max_tokens=REFERENCE_DECIDE_TOKENS,
                max_refinement_rounds=1)
            t1 = time.monotonic()
            vecs = {T: backend.embed([t])[0] for T, t in texts.items()}
            runs[dev] = {"s": t1 - t0, "embed_s": time.monotonic() - t1,
                         "round_s": [r["round_s"] for r in records],
                         "grammar_s": [r["grammar_s"] for r in records],
                         "views": [decide_view(o) for o in outcomes],
                         "tiers": [r["tiers"] for r in records],
                         "vecs": vecs}
            del backend, engines
    finally:
        CE.temperature_for_round = orig
    del params
    torch.cuda.empty_cache()
    g, c = runs["cuda"], runs["cpu"]
    errs = {T: float(np.abs(g["vecs"][T] - c["vecs"][T]).max())
            for T in texts}
    report = {"pool": pool, "identical": g["views"] == c["views"],
              "gpu_s": g["s"], "cpu_s": c["s"],
              "round_s": {"gpu": g["round_s"], "cpu": c["round_s"]},
              "grammar_s": {"gpu": g["grammar_s"], "cpu": c["grammar_s"]},
              "embed_s": {"gpu": g["embed_s"], "cpu": c["embed_s"]},
              "tiers": g["tiers"],
              "decides": [{k: v[k] for k in ("status", "rounds_used",
                                             "cached_tokens")}
                          for v in g["views"]],
              "decisions": [v["decision"] and v["decision"]["action"]
                            for v in g["views"]],
              "embed_max_abs_err": errs}
    if not report["identical"] or max(errs.values()) > 1e-5:
        report.update(gpu_views=g["views"], cpu_views=c["views"])
        emit({"phase": "reference", "decide": report})
        raise AssertionError("GPU and CPU decides or embeddings disagree")
    return report


# -- the tiers phase ---------------------------------------------------------

# a tiered session's prompt: with its new tokens, 24 pages of 128; six of
# them ask 144 pages of the bf16 engine's 2 GiB pool (128 usable pages)
TIER_PROMPT = 3000
TIER_SESSIONS = 6
TIER_POOL_PAGES = 128
TIER_NEW = 8                # new tokens of each session's first round
TIER_RESUME_NEW = 32        # new tokens of the resumed round
TIER_SUFFIX = 20            # tokens the resumed round appends
# the int8 round trip: three such sessions against a 64-page int8 pool
TIER_Q8_SESSIONS = 3
TIER_Q8_PAGES = 64
TIER_DISK_PROMPT = 2000     # the restart-warm prompt: 15 full blocks
TIER_HANDOFF_PROMPT = 1000
TIER_RULES = 30             # the backend part's chat prompt (~770 tokens)


def tier_prompt(seed: int, n: int, vocab: int) -> list:
    """``n`` token ids drawn from a seeded generator (distinct sessions
    share no prefix, so the pool holds each in pages of its own)."""
    import numpy as np
    return [int(t) for t in np.random.default_rng(seed).integers(
        3, min(vocab, 100_000), n)]


def tier_pools(st) -> list:
    return [st.k, st.v] + ([st.k_scale, st.v_scale]
                           if st.k_scale is not None else [])


def synced_ms(torch, fn):
    """``fn()`` and its wall ms, the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.monotonic() - t0) * 1e3


class TierSpy:
    """Times a TierManager's byte movers on the card (synchronized before
    and after each): ``_gather_host`` (pool pages to host tensors: the
    demote's copy) and ``_scatter_device`` (host tensors into pool pages:
    the restore's page-in); and keeps a clone, on the card, of the pages a
    demote of ``watch`` copied, so that the restore of ``watch`` is held
    bit for bit against it."""

    def __init__(self, torch, tier, watch: str):
        self.torch, self.tier, self.watch = torch, tier, watch
        self.gathers, self.scatters, self.restores = [], [], []
        self.snapshot = None
        self.restored_equal = None
        self.orig = {n: getattr(tier, n) for n in (
            "_gather_host", "_scatter_device", "demote_session",
            "restore_session")}
        tier._gather_host = self._gather
        tier._scatter_device = self._scatter
        tier.demote_session = self._demote
        tier.restore_session = self._restore

    @staticmethod
    def _nbytes(arrays) -> int:
        return sum(a.numel() * a.element_size() for a in arrays
                   if a is not None)

    def _gather(self, pages):
        out, ms = synced_ms(self.torch,
                            lambda: self.orig["_gather_host"](pages))
        self.gathers.append({"pages": len(pages), "ms": ms,
                             "bytes": self._nbytes(out)})
        return out

    def _scatter(self, pages, *arrays):
        _, ms = synced_ms(self.torch, lambda: self.orig["_scatter_device"](
            pages, *arrays))
        self.scatters.append({"pages": len(pages), "ms": ms,
                              "bytes": self._nbytes(arrays)})

    def _demote(self, key, sess):
        if key == self.watch and self.snapshot is None:
            idx = self.torch.tensor([p for p in sess.pages if p],
                                    device=self.tier.store.k.device)
            self.snapshot = [x.index_select(1, idx).clone()
                             for x in tier_pools(self.tier.store)]
        return self.orig["demote_session"](key, sess)

    def _restore(self, key):
        sess, ms = synced_ms(self.torch,
                             lambda: self.orig["restore_session"](key))
        self.restores.append({"key": key, "ms": ms,
                              "ok": sess is not None})
        if key == self.watch and sess is not None and self.snapshot:
            idx = self.torch.tensor([p for p in sess.pages if p],
                                    device=self.tier.store.k.device)
            self.restored_equal = all(
                self.torch.equal(x.index_select(1, idx), snap)
                for x, snap in zip(tier_pools(self.tier.store),
                                   self.snapshot))
        return sess

    def remove(self) -> None:
        for n, f in self.orig.items():
            setattr(self.tier, n, f)

    @staticmethod
    def rate(moves: list) -> list:
        return [{**m, "gb_s": m["bytes"] / m["ms"] / 1e6} for m in moves]


def tier_engine(base, params, **kw):
    from quoracle_tpu_torch.models.generate import GenerateEngine
    eng = GenerateEngine(base.cfg, params, base.tokenizer, seed=0,
                         device="cuda", **kw)
    eng.prefix_sharing = False      # each session in pages of its own
    return eng


def hibernate_all(eng) -> None:
    """The eviction ladder over every resident session: demand all usable
    pages (no key protected), then give them back."""
    st = eng.sessions
    with eng._paged_lock, st.lock:
        got = st.alloc(st.n_pages - 1)
        if got is None:
            raise AssertionError("hibernate: the pool could not be emptied")
        st._release(got)


def tier_round_trip(torch, P, base, params, label: str, n_sessions: int,
                    pool_pages, quant: bool, kept: dict) -> dict:
    """Hibernate and restore at full width: ``n_sessions`` distinct
    sessions of TIER_PROMPT tokens on a tiered engine whose pool holds
    ``pool_pages`` pages push the first one
    (the LRU victim) to host memory; its resumed round (TIER_SUFFIX more
    tokens, TIER_RESUME_NEW new) restores it by page-in. A control engine
    over the same weights, whose pool never evicts, runs the same two
    rounds: equal tokens and cached counts, the restored pages (and int8
    scales) bit-identical to the demoted ones, no restore failure. Then
    the control re-prefills the same resumed round with its session
    dropped (tiers off), and the host copies are timed pinned (the
    default on the card) against pageable on the same pages."""
    from quoracle_tpu_torch.models.quant import kv_token_bytes
    from quoracle_tpu_torch.serving.kvtier import TierManager
    cfg = base.cfg
    q8 = dict(quantize_weights=True, quantize_kv=True) if quant else {}
    rate = kv_token_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                          1 if quant else 2, quant)
    page = 128
    page_bytes = rate * page
    sess_pages = -(-(TIER_PROMPT + TIER_NEW) // page)
    eng = tier_engine(base, params, session_max_bytes=pool_pages * page_bytes,
                      **q8)
    if (eng.sessions.n_pages - 1 != pool_pages
            or n_sessions * sess_pages <= pool_pages):
        raise AssertionError(f"{label}: {n_sessions} sessions of "
                             f"{sess_pages} pages fit the pool")
    demote_bytes = sess_pages * page_bytes
    # the host budget holds every session the run demotes (the JAX
    # default of 256 MiB would drop a 24-page session at this width)
    host_mb = -(-(n_sessions * demote_bytes) // (1 << 20))
    tier = eng.attach_tier(host_mb=host_mb)
    ctl = tier_engine(base, params,
                      session_max_bytes=(n_sessions + 2) * sess_pages
                      * page_bytes, **q8)
    vocab = base.cfg.vocab_size
    prompts = [tier_prompt(100 + i, TIER_PROMPT, vocab)
               for i in range(n_sessions)]
    sids = [f"{label}-{i}" for i in range(n_sessions)]
    spy = TierSpy(torch, tier, sids[0])

    def one(e, prompt, sid, n):
        return e.generate([prompt], temperature=0.0, max_new_tokens=n,
                          session_ids=[sid])[0]

    try:
        t0 = time.monotonic()
        first = [one(eng, p, s, TIER_NEW) for p, s in zip(prompts, sids)]
        fill_s = time.monotonic() - t0
        if not tier.has_session(sids[0]) or eng.sessions.get(sids[0]):
            raise AssertionError(f"{label}: the LRU session was not demoted: "
                                 f"{tier.stats()}")
        host_after_demote = tier.host.stats()
        c1 = one(ctl, prompts[0], "ctl", TIER_NEW)
        if c1.token_ids != first[0].token_ids:
            raise AssertionError(f"{label}: round 1 differs from the control")
        resumed = (prompts[0] + first[0].token_ids
                   + tier_prompt(999, TIER_SUFFIX, vocab))
        c2 = one(ctl, resumed, "ctl", TIER_RESUME_NEW)
        ctl_prefill_ms = ctl.last_prefill_s * 1e3
        orig = P.ragged_attend
        P.ragged_attend = ragged_recorder(torch, P, kept, lambda: True)
        try:
            r2 = one(eng, resumed, sids[0], TIER_RESUME_NEW)
            torch.cuda.synchronize()
        finally:
            P.ragged_attend = orig
        resumed_prefill_ms = eng.last_prefill_s * 1e3
        restores = list(spy.restores)
        page_in = [s for s in spy.scatters if s["pages"] > 1]
        demotes = [g for g in spy.gathers if g["pages"] > 1]
    finally:
        spy.remove()
    stats = tier.stats()
    ok = (r2.token_ids == c2.token_ids
          and r2.n_cached_tokens == c2.n_cached_tokens > 0
          and stats["restored_sessions"] >= 1
          and stats["restore_failures"] == 0
          and spy.restored_equal is True and page_in and demotes)
    report = {
        "pool_pages": eng.sessions.n_pages - 1, "page_bytes": page_bytes,
        "host_kv_mb": host_mb, "sessions": n_sessions,
        "prompt_tokens": TIER_PROMPT, "fill_s": fill_s,
        "host_after_demote": host_after_demote,
        "demoted_entry_survived": host_after_demote["sessions"] >= 1,
        "demotes": TierSpy.rate(demotes), "page_ins": TierSpy.rate(page_in),
        "restores": restores,
        "resumed_prefill_ms_with_restore": resumed_prefill_ms,
        "tokens_equal": r2.token_ids == c2.token_ids,
        "cached_tokens": r2.n_cached_tokens,
        "control_cached_tokens": c2.n_cached_tokens,
        "control_resumed_prefill_ms": ctl_prefill_ms,
        "restored_pages_bit_identical": spy.restored_equal,
        "tier": stats}
    if not ok:
        emit({"phase": "tiers", label: report})
        raise AssertionError(f"{label}: the restore did not match the control")
    # tiers off: the same resumed round on the control, its session gone
    # (one chunk of every token: its bf16 sums may round otherwise than
    # the 20-token chunk's, so its tokens are recorded, not held)
    ctl.drop_session("ctl")
    r_re = one(ctl, resumed, "ctl", TIER_RESUME_NEW)
    report["reprefill_ms_tiers_off"] = ctl.last_prefill_s * 1e3
    report["reprefill_tokens"] = ctl.last_prefill_tokens
    report["reprefill_tokens_equal"] = r_re.token_ids == c2.token_ids
    if r_re.n_cached_tokens != 0:
        raise AssertionError(f"{label}: the re-prefill reused KV")
    # pinned (the default) against pageable host buffers, in turns, on a
    # session's worth of free pages; the first of each kind allocates its
    # host buffers, later ones reuse the freed ones
    del ctl
    for sid in sids:
        eng.drop_session(sid)
    st = eng.sessions
    pages = st.alloc(sess_pages, evict=False)
    copies = []
    default_pin = tier.pin_memory
    for pin in (False, True, True, False, False, True):
        tier.pin_memory = pin
        out, d2h = synced_ms(torch, lambda: TierManager._gather_host(
            tier, pages))
        _, h2d = synced_ms(torch, lambda: TierManager._scatter_device(
            tier, pages, *out))
        copies.append({"pinned": pin, "d2h_ms": d2h, "h2d_ms": h2d,
                       "bytes": TierSpy._nbytes(out)})
        del out
    tier.pin_memory = default_pin
    st.release(pages)
    report["host_copies"] = copies
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return report


def tier_disk(torch, base) -> dict:
    """Restart-warm prefixes: engine A (prefix sharing on, a disk store in
    a fresh directory under build/) serves one long prompt, then the same
    prompt under a second session (which adopts the first one's cached
    blocks: the computation B will run), and drains its spills; engine B,
    new, over the same weights and directory, serves the prompt: its
    cached tokens cover every full block, its restored prefix pages are
    those blocks, its tokens those of A's second row. The directory is
    removed at the end."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    root = os.path.join(REPO, "build", "tiers_disk")
    shutil.rmtree(root, ignore_errors=True)
    prompt = tier_prompt(7, TIER_DISK_PROMPT, base.cfg.vocab_size)
    blocks = (len(prompt) - 1) // 128
    try:
        def engine():
            e = GenerateEngine(base.cfg, base.params, base.tokenizer, seed=0,
                               device="cuda",
                               session_max_bytes=512 << 20)
            return e, e.attach_tier(host_mb=256, disk_dir=root)

        a, ta = engine()
        saves = []
        orig_save = ta.disk.save

        def timed_save(*args):
            t0 = time.monotonic()
            ok = orig_save(*args)
            saves.append((time.monotonic() - t0) * 1e3)
            return ok
        ta.disk.save = timed_save
        ra0 = a.generate([prompt], temperature=0.0,
                         max_new_tokens=TIER_NEW, session_ids=["disk-a0"])[0]
        a_cold_ms = a.last_prefill_s * 1e3
        _, flush_ms = synced_ms(torch, ta.flush_spills)
        ra = a.generate([prompt], temperature=0.0, max_new_tokens=TIER_NEW,
                        session_ids=["disk-a"])[0]
        a_warm_ms = a.last_prefill_s * 1e3
        if ra.n_cached_tokens != blocks * 128:
            raise AssertionError(f"tiers: A's second row reused "
                                 f"{ra.n_cached_tokens} tokens")
        files = sorted(f for f in os.listdir(ta.disk.dir)
                       if f.endswith(".npz"))
        nbytes = sum(os.path.getsize(os.path.join(ta.disk.dir, f))
                     for f in files)
        del a, ta
        gc.collect()
        torch.cuda.empty_cache()
        b, tb = engine()
        loads = []
        orig_load = tb.disk.load

        def timed_load(key, tokens):
            t0 = time.monotonic()
            out = orig_load(key, tokens)
            loads.append((time.monotonic() - t0) * 1e3)
            return out
        tb.disk.load = timed_load
        rb, b_ms = synced_ms(torch, lambda: b.generate(
            [prompt], temperature=0.0, max_new_tokens=TIER_NEW,
            session_ids=["disk-b"])[0])
        stats = tb.stats()
        report = {
            "dir": os.path.relpath(root, REPO), "prompt_tokens": len(prompt),
            "full_blocks": blocks, "files": len(files),
            "bytes_written": nbytes, "write_s": sum(saves) / 1e3,
            "writes": len(saves), "flush_ms": flush_ms,
            "load_ms_per_block": loads,
            "a_cold_prefill_ms": a_cold_ms,
            "a_resident_prefix_prefill_ms": a_warm_ms,
            "b_round_ms": b_ms, "b_prefill_ms": b.last_prefill_s * 1e3,
            "b_prefill_tokens": b.last_prefill_tokens,
            "cached_tokens": rb.n_cached_tokens,
            "tokens_equal": rb.token_ids == ra.token_ids,
            "tokens_equal_a_cold": rb.token_ids == ra0.token_ids,
            "restored_prefix_pages": stats["restored_prefix_pages"],
            "disk": stats["disk"]}
        del b, tb
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["dir_removed"] = not os.path.exists(root)
    if not (report["tokens_equal"] and report["files"] >= blocks
            and rb.n_cached_tokens == blocks * 128
            and report["restored_prefix_pages"] == blocks
            and report["dir_removed"]):
        emit({"phase": "tiers", "disk": report})
        raise AssertionError("tiers: the restart did not warm from disk")
    return report


def tier_handoff(torch, base, int8_engine) -> dict:
    """Two engines over one set of weights: a one-token prefill on A,
    ``KVHandoff.export`` from A and ``adopt`` into B; B's continuation
    must give the tokens of a control engine continuing its own prefill.
    A bf16 engine's envelope must be refused by the int8-KV engine
    (reason "signature"), nothing landing in its tier."""
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.serving.handoff import HandoffError, KVHandoff

    def engine(tiered: bool):
        e = GenerateEngine(base.cfg, base.params, base.tokenizer, seed=0,
                           device="cuda", session_max_bytes=512 << 20)
        if tiered:
            e.attach_tier(host_mb=256)
        return e

    a, b, c = engine(True), engine(True), engine(False)
    prompt = tier_prompt(11, TIER_HANDOFF_PROMPT, base.cfg.vocab_size)

    def one(e, p, n):
        return e.generate([p], temperature=0.0, max_new_tokens=n,
                          session_ids=["h"])[0]

    c1 = one(c, prompt, 1)
    c2 = one(c, prompt + c1.token_ids, 24)
    a1 = one(a, prompt, 1)
    ho = KVHandoff()
    env, export_ms = synced_ms(torch, lambda: ho.export(a, "h", MODEL))
    _, adopt_ms = synced_ms(torch, lambda: ho.adopt(b, env))
    prefetched = b.sessions.get("h") is not None
    b2 = one(b, prompt + a1.token_ids, 24)
    ok = (a1.token_ids == c1.token_ids and b2.token_ids == c2.token_ids
          and b2.n_cached_tokens == c2.n_cached_tokens > 0 and prefetched
          and b.sessions.tier.restored_sessions == 1)
    # a bf16 envelope into the int8-KV engine: refused before any byte
    a.generate([prompt], temperature=0.0, max_new_tokens=1,
               session_ids=["rej"])
    env2 = ho.export(a, "rej", MODEL)
    before = int8_engine.sessions.tier.host.stats()
    try:
        ho.adopt(int8_engine, env2)
        reason = None
    except HandoffError as e:
        reason = e.reason
    landed = (int8_engine.sessions.tier.has_session("rej")
              or int8_engine.sessions.get("rej") is not None
              or int8_engine.sessions.tier.host.stats() != before)
    report = {"prompt_tokens": len(prompt), "envelope_tokens": env.n_tokens,
              "envelope_bytes": env.entry.nbytes, "export_ms": export_ms,
              "adopt_ms": adopt_ms, "prefetched_on_adopt": prefetched,
              "tokens_equal": b2.token_ids == c2.token_ids,
              "cached_tokens": b2.n_cached_tokens,
              "control_cached_tokens": c2.n_cached_tokens,
              "reject_reason": reason, "reject_landed_bytes": landed,
              "signatures": [a.kv_signature(), int8_engine.kv_signature()],
              "ledger": ho.stats()}
    del a, b, c
    gc.collect()
    torch.cuda.empty_cache()
    if not ok or reason != "signature" or landed:
        emit({"phase": "tiers", "handoff": report})
        raise AssertionError("tiers: the handoff failed its checks")
    return report


def tier_backend(torch, R, base) -> dict:
    """The backend: ``TorchBackend(host_kv_mb=..., continuous=True)`` over
    an engine on the serve phase's weights. An agent's second round goes
    to its hibernated session: the continuous batcher's submit prefetches
    it (or, if the loop holds the engine, its lookup restores it), and
    the row's cached tokens show the restore; ``prefetch_sessions``
    restores it again after a second hibernation; ``kv_stats`` is on, and
    the effective headroom is at least the raw one while pages are
    demotable."""
    from quoracle_tpu_torch.infra.resources import (
        effective_headroom_fraction, headroom_fraction, reclaimable_kv_bytes,
    )
    from quoracle_tpu_torch.models.generate import GenerateEngine
    eng = GenerateEngine(base.cfg, base.params, base.tokenizer, seed=0,
                         device="cuda", session_max_bytes=512 << 20)
    backend = R.TorchBackend([MODEL], device="cuda", engines={MODEL: eng},
                             host_kv_mb=512, continuous=True)
    tier = eng.sessions.tier
    prefetches = []
    orig = eng.prefetch_session

    def spy(sid):
        out = orig(sid)
        prefetches.append(out)
        return out
    eng.prefetch_session = spy
    sid = "tier-agent"
    hist = chat("pick the next action", TIER_RULES)
    try:
        (r1,) = backend.query([R.QueryRequest(
            MODEL, hist, temperature=0.0, max_tokens=16, session_id=sid)])
        hibernate_all(eng)
        hibernated = tier.has_session(sid)
        hist2 = hist + [{"role": "assistant", "content": r1.text},
                        {"role": "user", "content": "refine your proposal"}]
        (r2,) = backend.query([R.QueryRequest(
            MODEL, hist2, temperature=0.0, max_tokens=16, session_id=sid)])
        restored_round = tier.restored_sessions
        reclaim = reclaimable_kv_bytes(backend)
        raw, eff = headroom_fraction(), effective_headroom_fraction(backend)
        hibernate_all(eng)
        warmed = backend.prefetch_sessions(sid)
        stats = backend.kv_stats()
    finally:
        eng.prefetch_session = orig
        backend.close()
    report = {"rows_ok": [r1.ok, r2.ok], "cached_tokens": [
        r1.cached_tokens, r2.cached_tokens], "hibernated": hibernated,
        "prefetch_at_submit": prefetches,
        "restored_by_round_2": restored_round,
        "prefetch_sessions": warmed, "kv_stats_enabled": stats["enabled"],
        "reclaimable_bytes": reclaim, "headroom_raw": raw,
        "headroom_effective": eff, "tier": tier.stats()}
    del backend, eng
    gc.collect()
    torch.cuda.empty_cache()
    if not (r1.ok and r2.ok and hibernated and r2.cached_tokens > 0
            and restored_round == 1 and warmed == 1 and stats["enabled"]
            and reclaim > 0 and eff >= raw
            and report["tier"]["restore_failures"] == 0):
        emit({"phase": "tiers", "backend": report})
        raise AssertionError("tiers: the backend failed its checks")
    return report


def phase_tiers(torch, R, P, kernels, backend) -> dict:
    """Tiered KV and the handoff on the card at llama-3-8b full width over
    the backend's bf16 weights: (a) hibernate and restore, (b) restart-
    warm prefixes from disk, (c) hibernate and restore over int8 pools,
    (d) the handoff, (e) the backend. The launch counts are zeroed before
    (a) and read after (e); the kept inputs of the resumed rounds' ragged
    ticks are then held against the twins."""
    from quoracle_tpu_torch.models.quant import quantize_params
    base = backend.engines[MODEL]
    t_phase = time.monotonic()
    report = {"phase": "tiers", "model": MODEL}
    kept = {"ragged_fwd": {}, "ragged_q8_fwd": {}}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    report["bf16"] = tier_round_trip(torch, P, base, base.params, "bf16",
                                     TIER_SESSIONS, TIER_POOL_PAGES, False,
                                     kept["ragged_fwd"])
    report["disk"] = tier_disk(torch, base)
    q_params, q_s = synced_ms(torch, lambda: quantize_params(base.params,
                                                             base.cfg))
    report["int8_quantize_ms"] = q_s
    report["int8"] = tier_round_trip(torch, P, base, q_params, "int8",
                                     TIER_Q8_SESSIONS, TIER_Q8_PAGES, True,
                                     kept["ragged_q8_fwd"])
    q_eng = tier_engine(base, q_params, quantize_weights=True,
                        quantize_kv=True, session_max_bytes=256 << 20)
    q_eng.attach_tier(host_mb=64)
    report["handoff"] = tier_handoff(torch, base, q_eng)
    del q_eng, q_params
    gc.collect()
    torch.cuda.empty_cache()
    report["backend"] = tier_backend(torch, R, base)
    torch.cuda.synchronize()
    report["launches"] = kernels.launch_counts()
    report["seconds_before_checks"] = time.monotonic() - t_phase
    if not (report["launches"]["ragged_fwd"]
            and report["launches"]["ragged_q8_fwd"]):
        emit(report)
        raise AssertionError(f"tiers: a kernel of the path never launched: "
                             f"{report['launches']}")
    report["ticks"] = {
        name: {key: ragged_tick_numbers(torch, P, k, *kept[name][key])
               for key in ("decode", "chunk")}
        for name, k in (("ragged_fwd", kernels.RAGGED),
                        ("ragged_q8_fwd", kernels.RAGGED_Q8))}
    if "k_scale" not in kept["ragged_q8_fwd"]["decode"][1]:
        raise AssertionError("tiers: the int8 ticks carry no scales")
    report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return report


def ptxas_entries(log: str) -> list:
    """One entry per compiled kernel of the nvcc log (``--ptxas-options
    =-v``): its (mangled) name, the register line and the stack and spill
    line."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"kernel": ln.split("'")[1], "spill": "", "used": ""}
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            cur["spill"] = ln.strip()
        elif cur is not None and "Used" in ln:
            cur["used"] = ln.split(":", 1)[-1].strip()
    return out


def main(argv) -> int:
    only = None
    phases = ("kernels", "sweep", "decide", "prefix", "calib", "batch",
              "continuous", "spec", "ckpt", "tiers", "obs", "agent",
              "runtime", "web", "cluster", "reference")
    if argv[1:2] == ["--only"] and argv[2:3] and argv[2] in phases:
        only = argv[2]          # env, build, then that phase; no last line
    elif argv[1:]:
        print(f"usage: {argv[0]} [--only {'|'.join(phases)}]",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script checks "
              "the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "quoracle_tpu_torch")):
        print("chip_smoke: quoracle_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.makedirs(os.path.dirname(GATES_FILE), exist_ok=True)
    for path in (GATES_FILE, PINNED_GATES):
        if os.path.exists(path):
            os.remove(path)
    os.environ["QUORACLE_PAGED_CALIB"] = PINNED_GATES
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from quoracle_tpu_torch.models import runtime as R
    from quoracle_tpu_torch.models.constrained import CharDFA
    from quoracle_tpu_torch.ops import flash_attention as F
    from quoracle_tpu_torch.ops import kernels
    from quoracle_tpu_torch.ops import paged_attention as P

    t_start = time.monotonic()
    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    t0 = time.monotonic()
    path, log = kernels.build()
    ptx = ptxas_entries(log)
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "library": os.path.relpath(path, REPO),
          "tensor_core": [e for e in ptx if "_tc_kernel" in e["kernel"]],
          "ptxas": [e for e in ptx if "_tc_kernel" not in e["kernel"]]})

    if only == "sweep":
        emit(phase_sweep(torch, F, P))
        return 0
    if only == "calib":
        emit(phase_calib(torch, F, P, kernels))
        return 0
    if only in ("batch", "continuous"):
        backend = R.TorchBackend([MODEL], seed=0)
        pool_backend, _ = decide_pool_backend(torch, R, backend)
        phase = phase_batch if only == "batch" else phase_continuous
        emit(phase(torch, R, kernels, CharDFA(max_depth=4), backend,
                   pool_backend))
        return 0
    if only == "spec":
        backend = R.TorchBackend([MODEL], seed=0)
        emit(phase_spec(torch, R, kernels, P, backend,
                        [decide_pool_backend(torch, R, backend)[0]]))
        return 0
    if only == "tiers":
        backend = R.TorchBackend([MODEL], seed=0)
        emit(phase_tiers(torch, R, P, kernels, backend))
        return 0
    if only == "obs":
        backend = R.TorchBackend([MODEL], seed=0)
        emit(phase_obs(torch, R, backend,
                       decide_pool_backend(torch, R, backend)[0]))
        return 0
    if only == "agent":
        backend = R.TorchBackend([MODEL], seed=0)
        emit(phase_agent(torch, R, kernels, backend,
                         decide_pool_backend(torch, R, backend)[0]))
        return 0
    if only == "runtime":
        backend = R.TorchBackend([MODEL], seed=0)
        emit(phase_runtime(torch, R, kernels,
                           decide_pool_backend(torch, R, backend)[0]))
        return 0
    if only == "web":
        backend = R.TorchBackend([MODEL], seed=0)
        emit(phase_web(torch, R, kernels,
                       decide_pool_backend(torch, R, backend)[0]))
        return 0
    if only == "cluster":
        backend = R.TorchBackend([MODEL], seed=0)
        emit(phase_cluster(torch, R, kernels,
                           decide_pool_backend(torch, R, backend)[0]))
        return 0
    if only == "reference":
        emit(phase_reference(torch, R))
        return 0
    if only == "ckpt":
        dfa = CharDFA(max_depth=4)
        backend, report, *_ = phase_serve(torch, R, F, P, kernels, dfa)
        emit(report)
        emit(phase_ckpt(torch, R, kernels, dfa, backend, report))
        return 0
    if only in ("decide", "prefix"):
        backend = R.TorchBackend([MODEL], seed=0)
        decide_report, _, pool_backend = phase_decide(torch, R, kernels,
                                                      backend)
        emit(decide_report)
        if only == "prefix":
            emit(phase_prefix(torch, R, kernels, backend, pool_backend))
            return 0
        del pool_backend
        torch.cuda.empty_cache()
        emit({"phase": "reference", "decide": reference_decide(torch, R)})
        return 0
    cases = phase_kernels(torch, F, P)
    emit({"phase": "kernels",
          "kernels": [{"name": k.name, "source": k.source,
                       "status": "ok"} for k in kernels.KERNELS],
          "cases": cases})
    if only == "kernels":
        return 0

    dfa = CharDFA(max_depth=4)
    backend, report, kept, launches, hist = phase_serve(
        torch, R, F, P, kernels, dfa)
    emit(report)
    paged_report, paged_kept, paged_launches = phase_serve_paged(
        torch, R, P, kernels, dfa, backend, report)
    emit(paged_report)
    kept.update(paged_kept)
    int8_report, kept["ragged_q8_fwd"], int8_launches = phase_serve_int8(
        torch, R, P, kernels, dfa, backend, report)
    emit(int8_report)
    decide_report, decide_launches, pool_backend = phase_decide(
        torch, R, kernels, backend)
    emit(decide_report)
    prefix_report = phase_prefix(torch, R, kernels, backend, pool_backend)
    emit(prefix_report)
    emit(phase_batch(torch, R, kernels, dfa, backend, pool_backend))
    continuous_report = phase_continuous(
        torch, R, kernels, dfa, backend, pool_backend,
        baton_decide_ms=[d["latency_ms"] for d in decide_report["decides"]])
    emit(continuous_report)
    emit(phase_obs(torch, R, backend, pool_backend))
    agent_report = phase_agent(torch, R, kernels, backend, pool_backend)
    emit(agent_report)
    runtime_report = phase_runtime(torch, R, kernels, pool_backend)
    emit(runtime_report)
    web_report = phase_web(torch, R, kernels, pool_backend)
    emit(web_report)
    cluster_report = phase_cluster(torch, R, kernels, pool_backend)
    emit(cluster_report)
    # phase_spec releases the decide pool once its decide has run
    pools = [pool_backend]
    del pool_backend
    spec_report = phase_spec(torch, R, kernels, P, backend, pools)
    emit(spec_report)
    torch.cuda.empty_cache()
    launches = {**launches,
                **{k: paged_launches[k] for k in PAGED_KERNELS},
                "ragged_q8_fwd": int8_launches["ragged_q8_fwd"]}
    entries = phase_mainpath(torch, F, P, kernels, kept, launches)
    for e in entries:       # the decide path's own counts, beside them
        e["decide_launches"] = decide_launches[e["name"]]
        e["embed_launches"] = decide_report["embed"]["launches"][e["name"]]
        e["prefix_launches"] = sum(
            r["launches"][e["name"]]
            for r in prefix_report["fanout"]["sharing"])
        e["continuous_launches"] = (
            continuous_report["serve"]["launches"][e["name"]]
            + continuous_report["pool"]["launches"][e["name"]])
        e["spec_launches"] = spec_report["launches"][e["name"]]
        e["agent_launches"] = agent_report["launches"][e["name"]]
        e["runtime_launches"] = runtime_report["launches"][e["name"]]
        e["web_launches"] = web_report["launches"][e["name"]]
        e["cluster_launches"] = cluster_report["launches"][e["name"]]
        if e["name"] == "ragged_fwd":
            e["verify"] = spec_report["verify_ticks"]["ragged_fwd_bf16"]
            e["verify_fp32"] = spec_report["verify_ticks"]["ragged_fwd"]
        elif e["name"] == "ragged_q8_fwd":
            e["verify"] = spec_report["verify_ticks"]["ragged_q8_fwd"]
    emit({"phase": "mainpath", "kernels": entries})
    emit(phase_trace(torch, R, backend, hist))
    ckpt_report = phase_ckpt(torch, R, kernels, dfa, backend, report)
    emit(ckpt_report)
    for e in entries:
        e["ckpt_launches"] = ckpt_report["launches"][e["name"]]
    tiers_report = phase_tiers(torch, R, P, kernels, backend)
    emit(tiers_report)
    for e in entries:
        e["tiers_launches"] = tiers_report["launches"][e["name"]]
    params = layer_view(torch, backend.engines[MODEL].params,
                        depth_cut(MODEL))
    del backend, kept, paged_kept
    torch.cuda.empty_cache()
    emit(phase_calib(torch, F, P, kernels, params))
    del params
    torch.cuda.empty_cache()

    emit(phase_sweep(torch, F, P))

    emit(phase_reference(torch, R))
    emit({"phase": "done", "seconds": time.monotonic() - t_start})
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
