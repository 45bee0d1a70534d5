#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``quoracle_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printing one JSON line (any failure raises, so the script
exits non-zero and never prints its last line):

  env        torch and CUDA versions, the card's name and power limit
  build      nvcc builds the hand-written kernels from
             quoracle_tpu_torch/csrc (one process per source, in parallel)
  kernels    each kernel against its plain PyTorch twin on the card at
             llama-3-8b attention shapes (H=32, KV=8, hd=128, page 128),
             in fp32 and bf16, with each case's tolerance
  serve      TorchBackend(["xla:llama-3-8b"]) at full width and depth,
             random bf16 weights from a seeded generator: a consensus
             round (three sessioned JSON-constrained rows at temperatures
             1.0/0.7/0.0), one long sessionless row as its own query, then
             the resumed round. The launch counts are zeroed just before
             and read just after: both kernels must have run. The inputs
             of the first flash call and of the resumed round's first
             ragged chunk and decode ticks are kept for the next phase.
  mainpath   each kernel against its twin on those kept inputs, timed
             (CUDA events, L2 flushed before every launch) beside its
             bound, the twin's time and, for flash,
             scaled_dot_product_attention's time as a yardstick
  trace      one more resumed round and one more sessionless row, each
             under torch.profiler: wall time, device busy time (the union
             of kernel intervals), idle share, launches, and the kernels
             that take the most device time
  sweep      each kernel's time and bound over the lengths it serves:
             ragged decode ticks over resident lengths, flash over T
  reference  a 2-layer cut of llama-3-8b in fp32: the same rounds through
             the GPU engine (kernels) and through the same weights on the
             CPU (plain twins) must give identical greedy texts

then the card's nvidia-smi line, the kernels JSON line and, last,
``{"ok": true, "device": {...}}``. Every comparison runs with TF32 off
(torch.backends.cuda.matmul.allow_tf32 = False, and cudnn's too). The
script imports torch and the port, never JAX or the JAX package.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

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
TOL = {("flash_fwd", "float32"): (1e-5, 0.0),
       ("flash_fwd", "bfloat16"): (1e-5, 2.0 ** -7),
       ("ragged_fwd", "float32"): (1e-5, 0.0),
       ("ragged_fwd", "bfloat16"): (1e-5, 0.0)}
MAX_TOKENS = 32             # new tokens per row in the serve phase
N_RULES = 30                # system-prompt length of the serve phase
TEMPS = [1.0, 0.7, 0.0]     # the consensus round's member temperatures


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def dtype_name(t) -> str:
    return str(t.dtype).split(".")[-1]


def check(torch, kernel: str, got, ref, what: dict) -> dict:
    """Max abs error of a kernel result against its twin, each element
    held to the tolerance of the kernel and dtype; raises on
    disagreement."""
    diff = (got.float() - ref.float()).abs()
    atol, rtol = TOL[(kernel, what["dtype"])]
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    row = {"kernel": kernel, **what, "max_abs_err": diff.max().item(),
           "atol": atol, "rtol": rtol}
    if not (ok and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{kernel} disagrees with its twin: {row}")
    return row


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Median device time of one launch of ``fn``: each of ``iters``
    launches between its own CUDA events, after a 256 MB write outside
    the events so that every launch finds the 50 MB L2 cold."""
    scrub = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
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


def ragged_work(q, k_pages, tables, meta, tq, window) -> tuple[int, int]:
    import numpy as np
    _, H, hd = q.shape
    KV = k_pages.shape[2]
    tables = tables.cpu().numpy()
    meta = meta.cpu().tolist()               # Python ints: no overflow
    spans: dict = {}
    pairs = 0
    for i, (kv_len, qpos0, nq) in enumerate(meta):
        if nq <= 0:
            continue
        lo = max(0, qpos0 + 1 - window) if window else 0
        spans.setdefault(tables[i].tobytes(), []).append(
            (lo, min(kv_len, qpos0 + nq)))
        for t in range(nq):
            p = qpos0 + t
            pairs += max(0, min(kv_len, p + 1)
                         - (max(0, p + 1 - window) if window else 0))
    keys = 0                       # a row's blocks share its pages
    for ranges in spans.values():
        cover = np.zeros(max(hi for _, hi in ranges), bool)
        for lo, hi in ranges:
            cover[lo:hi] = True
        keys += int(cover.sum())
    es = q.element_size()
    nbytes = (q.numel() * es + q.numel() * 4      # q in, fp32 out
              + 2 * keys * KV * hd * es           # visible K and V slots
              + 4 * (tables.size + 3 * len(meta)))
    return nbytes, 4 * hd * H * pairs


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
        # flash: B=2, T=512, kv_len differing per row, a nonzero offset
        # on row 1 whose first 16 queries sit at position -1 (padding:
        # fully masked, exact zeros), with and without a sliding window
        B, T, S = 2, 512, 576
        q = torch.randn(B, T, H, hd, generator=g, device=dev).to(dt)
        k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
        v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
        off = torch.tensor([0, 7], dtype=torch.int32, device=dev)
        qp = (torch.arange(T, device=dev)[None] + off[:, None]).int()
        qp[1, :16] = -1
        kv_len = torch.tensor([512, 389], dtype=torch.int32, device=dev)
        for window in (None, 200):
            got = F.flash_attend(q, k, v, qp, kv_len, window, off)
            ref = F.flash_attend_ref(q, k, v, qp, kv_len, window, off)
            row = check(torch, "flash_fwd", got, ref,
                        {"dtype": dname, "window": window})
            row["masked_rows_zero"] = bool(torch.all(got[1, :16] == 0))
            if not row["masked_rows_zero"]:
                raise AssertionError(f"masked rows not zero: {row}")
            cases.append(row)
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
    torch.cuda.synchronize()
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
               on_round=lambda rnd: None):
    """The consensus-shaped traffic: round 1 (three sessioned JSON rows)
    and one long sessionless row as its own query, then round 2, which
    resumes each session with one more user message. Returns per-round
    summaries, the results of every row, and the histories a next round
    would send."""
    users = ["pick the next action", "decide what to do next",
             "propose one step"]
    hist = [chat(u, n_rules) for u in users]
    rounds, results = [], []
    for rnd in (1, 2):
        on_round(rnd)
        summary, res = consensus_round(R, backend, spec, hist, temps,
                                       max_tokens)
        summary = {"round": rnd, **summary}
        if rnd == 1:
            summary["sessionless"], one = sessionless_row(
                R, backend, spec, max_tokens, n_rules)
            res = res + [one]
        rounds.append(summary)
        results.append(res)
        hist = [h + [{"role": "assistant", "content": r.text},
                     {"role": "user", "content": "refine your proposal"}]
                for h, r in zip(hist, res)]
    return rounds, results, hist


def check_rounds(rounds, results, dfa, long_min: int) -> None:
    if rounds[0]["sessionless"]["prompt_tokens"] < long_min:
        raise AssertionError(f"sessionless prompt below {long_min} tokens")
    if min(rounds[1]["cached_tokens"]) <= 0:
        raise AssertionError(f"round 2 resumed nothing: {rounds[1]}")
    for res in results:
        for r in res[:3]:
            if not json_prefix_ok(dfa, r.text):
                raise AssertionError(f"not a JSON prefix: {r.text!r}")


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

    def ragged_rec(q, k_pages, v_pages, tables, meta, tq,
                   sliding_window=None):
        key = "chunk" if tq > 1 else "decode"
        if cur["round"] == 2 and key not in kept:
            kept[key] = ([q.clone(), k_pages.clone(), v_pages.clone(),
                          tables.clone(), meta.clone(), tq,
                          sliding_window], {})
        return orig_ragged(q, k_pages, v_pages, tables, meta, tq,
                           sliding_window)

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
    if min(launches.values()) <= 0:
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


def phase_mainpath(torch, F, P, kernels, kept, launches) -> list:
    """Each kernel on the inputs the main path gave it: error against the
    twin, device times, and the bound from these inputs."""
    from quoracle_tpu_torch.ops.attention import attention_mask
    entries = []
    a, kw = kept["flash_fwd"]
    q, k, v, qp, kv_len = a
    window, off = kw.get("sliding_window"), kw.get("kv_pos_offset")
    got = F.flash_attend(*a, **kw)
    err = check(torch, "flash_fwd", got, F.flash_attend_ref(*a, **kw),
                {"dtype": dtype_name(q)})["max_abs_err"]
    nbytes, flops = flash_work(q, k, qp, kv_len, window, off)
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    # the yardstick: one PyTorch call on the same work, in its layout
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = attention_mask(qp, kv_len, k.shape[1], window, off)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entries.append({
        "name": "flash_fwd", "route": "cuda",
        "source": kernels.FLASH.source, "replaces": kernels.FLASH.replaces,
        "launches": launches["flash_fwd"], "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: F.flash_attend(*a, **kw)),
        "plain_ms": cuda_ms(torch, lambda: F.flash_attend_ref(*a, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, lambda: sdpa(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        "shape": {"q": list(q.shape), "k": list(k.shape),
                  "dtype": dtype_name(q), "bytes": nbytes,
                  "flops": flops}})

    ticks = {}
    for key in ("decode", "chunk"):
        a, kw = kept[key]
        q, kp, vp, bt, bm, tq, window = a
        got = P.ragged_attend(*a)
        err = check(torch, "ragged_fwd", got, P.ragged_attend_ref(*a),
                    {"dtype": dtype_name(q), "tq": tq})["max_abs_err"]
        nbytes, flops = ragged_work(q, kp, bt, bm, tq, window)
        b_ms, b_by = bound(nbytes, flops, dtype_name(q))
        ticks[key] = {
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: P.ragged_attend(*a)),
            "plain_ms": cuda_ms(torch, lambda: P.ragged_attend_ref(*a)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"q": list(q.shape), "pages": list(kp.shape),
                      "tables": list(bt.shape), "tq": tq,
                      "live_blocks": int((bm[:, 2] > 0).sum()),
                      "dtype": dtype_name(q), "bytes": nbytes,
                      "flops": flops}}
    # the decode tick is the one the main path launches most; the chunk
    # tick's numbers ride beside it
    entries.append({
        "name": "ragged_fwd", "route": "cuda",
        "source": kernels.RAGGED.source,
        "replaces": kernels.RAGGED.replaces,
        "launches": launches["ragged_fwd"], **ticks["decode"],
        "library_ms": None, "chunk": ticks["chunk"]})
    return entries


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
                R, backend, MODEL, hist, TEMPS, MAX_TOKENS)),
            ("sessionless long row", lambda: sessionless_row(
                R, backend, MODEL, MAX_TOKENS, N_RULES))):
        row = traced(torch, label, fn)
        row.update(prefill_ms=eng.last_prefill_s * 1e3,
                   decode_ms=eng.last_decode_s * 1e3,
                   prefill_tokens=eng.last_prefill_tokens)
        calls.append(row)
    return {"phase": "trace", "model": MODEL, "calls": calls}


def phase_sweep(torch, F, P) -> dict:
    """Each kernel's time and bound over the lengths it serves, bf16 at
    llama-3-8b attention geometry: ragged decode ticks (tq=1, 3 live rows
    in 8 slots, the consensus round's shape) over resident lengths, and
    flash prefill chunks (B=1, 64 keys more than queries) over T."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    H, KV, hd, page, n_pages = 32, 8, 128, 128, 129
    kp = torch.randn(n_pages, page, KV, hd, generator=g,
                     device=dev).bfloat16()
    vp = torch.randn(n_pages, page, KV, hd, generator=g,
                     device=dev).bfloat16()
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
        b_ms, b_by = bound(*ragged_work(q, kp, bt, bm, 1, None), "bfloat16")
        rows.append({"kernel": "ragged_fwd", "tq": 1, "live_rows": live,
                     "resident": resident,
                     "ms": cuda_ms(torch, lambda: P.ragged_attend(
                         q, kp, vp, bt, bm, 1, None)),
                     "bound_ms": b_ms, "bound_by": b_by})
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
                     "bound_ms": b_ms, "bound_by": b_by})
    return {"phase": "sweep", "cases": rows}


def phase_reference(torch, R) -> dict:
    """The same traffic, greedy, through a 2-layer fp32 cut of llama-3-8b
    on the GPU (kernels) and on the CPU (plain twins), one set of
    weights: the texts, token counts and cached-token counts must agree."""
    from quoracle_tpu_torch.models import config as C
    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.tokenizer import get_tokenizer
    from quoracle_tpu_torch.models.transformer import init_params
    cfg = C.register_model(dataclasses.replace(
        C.get_model_config(MODEL), name="llama-3-8b-2layer", n_layers=2))
    spec = f"xla:{cfg.name}"
    out = {}
    for dev in ("cuda", "cpu"):
        gen = torch.Generator().manual_seed(1)      # CPU draws, both sides
        params = init_params(cfg, gen, device=dev, dtype=torch.float32)
        eng = GenerateEngine(cfg, params, get_tokenizer(spec), device=dev)
        backend = R.TorchBackend([spec], device=dev, engines={spec: eng})
        t0 = time.monotonic()
        rounds, results, _ = run_rounds(R, backend, spec, [0.0] * 3,
                                        max_tokens=12, n_rules=8)
        out[dev] = {"s": time.monotonic() - t0, "rounds": rounds,
                    "texts": [[r.text for r in res] for res in results],
                    "tokens": [[r.usage.completion_tokens for r in res]
                               for res in results]}
        del backend, eng, params
    same = all(out["cuda"][k] == out["cpu"][k] for k in ("texts", "tokens"))
    same = same and all(
        a["cached_tokens"] == b["cached_tokens"]
        for a, b in zip(out["cuda"]["rounds"], out["cpu"]["rounds"]))
    report = {"phase": "reference", "model": spec, "dtype": "float32",
              "identical": same,
              "gpu_s": out["cuda"]["s"], "cpu_s": out["cpu"]["s"],
              "sessionless_prompt_tokens":
                  out["cuda"]["rounds"][0]["sessionless"]["prompt_tokens"],
              "cached_tokens": out["cuda"]["rounds"][1]["cached_tokens"],
              "new_tokens": out["cuda"]["tokens"]}
    if not same:
        report["gpu_texts"] = out["cuda"]["texts"]
        report["cpu_texts"] = out["cpu"]["texts"]
        emit(report)
        raise AssertionError("GPU and CPU engines disagree")
    return report


def main() -> int:
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
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "library": os.path.relpath(path, REPO),
          "ptxas": [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                    if "Used" in ln]})

    cases = phase_kernels(torch, F, P)
    emit({"phase": "kernels",
          "kernels": [{"name": k.name, "source": k.source,
                       "status": "ok"} for k in kernels.KERNELS],
          "cases": cases})

    backend, report, kept, launches, hist = phase_serve(
        torch, R, F, P, kernels, CharDFA(max_depth=4))
    emit(report)
    entries = phase_mainpath(torch, F, P, kernels, kept, launches)
    emit({"phase": "mainpath", "kernels": entries})
    emit(phase_trace(torch, R, backend, hist))
    del backend, kept
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
    sys.exit(main())
