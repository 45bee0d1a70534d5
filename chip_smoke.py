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
             the resumed round, on the unified tier (the card's default).
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
             rounds' stores, set by session_max_bytes: the rounds must
             still answer, through the dense prefill and decode, with no
             paged kernel launched). The direct round 2's first inputs of
             both paged kernels are kept, and the three tiers' round-2
             prefill and decode times are printed side by side.
  serve_int8 int8 serving (quantize_weights and quantize_kv) from the
             serve phase's bf16 weights: the same traffic on the unified
             tier, where the int8 ragged kernel must run (and ragged_fwd
             and the paged kernels must not) and flash serves the
             sessionless row; then the rounds again on the gather tier
             (forced) and under pool exhaustion, with no int8 ragged
             launch. The int8 pool must hold ~1.94x the bf16 pool's
             tokens in the same 2 GiB. The resumed round's first int8
             chunk and decode ticks are kept for the mainpath phase, and
             round 2's prefill ms and ms per decode step are printed for
             int8 unified, int8 gather and bf16 unified.
  mainpath   each kernel against its twin on those kept inputs, timed
             (CUDA events, L2 flushed before every launch) beside its
             bound, the twin's time and scaled_dot_product_attention's
             time as a yardstick (for the paged kernels over K/V gathered
             beforehand, outside the timing, with the same mask; it
             returns a normalized output where they return partials; for
             the int8 kernel over K/V gathered and dequantized beforehand)
  trace      one more resumed round and one more sessionless row, each
             under torch.profiler: wall time, device busy time (the union
             of kernel intervals), idle share, launches, and the kernels
             that take the most device time
  sweep      each kernel's time and bound over the lengths it serves:
             ragged decode ticks (bf16 and int8 pages side by side) and
             the paged decode over resident lengths (with S and the grid
             of each split-K launch, and S by hand at 823 keys for all
             three split-K kernels), flash over T, the paged prefill over
             prefix lengths at chunks of 16 and 128 tokens (each beside
             scaled_dot_product_attention's time)
  reference  a 2-layer cut of llama-3-8b in fp32: the same rounds through
             the GPU engine (kernels) and through the same weights on the
             CPU (plain twins) must give identical greedy texts and cached
             counts, on the unified, direct and gather tiers, and with
             int8 weights and pages on the unified and gather tiers

then the card's nvidia-smi line, the kernels JSON line and, last,
``{"ok": true, "device": {...}}``. ``--only kernels`` stops after the
kernels phase (a quick check of a kernel edit; no last line); ``--only
sweep`` runs the sweep phase alone after the build (kernel times at the
main path's lengths without the serving phases; no last line). Every
comparison runs with TF32 off (torch.backends.cuda.matmul.allow_tf32 =
False, and cudnn's too). The script imports torch and the port, never
JAX or the JAX package.
"""

import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

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
N_RULES = 30                # system-prompt length of the serve phase
TEMPS = [1.0, 0.7, 0.0]     # the consensus round's member temperatures


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
                                           MAX_TOKENS))
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
    ticks = {}
    for key in ("decode", "chunk"):
        a, kw = kept[key]
        q, kp, vp, bt, bm, tq, window = a
        got = P.ragged_attend(*a, **kw)
        err = check(torch, kernel.name, got, P.ragged_attend_ref(*a, **kw),
                    {"dtype": dtype_name(q), "tq": tq})["max_abs_err"]
        scaled = kw.get("k_scale") is not None
        nbytes, flops = ragged_work(torch, q, kp, bt, bm, tq, window,
                                    scales=scaled)
        b_ms, b_by = bound(nbytes, flops, dtype_name(q))
        ticks[key] = {
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
    return {"name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": launches,
            **ticks["decode"], "chunk": ticks["chunk"]}


def phase_mainpath(torch, F, P, kernels, kept, launches) -> list:
    """Each kernel on the inputs the main path gave it: error against the
    twin, device times, and the bound from these inputs."""
    entries = []
    a, kw = kept["flash_fwd"]
    q, k, v, qp, kv_len = a
    window, off = kw.get("sliding_window"), kw.get("kv_pos_offset")
    got = F.flash_attend(*a, **kw)
    row = check(torch, "flash_fwd", got, F.flash_attend_ref(*a, **kw),
                {"dtype": dtype_name(q)},
                F.flash_attend_ref(q, k, v.abs(), qp, kv_len, **kw))
    err = row["max_abs_err"]
    nbytes, flops = flash_work(q, k, qp, kv_len, window, off)
    b_ms, b_by = bound(nbytes, flops, dtype_name(q))
    entries.append({
        "name": "flash_fwd", "route": "cuda",
        "source": kernels.FLASH.source, "replaces": kernels.FLASH.replaces,
        "launches": launches["flash_fwd"], "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: F.flash_attend(*a, **kw)),
        "plain_ms": cuda_ms(torch, lambda: F.flash_attend_ref(*a, **kw)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(torch, flash_library(torch, q, k, v, qp,
                                                   kv_len, window, off)),
        "bar_used": row["bar_used"],
        "shape": {"q": list(q.shape), "k": list(k.shape),
                  "dtype": dtype_name(q), "bytes": nbytes,
                  "flops": flops}})

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


def phase_reference(torch, R) -> dict:
    """The same traffic, greedy, through a 2-layer fp32 cut of llama-3-8b
    on the GPU (kernels) and on the CPU (plain twins), one set of
    weights, on each paged tier in turn (one float and one int8 engine,
    both ``quantize_weights`` and ``quantize_kv``, per device; sessions
    dropped between tiers): the texts, token counts and cached-token
    counts must agree. The float unified tier runs the full traffic, the
    other tiers the consensus rounds only (the sessionless row takes the
    dense path whatever the tier)."""
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
        backends = {quant: R.TorchBackend([spec], device=dev, engines={
            spec: GenerateEngine(cfg, params, get_tokenizer(spec),
                                 device=dev, quantize_weights=quant,
                                 quantize_kv=quant)})
            for quant in (False, True)}
        for tier, (quant, attrs) in REFERENCE_TIERS.items():
            backend = backends[quant]
            eng = backend.engines[spec]
            eng.unified_min_tokens = eng.direct_decode_min_tokens = \
                eng.direct_prefill_min_tokens = 1 << 30
            eng._force_gather_decode = False
            for k, v in attrs.items():
                setattr(eng, k, v)
            t0 = time.monotonic()
            rounds, results, _ = run_rounds(
                R, backend, spec, [0.0] * 3, max_tokens=12, n_rules=8,
                sessionless=tier == "unified")
            out[(dev, tier)] = {
                "s": time.monotonic() - t0, "rounds": rounds,
                "texts": [[r.text for r in res] for res in results],
                "tokens": [[r.usage.completion_tokens for r in res]
                           for res in results]}
            for i in range(3):
                backend.drop_session(f"agent-{i}")
        del backends, params
    report = {"phase": "reference", "model": spec, "dtype": "float32",
              "tiers": {}}
    bad = []
    for tier in REFERENCE_TIERS:
        g, c = out[("cuda", tier)], out[("cpu", tier)]
        same = all(g[k] == c[k] for k in ("texts", "tokens")) and all(
            a["cached_tokens"] == b["cached_tokens"]
            for a, b in zip(g["rounds"], c["rounds"]))
        row = {"identical": same, "gpu_s": g["s"], "cpu_s": c["s"],
               "cached_tokens": g["rounds"][1]["cached_tokens"],
               "new_tokens": g["tokens"]}
        if tier == "unified":
            row["sessionless_prompt_tokens"] = \
                g["rounds"][0]["sessionless"]["prompt_tokens"]
        if min(g["rounds"][1]["cached_tokens"]) <= 0:
            raise AssertionError(f"{tier}: round 2 resumed nothing: {row}")
        if not same:
            row.update(gpu_texts=g["texts"], cpu_texts=c["texts"])
            bad.append(tier)
        report["tiers"][tier] = row
    report["identical"] = not bad
    if bad:
        emit(report)
        raise AssertionError(f"GPU and CPU engines disagree on {bad}")
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
    if argv[1:2] == ["--only"] and argv[2:3] in (["kernels"], ["sweep"]):
        only = argv[2]          # env, build, then that phase; no last line
    elif argv[1:]:
        print(f"usage: {argv[0]} [--only kernels|sweep]", file=sys.stderr)
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
    launches = {**launches,
                **{k: paged_launches[k] for k in PAGED_KERNELS},
                "ragged_q8_fwd": int8_launches["ragged_q8_fwd"]}
    entries = phase_mainpath(torch, F, P, kernels, kept, launches)
    emit({"phase": "mainpath", "kernels": entries})
    emit(phase_trace(torch, R, backend, hist))
    del backend, kept, paged_kept
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
