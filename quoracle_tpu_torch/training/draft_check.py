"""Train a REAL draft model and measure true speculative acceptance (port
of ``quoracle_tpu/training/draft_check.py``).

The training leg runs through :mod:`quoracle_tpu_torch.training.trainer`
(one card; the JAX package's dp-mesh step is its counterpart).
``--check`` is a self-contained, minutes-scale smoke: tiny target and
tiny draft trained briefly on the format corpus, acceptance measured on
held-out prompts and asserted above ``--check-floor``, greedy
bit-equality against vanilla engine decode as the correctness gate.
``tools/train_draft.py`` remains the runnable shim.

Tokenizer identity: the draft MUST share the target's token ids. The
port's make_checkpoint writes one fixed BPE for every scale, and the tool
asserts byte-identical tokenizer.json rather than trusting that.

    python -m quoracle_tpu_torch.tools.train_draft --check   # on the card
    python -m quoracle_tpu_torch.tools.train_draft --check --device cpu

Without ``--check`` the tool needs checkpoints/finetune-format/{base,
tuned} from a prior ``tools/finetune.py --target format`` run (it errors
with the command if they are missing).
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import statistics
import sys
import time


def run_check(args) -> dict:
    """``--check`` smoke mode: a self-contained, minutes-scale assertion
    that the draft-training pipeline still produces a USABLE draft — tiny
    target and tiny draft are both trained briefly on the same format
    corpus (no finetune prereq, no export) through the trainer's step,
    then speculative acceptance is measured on HELD-OUT format prompts
    and asserted above ``--check-floor``, with greedy bit-equality
    against vanilla engine decode as the correctness gate. Runs in the
    tests (tests/test_torch_train_draft_check.py). ``args.device`` (None:
    the card) places both models."""
    import random
    import tempfile

    from quoracle_tpu_torch.models.generate import GenerateEngine
    from quoracle_tpu_torch.models.make_checkpoint import make_checkpoint
    from quoracle_tpu_torch.models.speculative import SpeculativeDecoder
    from quoracle_tpu_torch.models.tokenizer import HFAutoTokenizer
    from quoracle_tpu_torch.tools.finetune import (
        SYSTEM, _format_sample, build_format_corpus,
    )
    from quoracle_tpu_torch.training.trainer import train_corpus
    device = getattr(args, "device", None)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    work = args.workdir or tempfile.mkdtemp(prefix="draft-check-")
    # tiny scale for BOTH: the check gates the PIPELINE (corpus →
    # trainer → acceptance), not model quality; one fixed BPE means
    # the two checkpoints share token ids (asserted below)
    t_dir = make_checkpoint(os.path.join(work, "target"), family="llama",
                            scale="tiny", seed=args.seed)
    d_dir = make_checkpoint(os.path.join(work, "draft"), family="llama",
                            scale="tiny", seed=args.seed + 7)
    a = os.path.join(t_dir, "tokenizer.json")
    b = os.path.join(d_dir, "tokenizer.json")
    if not filecmp.cmp(a, b, shallow=False):
        shutil.copy(a, b)
    tok = HFAutoTokenizer(t_dir)

    rows = build_format_corpus(tok, tok.eos_id, args.corpus_size,
                               args.seed, args.seq)
    log(f"check corpus: {len(rows)} rows; {args.steps} steps each")
    tcfg, tstate = train_corpus(t_dir, rows, args.steps, args.batch,
                                args.seq, args.lr, args.seed, log, dp=1,
                                device=device)
    dcfg, dstate = train_corpus(d_dir, rows, args.steps, args.batch,
                                args.seq, args.lr, args.seed + 1, log,
                                dp=1, device=device)

    eng = GenerateEngine(tcfg, tstate.params, tok, max_seq=512,
                         prompt_buckets=(64, 128, 256), device=device)
    dec = SpeculativeDecoder(tcfg, tstate.params, dcfg, dstate.params,
                             tok, k=args.k, max_seq=512)
    rng = random.Random(args.seed + 1)       # disjoint: held-out tasks
    acc, equal = [], 0
    for i in range(args.n_eval):
        task, _ = _format_sample(rng)
        prompt = tok.encode_chat([
            {"role": "system", "content": SYSTEM},
            {"role": "user", "content": task}])
        want = eng.generate([prompt], temperature=0.0,
                            max_new_tokens=args.max_new)[0]
        got = dec.generate(prompt, temperature=0.0,
                           max_new_tokens=args.max_new)
        acc.append(got.acceptance_rate)
        equal += int(got.token_ids == want.token_ids)
        log(f"check task {i}: accept {got.accepted}/{got.drafted} "
            f"equal={got.token_ids == want.token_ids}")
    acceptance = statistics.median(acc)
    payload = {
        "metric": "speculative_draft_check",
        "value": round(acceptance, 4),
        "unit": "acceptance_rate",
        "floor": args.check_floor,
        "k": args.k,
        "steps": args.steps,
        "greedy_equal": f"{equal}/{args.n_eval}",
        "ok": bool(acceptance >= args.check_floor
                   and equal == args.n_eval),
    }
    print(json.dumps(payload))
    assert equal == args.n_eval, \
        f"greedy speculation diverged from vanilla: {equal}/{args.n_eval}"
    assert acceptance >= args.check_floor, (
        f"draft acceptance {acceptance:.3f} below floor "
        f"{args.check_floor} — the draft-training pipeline regressed")
    return payload


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus-size", type=int, default=2000)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--k-sweep", default=None,
                    help="comma-separated extra K values to sweep (each "
                         "measured on the same held-out tasks, "
                         "unconstrained greedy)")
    ap.add_argument("--n-eval", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel width: 1 on one card (more is "
                         "ROADMAP Queue 1 item 12)")
    ap.add_argument("--device", default=None,
                    help="torch device for training and serving "
                         "(default: the card)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out-artifact", default=None)
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse an existing draft-tuned checkpoint and "
                         "only run the acceptance measurement")
    ap.add_argument("--check", action="store_true",
                    help="smoke mode: train a tiny target + tiny draft "
                         "for a few steps on the format corpus and "
                         "assert held-out acceptance above --check-floor "
                         "(self-contained; no finetune prereq)")
    ap.add_argument("--check-floor", type=float, default=0.2)
    args = ap.parse_args()

    if args.check:
        # check-mode defaults: small enough for a CPU run unless
        # the caller overrode them explicitly
        if args.steps == 400:
            args.steps = 30
        if args.corpus_size == 2000:
            args.corpus_size = 300
        if args.seq == 256:
            args.seq = 192    # system prompt + task + JSON must fit
        if args.n_eval == 12:
            args.n_eval = 4
        if args.max_new == 96:
            args.max_new = 48
        if args.k == 6:
            args.k = 4
        run_check(args)
        return

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    import torch

    from quoracle_tpu_torch.models.loader import (
        export_hf_checkpoint, load_params, register_hf_checkpoint,
    )
    from quoracle_tpu_torch.models.make_checkpoint import make_checkpoint
    from quoracle_tpu_torch.models.speculative import SpeculativeDecoder
    from quoracle_tpu_torch.models.tokenizer import HFAutoTokenizer
    from quoracle_tpu_torch.tools.finetune import (
        SYSTEM, _format_sample, build_format_corpus,
    )
    from quoracle_tpu_torch.training.trainer import train_corpus
    device = args.device

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    work = args.workdir or os.path.join(repo, "checkpoints",
                                        "finetune-format")
    target_base = os.path.join(work, "base")
    target_tuned = os.path.join(work, "tuned")
    for d in (target_base, target_tuned):
        if not os.path.isdir(d):
            raise SystemExit(
                f"missing {d}; run `python -m quoracle_tpu_torch.tools.finetune "
                f"--target format` first")

    # --- draft base: tiny scale, byte-identical tokenizer ---------------
    draft_base = make_checkpoint(os.path.join(work, "draft-base"),
                                 family="llama", scale="tiny",
                                 seed=args.seed + 7)
    for f in ("tokenizer.json",):
        a = os.path.join(target_base, f)
        b = os.path.join(draft_base, f)
        if not filecmp.cmp(a, b, shallow=False):
            # one fixed BPE means this should never happen; if the files
            # ever diverge, copying restores id identity
            log(f"tokenizer {f} differs; copying target's into draft")
            shutil.copy(a, b)
    tok = HFAutoTokenizer(target_tuned)

    # --- train the draft on the SAME corpus -----------------------------
    draft_tuned = os.path.join(work, "draft-tuned")
    meta_path = os.path.join(work, "draft-meta.json")
    if args.skip_train and os.path.isdir(draft_tuned):
        log(f"reusing existing draft at {draft_tuned}")
        try:                  # the artifact records the ACTUAL provenance
            with open(meta_path) as f:
                trained_steps = json.load(f).get("steps")
        except (OSError, ValueError):      # missing OR corrupt meta
            trained_steps = None
    else:
        rows = build_format_corpus(tok, tok.eos_id, args.corpus_size,
                                   args.seed, args.seq)
        log(f"corpus: {len(rows)} rows; training tiny draft "
            f"{args.steps} steps")
        dcfg, dstate = train_corpus(draft_base, rows, args.steps,
                                    args.batch, args.seq, args.lr,
                                    args.seed, log, dp=args.dp,
                                    device=device)
        draft_tuned = export_hf_checkpoint(
            dstate.params, dcfg, draft_tuned, draft_base)
        log(f"exported draft to {draft_tuned}")
        trained_steps = args.steps
        with open(meta_path, "w") as f:
            json.dump({"steps": trained_steps,
                       "corpus_size": args.corpus_size,
                       "seed": args.seed}, f)

    # --- speculative target x draft on held-out tasks -------------------
    tcfg = register_hf_checkpoint(target_tuned, name="spec-ft-target")
    tparams = load_params(target_tuned, tcfg, device=device,
                          dtype=torch.float32)
    dcfg2 = register_hf_checkpoint(draft_tuned, name="spec-ft-draft")
    dparams = load_params(draft_tuned, dcfg2, device=device,
                          dtype=torch.float32)

    from quoracle_tpu_torch.models.generate import GenerateEngine
    eng = GenerateEngine(tcfg, tparams, tok, max_seq=1024,
                         prompt_buckets=(64, 128, 256), device=device)
    dec = SpeculativeDecoder(tcfg, tparams, dcfg2, dparams, tok,
                             k=args.k, max_seq=1024)

    import random
    rng = random.Random(args.seed + 1)           # disjoint: held-out tasks
    acc, tpr, van_ms, spec_ms, equal = [], [], [], [], 0
    con_acc, con_tpr, con_equal = [], [], 0
    enum = ("todo", "send_message", "wait", "execute_shell", "spawn_child")
    for i in range(args.n_eval):
        task, _ = _format_sample(rng)
        prompt = tok.encode_chat([
            {"role": "system", "content": SYSTEM},
            {"role": "user", "content": task}])
        t0 = time.monotonic()
        want = eng.generate([prompt], temperature=0.0,
                            max_new_tokens=args.max_new)[0]
        van = time.monotonic() - t0
        t0 = time.monotonic()
        got = dec.generate(prompt, temperature=0.0,
                           max_new_tokens=args.max_new)
        spc = time.monotonic() - t0
        if i > 0:                    # first call pays the spec compiles
            van_ms.append(van * 1000 / max(1, want.n_gen_tokens))
            spec_ms.append(spc * 1000 / max(1, got.n_gen_tokens))
        acc.append(got.acceptance_rate)
        tpr.append(got.tokens_per_round)
        equal += int(got.token_ids == want.token_ids)
        log(f"task {i}: accept {got.accepted}/{got.drafted} "
            f"tokens/round {got.tokens_per_round:.2f} "
            f"equal={got.token_ids == want.token_ids}")
        # grammar-constrained variant — the production consensus shape
        cwant = eng.generate([prompt], temperature=0.0,
                             max_new_tokens=args.max_new,
                             constrain_json=[True],
                             action_enums=[enum])[0]
        cgot = dec.generate(prompt, temperature=0.0,
                            max_new_tokens=args.max_new,
                            constrain_json=True, action_enum=enum)
        con_acc.append(cgot.acceptance_rate)
        con_tpr.append(cgot.tokens_per_round)
        con_equal += int(cgot.token_ids == cwant.token_ids)
        log(f"task {i} constrained: accept {cgot.accepted}/{cgot.drafted}"
            f" tokens/round {cgot.tokens_per_round:.2f} "
            f"equal={cgot.token_ids == cwant.token_ids}")

    k_sweep = {}
    if args.k_sweep:
        for kk in [int(x) for x in args.k_sweep.split(",") if x.strip()]:
            if kk == args.k:
                continue
            dk = SpeculativeDecoder(tcfg, tparams, dcfg2, dparams, tok,
                                    k=kk, max_seq=1024)
            rng_k = random.Random(args.seed + 1)
            a_list, t_list = [], []
            for _ in range(args.n_eval):
                task, _ = _format_sample(rng_k)
                prompt = tok.encode_chat([
                    {"role": "system", "content": SYSTEM},
                    {"role": "user", "content": task}])
                g = dk.generate(prompt, temperature=0.0,
                                max_new_tokens=args.max_new)
                a_list.append(g.acceptance_rate)
                t_list.append(g.tokens_per_round)
            k_sweep[str(kk)] = {
                "acceptance_p50": round(statistics.median(a_list), 4),
                "tokens_per_round_p50": round(statistics.median(t_list),
                                              2)}
            log(f"k={kk}: acceptance {k_sweep[str(kk)]}")

    payload = {
        "metric": "speculative_trained_draft",
        "value": round(statistics.median(acc), 4),
        "unit": "acceptance_rate",
        "k": args.k,
        "tokens_per_round_p50": round(statistics.median(tpr), 2),
        "greedy_equal": f"{equal}/{args.n_eval}",
        "constrained_acceptance_p50": round(
            statistics.median(con_acc), 4),
        "constrained_tokens_per_round_p50": round(
            statistics.median(con_tpr), 2),
        "constrained_greedy_equal": f"{con_equal}/{args.n_eval}",
        "constrained_enum": list(enum),
        "k_sweep": k_sweep or None,
        "target": "finetune-format/tuned (small, ~7M)",
        "draft": "finetune-format/draft-tuned (tiny, ~0.6M)",
        "draft_steps": trained_steps,
        "n_eval_heldout": args.n_eval,
        "device": str(eng.device),
        "vanilla_ms_per_token_p50": round(
            statistics.median(van_ms), 2) if van_ms else None,
        "spec_ms_per_token_p50": round(
            statistics.median(spec_ms), 2) if spec_ms else None,
        "note": ("held-out format tasks, greedy; ms are host-clock "
                 "per generated token on the named device (the engines "
                 "synchronize before returning)"),
    }
    line = json.dumps(payload)
    print(line)
    if args.out_artifact:
        with open(args.out_artifact, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
