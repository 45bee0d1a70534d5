"""Close the train → serve loop: fine-tune a bench checkpoint on a
locally-generated corpus, export it back to HF layout, and measure the
served result through the production stack (port of
``quoracle_tpu/tools/finetune.py``).

  ``--target format`` (default) — instruction/format corpus teaching the
  agent-action JSON shape (actions/schema.py vocabulary, rendered through
  the checkpoint's own chat template). Served UNCONSTRAINED (grammar off),
  the fine-tuned model must emit parseable action JSON — the measured
  claim is ``json_compliance`` over held-out tasks.

  ``--target mmlu`` — the mmlu-pro grove subset in the grove accuracy
  runner's exact prompt format. This TRAINS ON THE SUBSET ITSELF: the
  number proves the train → checkpoint → serve → score lifecycle, not any
  knowledge claim, and the artifact says so. The port scores the exported
  checkpoint itself with the runner's forced-choice query (the grove's
  own ``run_tpu_accuracy.py`` drives the JAX package).

Default scale is ``small`` so the loop runs in minutes on the CPU
(``--device cpu``); ``--scale 1b`` on the card is the real thing (the
corpus ids and the batch order are the JAX package's). Artifact: one JSON
line on stdout; ``--out-artifact`` also writes it to a file.

    python -m quoracle_tpu_torch.tools.finetune --steps 600
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

NOUNS = ["test suite", "deployment", "budget report", "web crawler",
         "database migration", "log pipeline", "release notes",
         "staging cluster", "billing alert", "search index",
         "pull request", "config drift", "cache layer", "cron schedule"]
VERBS = ["Investigate", "Summarize", "Review", "Fix", "Plan", "Audit",
         "Document", "Prioritize", "Debug", "Coordinate"]
REASONS = ["the {n} needs attention first",
           "this unblocks the rest of the work on the {n}",
           "the parent asked for an update about the {n}",
           "splitting the {n} work keeps the tree responsive",
           "the {n} is the cheapest next step"]

SYSTEM = ('You are an autonomous agent. Respond ONLY with a JSON object '
          '{"action": ..., "params": {...}, "reasoning": ..., '
          '"wait": false}.')


def _format_sample(rng: random.Random) -> tuple[str, str]:
    """(user task, assistant JSON) — varied content, rigid shape."""
    n = rng.choice(NOUNS)
    task = f"{rng.choice(VERBS)} the {n} and report back."
    action = rng.choice([
        ("send_message", {"target": "parent",
                          "content": f"status update on the {n}"}),
        ("todo", {"items": [f"check the {n}", f"report on the {n}"]}),
        ("execute_shell", {"command": f"ls -la {n.split()[0]}"}),
        ("file_read", {"path": f"/tmp/{n.split()[0]}.txt"}),
        ("orient", {}),
        ("spawn_child", {"task": f"handle the {n}"}),
    ])
    obj = {"action": action[0], "params": action[1],
           "reasoning": rng.choice(REASONS).format(n=n), "wait": False}
    return task, json.dumps(obj, separators=(", ", ": "))


def build_format_corpus(tok, eos_id: int, n: int, seed: int,
                        max_len: int) -> list[tuple[list[int], int]]:
    """[(token ids, prompt_len)] — loss masked to the completion."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        task, answer = _format_sample(rng)
        prompt = tok.encode_chat([{"role": "system", "content": SYSTEM},
                                  {"role": "user", "content": task}])
        ids = prompt + tok.encode(answer) + [eos_id]
        if len(ids) <= max_len:
            out.append((ids, len(prompt)))
    return out


def build_mmlu_corpus(tok, eos_id: int, grove_dir: str, repeats: int,
                      max_len: int) -> list[tuple[list[int], int]]:
    """The grove subset in run_tpu_accuracy.py's EXACT prompt format →
    '{"action": "<key letter>"}' completions (lifecycle proof, see module
    docstring)."""
    from quoracle_tpu_torch.governance.bench_scoring import load_questions
    qs = load_questions(grove_dir)
    out = []
    for _ in range(repeats):
        for q in qs:
            opts = "\n".join(f"{k}. {v}" for k, v in q["options"].items())
            prompt = tok.encode_chat([
                {"role": "system",
                 "content": "Answer the multiple-choice question. Respond "
                            'ONLY with JSON: {"action": "<LETTER A-J>"}.'},
                {"role": "user", "content": f"{q['question']}\n{opts}"},
            ])
            ids = prompt + tok.encode(
                json.dumps({"action": q["answer"]})) + [eos_id]
            if len(ids) <= max_len:
                out.append((ids, len(prompt)))
    return out


MMLU_SYSTEM = ("Answer the multiple-choice question. Respond ONLY with "
               'JSON: {"action": "<LETTER A-J>"}.')
LETTERS = tuple("ABCDEFGHIJ")


def train(ckpt_dir: str, rows, steps: int, batch: int, seq: int,
          lr: float, seed: int, log, device=None):
    """Load the checkpoint in fp32 on ``device`` (None: the card), train
    ``steps`` AdamW steps on batches drawn as the JAX tool draws them
    (``random.Random(seed).choice``), return (cfg, TrainState)."""
    import numpy as np
    import torch

    from quoracle_tpu_torch.models.loader import (
        load_params, register_hf_checkpoint,
    )
    from quoracle_tpu_torch.models.train import (
        init_train_state, make_optimizer, train_step,
    )
    cfg = register_hf_checkpoint(ckpt_dir, name="ft-base")
    params = load_params(ckpt_dir, cfg, device=device, dtype=torch.float32)
    dev = next(params.parameters()).device
    optimizer = make_optimizer(lr=lr)
    state = init_train_state(params, optimizer)

    rng = random.Random(seed)
    pad = cfg.eos_token_id
    t0 = time.monotonic()
    for i in range(steps):
        tok_b = np.full((batch, seq), pad, np.int32)
        mask_b = np.zeros((batch, seq), np.float32)
        for b in range(batch):
            ids, plen = rng.choice(rows)
            ids = ids[:seq]
            tok_b[b, :len(ids)] = ids
            mask_b[b, plen:len(ids)] = 1.0
        state, loss = train_step(state, cfg, optimizer,
                                 torch.from_numpy(tok_b).to(dev),
                                 torch.from_numpy(mask_b).to(dev))
        if i % 50 == 0 or i == steps - 1:
            log(f"step {i}: loss {float(loss):.4f} "
                f"({time.monotonic() - t0:.0f}s)")
    return cfg, state


def eval_format(out_dir: str, n_eval: int, seed: int, log,
                device=None) -> dict:
    """Serve the exported checkpoint UNCONSTRAINED and measure how many
    held-out tasks yield parseable action JSON."""
    from quoracle_tpu_torch.actions.schema import ACTIONS
    from quoracle_tpu_torch.models.loader import register_hf_checkpoint
    from quoracle_tpu_torch.models.runtime import QueryRequest, TorchBackend
    cfg = register_hf_checkpoint(out_dir, name="ft-tuned")
    backend = TorchBackend([f"xla:{cfg.name}"], device=device)
    rng = random.Random(seed + 1)             # disjoint from training seed
    ok = strict = 0
    n_greedy = n_eval // 2
    try:
        for i in range(n_eval):
            task, _ = _format_sample(rng)
            r = backend.query([QueryRequest(
                f"xla:{cfg.name}",
                [{"role": "system", "content": SYSTEM},
                 {"role": "user", "content": task}],
                temperature=0.0 if i < n_greedy else 0.7,
                max_tokens=128, constrain_json=False)])[0]
            if not r.ok:
                continue
            try:
                obj = json.loads(r.text.strip())
                parsed = isinstance(obj, dict) and "action" in obj
            except json.JSONDecodeError:
                parsed = False
            ok += int(parsed)
            strict += int(parsed and obj.get("action") in ACTIONS
                          and isinstance(obj.get("params"), dict))
            if i < 3:
                log(f"sample {i}: {r.text[:100]!r}")
    finally:
        backend.close()
    return {"json_compliance": round(ok / max(1, n_eval), 4),
            "strict_action_compliance": round(strict / max(1, n_eval), 4),
            "n_eval": n_eval, "greedy": n_greedy,
            "sampled_t07": n_eval - n_greedy}


def eval_mmlu(out_dir: str, grove_dir: str, log, device=None) -> dict:
    """The grove accuracy runner's forced-choice query over the subset,
    one member (the exported checkpoint): the grammar's enum slot makes
    every completed answer one letter, scored against the key."""
    import re

    from quoracle_tpu_torch.governance.bench_scoring import load_questions
    from quoracle_tpu_torch.models.loader import register_hf_checkpoint
    from quoracle_tpu_torch.models.runtime import QueryRequest, TorchBackend
    letter = re.compile(r'"action"\s*:\s*"([A-J])"')
    cfg = register_hf_checkpoint(out_dir, name="ft-tuned")
    spec = f"xla:{cfg.name}"
    backend = TorchBackend([spec], device=device)
    per_subject: dict = {}
    correct = answered = 0
    questions = load_questions(grove_dir)
    try:
        for q in questions:
            opts = "\n".join(f"{k}. {v}" for k, v in q["options"].items())
            msgs = [{"role": "system", "content": MMLU_SYSTEM},
                    {"role": "user", "content": f"{q['question']}\n{opts}"}]
            r = backend.query([QueryRequest(
                spec, msgs, temperature=0.2, max_tokens=96,
                constrain_json=True, action_enum=LETTERS)])[0]
            m = letter.search(r.text or "") if r.ok else None
            answered += int(m is not None)
            hit = int(m is not None and m.group(1) == q["answer"])
            correct += hit
            per_subject.setdefault(q["subject"], []).append(hit)
    finally:
        backend.close()
    log(f"mmlu: {correct}/{len(questions)} correct")
    return {"metric": "mmlu_pro_subset_accuracy",
            "value": round(correct / max(1, len(questions)), 4),
            "unit": "fraction", "questions": len(questions),
            "answered": answered, "pool": [spec],
            "per_subject": {s: round(sum(v) / len(v), 3)
                            for s, v in sorted(per_subject.items())}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", choices=["format", "mmlu"],
                    default="format")
    ap.add_argument("--scale", default="small")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus-size", type=int, default=2000)
    ap.add_argument("--n-eval", type=int, default=60)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out-artifact", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    from quoracle_tpu_torch.models.loader import export_hf_checkpoint
    from quoracle_tpu_torch.models.make_checkpoint import make_checkpoint
    from quoracle_tpu_torch.models.tokenizer import HFAutoTokenizer

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    work = args.workdir or os.path.join(repo, "checkpoints",
                                        f"finetune-{args.target}")
    base = make_checkpoint(os.path.join(work, "base"), family="llama",
                           scale=args.scale, seed=args.seed)
    tok = HFAutoTokenizer(base)
    grove = os.path.join(repo, "groves", "mmlu-pro")

    if args.target == "format":
        rows = build_format_corpus(tok, tok.eos_id, args.corpus_size,
                                   args.seed, args.seq)
    else:
        rows = build_mmlu_corpus(tok, tok.eos_id, grove,
                                 repeats=max(1, args.corpus_size // 24),
                                 max_len=args.seq)
    log(f"corpus: {len(rows)} rows (target {args.target})")

    cfg, state = train(base, rows, args.steps, args.batch, args.seq,
                       args.lr, args.seed, log, device=args.device)
    out_dir = export_hf_checkpoint(state.params, cfg,
                                   os.path.join(work, "tuned"), base)
    log(f"exported fine-tuned checkpoint to {out_dir}")

    artifact = {
        "metric": f"train_serve_loop_{args.target}",
        "scale": args.scale, "steps": args.steps,
        "corpus_rows": len(rows), "checkpoint": out_dir,
        "trained_on_eval_set": args.target == "mmlu",
        "note": ("mmlu target trains ON the grove subset: the number "
                 "proves the train->checkpoint->serve->score lifecycle, "
                 "NOT model knowledge"
                 if args.target == "mmlu" else
                 "eval tasks drawn from a disjoint seed; grammar "
                 "constraint OFF during eval"),
    }
    if args.target == "format":
        artifact.update(eval_format(out_dir, args.n_eval, args.seed, log,
                                    device=args.device))
        artifact["value"] = artifact["json_compliance"]
        artifact["unit"] = "fraction"
    else:
        grove_result = eval_mmlu(out_dir, grove, log, device=args.device)
        artifact.update({"value": grove_result["value"],
                         "unit": "fraction",
                         "grove_result": grove_result})
    print(json.dumps(artifact))
    if args.out_artifact:
        with open(args.out_artifact, "w") as f:
            json.dump(artifact, f, indent=1)


if __name__ == "__main__":
    main()
