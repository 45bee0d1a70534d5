"""How soon does a random-weight model close a grammar-constrained JSON
action object?

A decide needs one member per round whose answer parses. Under the JSON
grammar with ``action_enum`` (models/constrained.py) every answer opens
with ``{"action": "<name>"``; a model with random weights then closes the
object, or wanders into keys and strings that may outlast its token
budget. This tool walks the port's token table for a catalog vocabulary
with random logits in place of a model's: ``iid`` draws fresh N(0, 1)
logits each step, ``fixed`` keeps one N(0, 1) draw per trial plus
N(0, noise) each step (hidden states that barely move, as in a deep
random network). It prints, per mode, the share of trials whose object
closed within each budget. Host-only numpy; no device, no model.

    python -m quoracle_tpu_torch.tools.json_closure xla:llama-3-8b \\
        --trials 60 --max-tokens 512 --seed 1 --noise 0.5
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

BUDGETS = (12, 24, 48, 96, 128, 192, 256, 384, 512)


def closure_steps(table: np.ndarray, accept: np.ndarray, start: int,
                  eos_id: int, rng: np.random.Generator, mode: str,
                  noise: float, temperature: float,
                  max_tokens: int) -> int | None:
    """Tokens until the object closes (an accept state), or None."""
    vocab = table.shape[1]
    base = rng.standard_normal(vocab).astype(np.float32)
    state = start
    for step in range(max_tokens):
        draw = rng.standard_normal(vocab).astype(np.float32)
        logits = draw if mode == "iid" else base + noise * draw
        row = table[state]
        logits = np.where(row >= 0, logits / temperature, -np.inf)
        p = np.exp(logits - logits.max())
        tok = int(rng.choice(vocab, p=p / p.sum()))
        if tok == eos_id:
            return None
        state = int(row[tok])
        if accept[state]:
            return step + 1
    return None


def main(argv=None) -> int:
    from quoracle_tpu_torch.models.config import get_model_config
    from quoracle_tpu_torch.models.constrained import JsonTokenTable
    from quoracle_tpu_torch.models.tokenizer import get_tokenizer
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("spec")
    ap.add_argument("--action", default="wait")
    ap.add_argument("--trials", type=int, default=60)
    ap.add_argument("--max-tokens", type=int, default=512)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--noise", type=float, default=0.5)
    ap.add_argument("--temperature", type=float, default=1.0)
    args = ap.parse_args(argv)
    cfg = get_model_config(args.spec)
    tok = get_tokenizer(args.spec)
    tt = JsonTokenTable.for_tokenizer(tok, cfg.vocab_size, tok.eos_id,
                                      action_enum=(args.action,))
    table = tt.table.astype(np.int32)
    rng = np.random.default_rng(args.seed)
    out = {"spec": args.spec, "trials": args.trials,
           "temperature": args.temperature, "noise": args.noise,
           "seed": args.seed}
    for mode in ("iid", "fixed"):
        steps = [closure_steps(table, tt.accept, tt.start_state, tok.eos_id,
                               rng, mode, args.noise, args.temperature,
                               args.max_tokens)
                 for _ in range(args.trials)]
        out[mode] = {str(b): sum(s is not None and s <= b for s in steps)
                     / args.trials
                     for b in BUDGETS if b <= args.max_tokens}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
