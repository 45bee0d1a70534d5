"""Shared machinery for benchmark-grove scoring scripts (a copy of
``quoracle_tpu/governance/bench_scoring.py``; the port imports nothing of
the JAX package).

Both shipped groves (groves/mmlu-pro, groves/livebench) score the same
run layout: a workspace with ``runs/<id>/answers/<qid>.json`` files
graded against the grove's own ``data/questions.jsonl`` key (which never
enters the agent workspace — ``prepare`` strips the secret fields from the
copy the agents read). Only the grading function, the grouping field, and
the secret-field list differ per grove, so each grove's
``scripts/score_run.py`` supplies those and delegates the
prepare/score/CLI skeleton here. The groves' own scripts import the JAX
module; the port's finetune tool and the tests read this copy.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Callable, Sequence


def load_questions(grove_dir: str) -> list[dict]:
    with open(os.path.join(grove_dir, "data", "questions.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def prepare(workspace: str, grove_dir: str,
            secret_fields: Sequence[str]) -> None:
    """Copy the dataset into the workspace with the grading key stripped,
    and create runs/."""
    os.makedirs(os.path.join(workspace, "runs"), exist_ok=True)
    dst = os.path.join(workspace, "data")
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    os.makedirs(dst)
    qs = load_questions(grove_dir)
    with open(os.path.join(dst, "questions.jsonl"), "w") as f:
        for q in qs:
            f.write(json.dumps({k: v for k, v in q.items()
                                if k not in secret_fields}) + "\n")
    print(f"workspace prepared at {workspace} ({len(qs)} questions)")


def score(workspace: str, run_id: str, grove_dir: str,
          grade_fn: Callable[[dict, object], bool],
          group_key: str, group_field: str) -> dict:
    """Grade runs/<run_id>/answers/*.json against the grove key; write and
    return runs/<run_id>/score.json with overall + per-group accuracy.
    ``group_key`` names the question field to group by (e.g. "subject");
    ``group_field`` names the result key (e.g. "per_subject")."""
    key = {q["id"]: q for q in load_questions(grove_dir)}
    answers_dir = os.path.join(workspace, "runs", run_id, "answers")
    groups: dict[str, list[int]] = {}
    answered = correct = 0
    for qid, q in key.items():
        path = os.path.join(answers_dir, f"{qid}.json")
        got = None
        if os.path.isfile(path):
            try:
                with open(path) as f:
                    got = json.load(f).get("answer")
            except (json.JSONDecodeError, OSError):
                got = None
        # Normalize non-string answers (e.g. {"answer": 408}) so "answered"
        # never exceeds what graders can actually credit — write-time schema
        # validation can be bypassed by manual runs / external answer dirs.
        if got is not None and not isinstance(got, str):
            got = str(got)
        hit = int(grade_fn(q, got))
        answered += int(got is not None)
        correct += hit
        groups.setdefault(q[group_key], []).append(hit)
    result = {
        "run_id": run_id,
        "total": len(key),
        "answered": answered,
        "correct": correct,
        "accuracy": correct / max(1, len(key)),
        group_field: {g: sum(v) / len(v) for g, v in sorted(groups.items())},
    }
    out = os.path.join(workspace, "runs", run_id, "score.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return result


def run_cli(grove_dir: str, default_workspace: str,
            grade_fn: Callable[[dict, object], bool], group_key: str,
            group_field: str, secret_fields: Sequence[str],
            doc: str) -> int:
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--prepare", action="store_true")
    ap.add_argument("--run", metavar="RUN_ID")
    ap.add_argument("--workspace", default=default_workspace)
    args = ap.parse_args()
    if args.prepare:
        prepare(args.workspace, grove_dir, secret_fields)
        return 0
    if args.run:
        print(json.dumps(score(args.workspace, args.run, grove_dir,
                               grade_fn, group_key, group_field), indent=1))
        return 0
    ap.print_help()
    return 2
