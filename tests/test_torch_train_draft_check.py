"""The port's draft-training smoke (quoracle_tpu_torch/tools/
train_draft.py --check), tests/test_train_draft_check.py's two cases on
the CPU: tiny target + tiny draft trained a few steps on the format
corpus, held-out acceptance asserted above the floor, greedy
bit-equality against vanilla decode; and an impossible floor raises."""

import argparse

import pytest
import torch

torch.set_num_threads(1)


def test_train_draft_check_passes_floor(tmp_path):
    from quoracle_tpu_torch.tools.train_draft import run_check

    args = argparse.Namespace(
        steps=20, batch=8, seq=192, lr=1e-3, seed=0, corpus_size=250,
        k=4, n_eval=2, max_new=32, workdir=str(tmp_path),
        check_floor=0.1, device="cpu")
    payload = run_check(args)
    assert payload["ok"]
    assert payload["value"] >= 0.1
    a, b = payload["greedy_equal"].split("/")
    assert a == b


def test_train_draft_check_floor_trips_on_regression(tmp_path):
    """The floor is a real gate: an impossible floor must raise, not
    silently pass — proving a collapsed draft would fail the check."""
    from quoracle_tpu_torch.tools.train_draft import run_check

    args = argparse.Namespace(
        steps=2, batch=4, seq=192, lr=1e-3, seed=1, corpus_size=60,
        k=4, n_eval=1, max_new=16, workdir=str(tmp_path),
        check_floor=1.01, device="cpu")
    with pytest.raises(AssertionError, match="floor"):
        run_check(args)
