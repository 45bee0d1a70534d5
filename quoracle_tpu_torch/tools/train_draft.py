"""Runnable shim of the draft-training check (port of
``quoracle_tpu/tools/train_draft.py``): the trainer lives at
:mod:`quoracle_tpu_torch.training.draft_check`, and this module keeps the
entry point

    python -m quoracle_tpu_torch.tools.train_draft --check

and ``run_check``/``main`` importable from here.
"""

from __future__ import annotations

from quoracle_tpu_torch.training.draft_check import main, run_check

__all__ = ["main", "run_check"]

if __name__ == "__main__":
    main()
