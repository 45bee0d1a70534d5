"""Serving flywheel: capture -> train -> evaluate -> promote (port of
``quoracle_tpu/training/``).

The fleet already generates its own training signal — accepted/rejected
speculation chunks and consensus winners with full audit records — and
the fleet controller's drain gives zero-downtime draft hot-swap. This
package connects them:

* :mod:`quoracle_tpu_torch.training.capture` — a bounded, crash-safe,
  append-only replay store of training examples tapped read-only off
  the serving path (``QUORACLE_TRAIN_CAPTURE=0`` kills the plane;
  temp-0 bits are identical either way). Segments are the JAX
  package's byte for byte.
* :mod:`quoracle_tpu_torch.training.trainer` — the distillation trainer
  on one card: hard CE on target corrections + acceptance-weighted CE on
  accepted chunks, through the serving transformer's layers and the flash
  kernel's forward and backward kernels.
* :mod:`quoracle_tpu_torch.training.evaluate` — offline acceptance replay
  of a held-out capture slice through the REAL ``verify_chunk`` path.
* :mod:`quoracle_tpu_torch.training.promote` — the bench-gated promotion:
  margin + greedy-equality gate, per-replica drain/hot-swap through the
  fleet controller's ledger, instant rollback, and a live
  acceptance-regression guard that auto-rolls back.
* :mod:`quoracle_tpu_torch.training.draft_check` — the
  ``tools/train_draft.py`` smoke (``--check``).
"""
