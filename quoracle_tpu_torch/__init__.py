"""quoracle_tpu_torch — the PyTorch/CUDA port of quoracle_tpu.

The JAX package (``quoracle_tpu``) stays the reference; this package serves
the same models on an NVIDIA GPU with PyTorch for the tensor code and hand
written CUDA kernels (``csrc/``) where the JAX package runs Pallas kernels.
It imports ``torch`` and never ``jax`` or ``quoracle_tpu``: the framework
free modules it needs (model catalog, JSON grammar tables, BPE tokenizer)
are its own copies. Layout mirrors the JAX package module for module.
"""
