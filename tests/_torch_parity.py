"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py):
the tiny model variants both packages register, and one set of fp32
weights handed to both sides through the port's weights bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from quoracle_tpu.models import config as jconfig
from quoracle_tpu.models.transformer import init_params as jax_init_params
from quoracle_tpu_torch.models import config as tconfig
from quoracle_tpu_torch.models.convert import params_from_jax

# Variants of the catalog's "tiny" that the catalog lacks: a sliding
# window smaller than the test prompts (the windowed masks and page
# trimming), and Qwen-style QKV biases.
VARIANTS = {
    "tiny-window": dict(sliding_window=16),
    "tiny-qwen": dict(attn_bias=True),
}


def register_variants() -> None:
    for mod in (jconfig, tconfig):
        base = mod.get_model_config("tiny")
        for name, kw in VARIANTS.items():
            mod.register_model(dataclasses.replace(base, name=name, **kw))


register_variants()


def both_configs(name: str):
    return jconfig.get_model_config(name), tconfig.get_model_config(name)


def shared_params(name: str, seed: int = 0):
    """fp32 weights for both sides: the JAX params pytree and the port's
    Transformer built from its numpy copy. Norm weights and biases start
    constant in ``init_params``; they are redrawn here so a swapped or
    untransposed leaf cannot hide."""
    jcfg, tcfg = both_configs(name)
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed),
                             dtype=jnp.float32)
    tree = jax.device_get(params)
    rng = np.random.default_rng(seed + 100)
    layers = dict(tree["layers"])
    for leaf in ("attn_norm", "mlp_norm", "bq", "bk", "bv"):
        if leaf in layers:
            layers[leaf] = (0.1 * rng.standard_normal(
                layers[leaf].shape)).astype(np.float32) + (
                    0.0 if leaf.startswith("b") or jcfg.rmsnorm_plus_one
                    else 1.0)
    tree = dict(tree, layers=layers)
    tree["final_norm"] = (np.asarray(tree["final_norm"])
                          + 0.1 * rng.standard_normal(
                              tree["final_norm"].shape)
                          ).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    return params, params_from_jax(tree, tcfg, device="cpu")
