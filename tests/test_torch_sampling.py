"""Sampling, grammar and tokenizer parity of the PyTorch port against the
JAX package, on the CPU.

Greedy picks, the nucleus keep-set, the grammar mask and the copied
numpy/Python modules (JSON grammar tables, BPE tokenizer) must agree
EXACTLY: they are integer and boolean results, with no tolerance.
Sampled tokens cannot match (torch.Generator and jax.random draw other
bits from one seed), so they are held to the keep-set instead.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quoracle_tpu.models import constrained as jcons
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import sampling as jsamp
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.native import tokenizer as jnative
from quoracle_tpu_torch.models import constrained as tcons
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import sampling as tsamp
from quoracle_tpu_torch.models import tokenizer as ttok

# tier-1 runs several xdist workers on a few cores: torch's own thread
# pool would oversubscribe them and spin between the small ops here
torch.set_num_threads(1)


def _logits(seed, B=6, V=300):
    rng = np.random.default_rng(seed)
    return (3.0 * rng.standard_normal((B, V))).astype(np.float32)


def test_greedy_matches_exactly():
    x = _logits(0)
    x[2, 17] = x[2, 40] = x[2].max() + 1.0        # a tie: first index wins
    temp = np.zeros((x.shape[0],), np.float32)
    top = np.ones_like(temp)
    ref = jsamp.sample_tokens(jnp.asarray(x), jax.random.PRNGKey(0),
                              jnp.asarray(temp), jnp.asarray(top))
    got = tsamp.sample_tokens(torch.from_numpy(x), torch.Generator(),
                              torch.from_numpy(temp), torch.from_numpy(top))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(ref).tolist()
    assert got[2].item() == 17


def test_nucleus_keep_set_matches_exactly(monkeypatch):
    """The JAX sampler's masked logits are captured at its categorical
    draw (the package's own code computes them); the port's keep-set must
    be the same set of tokens, and its draws must stay inside it."""
    x = _logits(1)
    temp = np.array([1.0, 0.7, 0.3, 1.5, 1.0, 0.9], np.float32)
    top = np.array([0.9, 0.5, 0.8, 0.95, 0.05, 0.7], np.float32)
    seen = {}

    def capture(key, logits, axis=-1):
        seen["masked"] = np.asarray(logits)
        return jnp.argmax(logits, axis=axis)

    monkeypatch.setattr(jsamp.jax.random, "categorical", capture)

    def keep_sets(top):
        jsamp.sample_tokens(jnp.asarray(x), jax.random.PRNGKey(0),
                            jnp.asarray(temp), jnp.asarray(top))
        scaled = torch.from_numpy(x) / torch.from_numpy(temp)[:, None]
        return (np.isfinite(seen["masked"]),
                tsamp.nucleus_keep(scaled, torch.from_numpy(top)).numpy())

    jkeep, tkeep = keep_sets(top)
    assert np.array_equal(tkeep, jkeep)
    # top_p = 1.0: the cutoff falls where the fp32 cumsum reaches 1.0,
    # which each framework rounds its own way; the tokens the two sides
    # disagree on carry less than 1e-6 of the probability mass
    jall, tall = keep_sets(np.ones_like(top))
    probs = torch.softmax(torch.from_numpy(x / temp[:, None]), -1).numpy()
    assert (probs * (jall != tall)).sum(-1).max() < 1e-6
    assert jkeep[4].sum() == 1            # top_p 0.05 keeps only the max
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        tok = tsamp.sample_tokens(torch.from_numpy(x), gen,
                                  torch.from_numpy(temp),
                                  torch.from_numpy(top)).numpy()
        assert jkeep[np.arange(len(tok)), tok].all()


def test_grammar_mask_matches_including_dead_end_eos():
    rng = np.random.default_rng(2)
    V, eos = 40, 2
    table = rng.integers(-1, 5, (6, V)).astype(np.int16)
    table[3] = -1                          # dead-end state: nothing allowed
    x = _logits(3, B=5, V=V)
    jstate = np.array([0, 3, -1, 5, 3], np.int32)   # -1 = unconstrained
    ref = jgen.grammar_mask(jnp.asarray(x), jnp.asarray(jstate),
                            jnp.asarray(table), eos)
    got = tgen.grammar_mask(torch.from_numpy(x), torch.from_numpy(jstate),
                            torch.from_numpy(table), eos)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    allowed = got.numpy() > tgen.NEG_INF_LOGITS
    assert allowed[1].tolist() == [t == eos for t in range(V)]
    assert allowed[2].all()


@pytest.mark.parametrize("enum", [None, ("orient", "wait")])
def test_json_token_table_copy_equals_original(enum):
    tok = ttok.get_tokenizer("xla:tiny")
    kw = dict(extra_stop_ids=(), action_enum=enum)
    ref = jcons.JsonTokenTable.for_tokenizer(jtok.get_tokenizer("xla:tiny"),
                                             512, 2, **kw)
    got = tcons.JsonTokenTable.for_tokenizer(tok, 512, 2, **kw)
    assert np.array_equal(got.table, ref.table)
    assert got.table.dtype == ref.table.dtype
    assert got.start_state == ref.start_state
    assert got.n_states == ref.n_states
    assert np.array_equal(got.accept, ref.accept)


TEXTS = [
    "",
    "pick a plan for the task",
    '{"action": "wait", "params": {"reason": "x"}}',
    "  leading  and\ttabs\r\nnewlines\n\n end ",
    "unicode: café naïve 日本語 — ✓ 🎉🎉",
    "x" * 300 + " long_word_" * 20,
    "def f(a, b):\n    return a + b  # comment\n",
]


@pytest.mark.parametrize("spec", ["xla:tiny", "xla:llama-1b"])
def test_tokenizer_copy_matches_jax_package(spec):
    """vocab 512 (byte prefix + 253 merges) and 32768 (the full merges
    file): ids, decodes and chat encodes are identical."""
    ref = jtok.get_tokenizer(spec)
    got = ttok.get_tokenizer(spec)
    assert got.vocab_size == ref.vocab_size
    assert (got.bos_id, got.eos_id, got.pad_id) == (ref.bos_id, ref.eos_id,
                                                     ref.pad_id)
    for text in TEXTS:
        ids = got.encode(text, add_bos=True)
        assert ids == ref.encode(text, add_bos=True)
        assert got.decode(ids) == ref.decode(ids)
    msgs = [{"role": "system", "content": "rules"},
            {"role": "user", "content": [{"type": "text", "text": "hi"},
                                         {"type": "image", "data": "AAA"}]}]
    assert got.encode_chat(msgs) == ref.encode_chat(msgs)
    ids = list(range(0, got.vocab_size, 97))
    assert got.decode(ids) == ref.decode(ids)


def test_merges_copy_is_byte_identical():
    assert filecmp.cmp(ttok.MERGES_PATH, jnative.MERGES_PATH, shallow=False)
