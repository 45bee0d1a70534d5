"""Checkpoint tokenizers in the PyTorch port (quoracle_tpu_torch/models/
tokenizer.py: ``HFTokenizer``, ``HFAutoTokenizer``, ``get_tokenizer``;
make_checkpoint.py's ``tokenizer.json``) against the JAX package's
tokenizers, which wrap ``tokenizers`` and ``transformers``, on the CPU.
Every comparison is exact: ids, texts, vocab sizes, special ids, chat
encodings and the JSON grammar tables built from per-id decodes.

The files: the JAX ``make_checkpoint``'s tiny llama and gemma (BPE
trained by ``tokenizers``), variants of them written here (llama-3's
``Split`` pre-tokenizer with ``ignore_merges`` and added tokens of every
flag, ``add_prefix_space``, ``unk_token`` fused and not, ``ByteLevel``
without its regex), and the port's own ``tokenizer.json``.
"""

import copy
import json
import os
import random
import shutil

import numpy as np
import pytest
from tokenizers import Tokenizer as LibTokenizer
from transformers import AutoTokenizer

from quoracle_tpu.models import config as jconfig
from quoracle_tpu.models import constrained as jcons
from quoracle_tpu.models import loader as jload
from quoracle_tpu.models import make_checkpoint as jmk
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu_torch.models import config as tconfig
from quoracle_tpu_torch.models import constrained as tcons
from quoracle_tpu_torch.models import loader as tload
from quoracle_tpu_torch.models import make_checkpoint as tmk
from quoracle_tpu_torch.models import tokenizer as ttok

# llama-3's pre-tokenizer pattern, as its tokenizer.json ships it
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")
ATOMS = [
    "hello", " world", "I'm", "don't", "we've", "they'll", "She'd", " 's",
    "IT'S", "AB'S", "x²", "½ cup", "٣٣", "1234567", "12345678", "漢字かな",
    "😀👍🏽", "   ", "\t\t", "\n\n", " \n ", "\r\n", "\r\r\n", "<|bos|>",
    "<|user|>", "<|eos|>x", "a<|pad|>b", "café", "naïve", "Ωmega", "\x1c",
    "　", "\xa0", " ", "foo_bar", '{"a": 1}', "...", "?!",
    "   end", "ß", "ŉ", "́", "\U0001F600", "\x00", "\x7f", "ſ",
]
EXTRA = ["<|eot_id|>", " ls", "  ls", "rs  ", "word", "a word b", "words",
         "héllo", "Héllo", "x 'S"]


def corpus(seed: int = 0, n: int = 200, extra: bool = False):
    rng = random.Random(seed)
    atoms = ATOMS + (EXTRA if extra else [])
    return ["".join(rng.choice(atoms) for _ in range(rng.randint(1, 12)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_made(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax-made")
    return {fam: jmk.make_checkpoint(str(root / fam), family=fam,
                                     scale="tiny", seed=i)
            for i, fam in enumerate(("llama", "gemma"))}


def _tj(d: str) -> str:
    return os.path.join(d, "tokenizer.json")


# ---------------------------------------------------------------------------
# against the JAX package's tokenizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_hf_tokenizer_matches_jax(jax_made, family):
    path = _tj(jax_made[family])
    ref = jtok.HFTokenizer(path, bos_id=1, eos_id=2)
    got = ttok.HFTokenizer(path, bos_id=1, eos_id=2)
    assert got.vocab_size == ref.vocab_size
    assert (got.bos_id, got.eos_id, got.pad_id) == (ref.bos_id, ref.eos_id,
                                                     ref.pad_id)
    for text in corpus(seed=1):
        ids = got.encode(text, add_bos=True)
        assert ids == ref.encode(text, add_bos=True), text
        assert got.decode(ids) == ref.decode(ids)
        assert got.decode_raw(ids) == ref.decode_raw(ids)


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_auto_tokenizer_matches_jax(jax_made, family):
    ref = jtok.HFAutoTokenizer(jax_made[family])
    got = ttok.HFAutoTokenizer(jax_made[family])
    assert got.vocab_size == ref.vocab_size
    assert (got.bos_id, got.eos_id, got.pad_id) == (ref.bos_id, ref.eos_id,
                                                     ref.pad_id)
    texts = corpus(seed=2)
    for a, b in zip(texts, texts[1:]):
        for add_bos in (False, True):
            ids = got.encode(a, add_bos=add_bos)
            assert ids == ref.encode(a, add_bos=add_bos), a
        assert got.count(a) == ref.count(a)
        assert got.decode(ids) == ref.decode(ids)
        assert got.decode_raw(ids) == ref.decode_raw(ids)
        msgs = [{"role": "system", "content": a},
                {"role": "user", "content": b},
                {"role": "assistant", "content": [{"type": "text",
                                                   "text": a}]}]
        assert got.encode_chat(msgs) == ref.encode_chat(msgs)


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_per_id_decodes_build_equal_json_tables(jax_made, family):
    """Every id of the vocab (and past it) decodes alike, so
    ``JsonTokenTable.for_tokenizer`` builds the same tables."""
    ref = jtok.HFAutoTokenizer(jax_made[family])
    got = ttok.HFAutoTokenizer(jax_made[family])
    for tid in range(got.vocab_size + 8):
        assert got.decode([tid]) == ref.decode([tid]), tid
        assert got.decode_raw([tid]) == ref.decode_raw([tid]), tid
    for enum in (None, ("orient", "wait")):
        a = jcons.JsonTokenTable.for_tokenizer(ref, 2048, ref.eos_id,
                                               action_enum=enum)
        b = tcons.JsonTokenTable.for_tokenizer(got, 2048, got.eos_id,
                                               action_enum=enum)
        assert np.array_equal(a.table, b.table)
        assert (a.start_state, a.n_states) == (b.start_state, b.n_states)


def test_invalid_utf8_is_replaced_as_the_library_replaces_it(jax_made):
    """Ids that stop inside a multi-byte character, or start in its
    middle, decode to U+FFFD as ``tokenizers`` decodes them."""
    lib = LibTokenizer.from_file(_tj(jax_made["llama"]))
    got = ttok.HFTokenizer(_tj(jax_made["llama"]))
    ids = got.encode("漢字かな😀 café ½")
    for lo in range(len(ids)):
        for hi in range(lo, len(ids) + 1):
            assert got.decode(ids[lo:hi]) == lib.decode(ids[lo:hi])


# ---------------------------------------------------------------------------
# against the tokenizers library, on files the JAX package never reads
# ---------------------------------------------------------------------------

def _split_form(d: dict) -> None:
    d["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
         "behavior": "Isolated", "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False,
         "trim_offsets": True, "use_regex": False}]}
    d["model"]["ignore_merges"] = True
    v = len(d["model"]["vocab"])
    flags = ("single_word", "lstrip", "rstrip", "normalized", "special")
    for i, (content, on) in enumerate([
            ("<|eot_id|>", ("special",)), (" ls", ("lstrip",)),
            ("rs", ("rstrip", "normalized")),
            ("word", ("single_word", "normalized")), ("héllo", ())]):
        d["added_tokens"].append({"id": v + i, "content": content,
                                  **{f: f in on for f in flags}})


def _prefix(d: dict) -> None:
    d["pre_tokenizer"]["add_prefix_space"] = True


def _split_prefix(d: dict) -> None:
    _split_form(d)
    d["pre_tokenizer"]["pretokenizers"][1]["add_prefix_space"] = True


def _unk(fuse: bool):
    def edit(d: dict) -> None:
        d["model"]["unk_token"] = "<|pad|>"
        d["model"]["fuse_unk"] = fuse
    return edit


def _no_regex(d: dict) -> None:
    d["pre_tokenizer"]["use_regex"] = False


def _merge_strings(d: dict) -> None:
    d["model"]["merges"] = [" ".join(m) for m in d["model"]["merges"]]


VARIANTS = {"split": _split_form, "split_prefix": _split_prefix,
            "prefix": _prefix, "unk": _unk(False), "unk_fused": _unk(True),
            "no_regex": _no_regex, "merge_strings": _merge_strings}


def _variant(base: str, edit, out) -> str:
    with open(_tj(base), encoding="utf-8") as f:
        d = json.load(f)
    d = copy.deepcopy(d)
    edit(d)
    path = str(out / "tokenizer.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(d, f, ensure_ascii=False)
    return path


def _matches_library(path: str, texts) -> None:
    lib = LibTokenizer.from_file(path)
    got = ttok.HFTokenizer(path)
    assert got.vocab_size == lib.get_vocab_size()
    for text in texts:
        ids = lib.encode(text, add_special_tokens=False).ids
        assert got.encode(text) == ids, text
        for skip in (True, False):
            assert got.decode_ids(ids, skip) == lib.decode(
                ids, skip_special_tokens=skip)
    for tid in range(lib.get_vocab_size() + 4):
        for skip in (True, False):
            assert got.decode_ids([tid], skip) == lib.decode(
                [tid], skip_special_tokens=skip), tid


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_files_encode_as_the_library(jax_made, variant, tmp_path):
    path = _variant(jax_made["llama"], VARIANTS[variant], tmp_path)
    _matches_library(path, corpus(seed=3, n=150, extra=True))


@pytest.mark.parametrize("vocab", [263, 2048, 128256])
def test_port_tokenizer_json_encodes_as_the_library(vocab, tmp_path):
    """make_checkpoint's file (the port's merges, cut to the vocab) read
    by ``tokenizers`` gives the port's ids; at 128256 it holds all 16,000
    merges."""
    tmk.make_tokenizer_files(str(tmp_path), vocab)
    path = _tj(str(tmp_path))
    lib = LibTokenizer.from_file(path)
    assert lib.get_vocab_size() == min(vocab, 7 + 256 + 16000)
    _matches_library(path, corpus(seed=4, n=120))


def test_port_checkpoint_tokenizer_matches_transformers(tmp_path):
    d = tmk.make_checkpoint(str(tmp_path / "ck"), family="gemma",
                            scale="tiny", seed=0)
    ref = AutoTokenizer.from_pretrained(d, local_files_only=True)
    got = ttok.HFAutoTokenizer(d)
    assert got.vocab_size == len(ref)
    assert (got.bos_id, got.eos_id, got.pad_id) == (
        ref.bos_token_id, ref.eos_token_id, ref.pad_token_id)
    for text in corpus(seed=5, n=60):
        msgs = [{"role": "user", "content": text}]
        assert got.encode_chat(msgs) == list(ref.apply_chat_template(
            msgs, add_generation_prompt=True, tokenize=True))


RICH_TEMPLATE = (
    "{%- set sys = messages[0]['content'] if messages[0]['role'] == "
    "'system' else none -%}\n"
    "{{ bos_token }}\n"
    "{% for m in messages %}\n"
    "  {% if m['role'] == 'system' %}{% continue %}{% endif %}\n"
    "  {% if m['role'] not in ['user', 'assistant'] %}"
    "{{ raise_exception('bad role') }}{% endif %}\n"
    "<|{{ m['role'] }}|>{{ m['content'] | trim }}"
    "{% if sys %} {{ {'sys': sys, 'n': loop.index} | tojson }}{% endif %}"
    "{{ eos_token }}\n"
    "{% endfor %}\n"
    "{% if add_generation_prompt %}<|assistant|>{% endif %}")


def test_chat_template_renders_as_transformers(jax_made, tmp_path):
    """A template with whitespace control, trim_blocks/lstrip_blocks,
    loop controls, ``tojson`` of non-ASCII and ``raise_exception``:
    the same ids as ``apply_chat_template``; a bad role raises."""
    d = shutil.copytree(jax_made["llama"], str(tmp_path / "ck"))
    conf_path = os.path.join(d, "tokenizer_config.json")
    with open(conf_path) as f:
        conf = json.load(f)
    conf["chat_template"] = RICH_TEMPLATE
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    ref = AutoTokenizer.from_pretrained(d, local_files_only=True)
    got = ttok.HFAutoTokenizer(d)
    for text in corpus(seed=6, n=40):
        msgs = [{"role": "system", "content": "règle " + text},
                {"role": "user", "content": "  " + text + "  "},
                {"role": "assistant", "content": text[::-1]}]
        assert got.encode_chat(msgs) == list(ref.apply_chat_template(
            msgs, add_generation_prompt=True, tokenize=True))
    import jinja2
    with pytest.raises(jinja2.exceptions.TemplateError, match="bad role"):
        got.encode_chat([{"role": "tool", "content": "x"}])


ALT_TEMPLATE = ("{% for m in messages %}[{{ m['role'] | upper }}] "
                "{{ m['content'] }}{{ eos_token }}{% endfor %}"
                "{% if add_generation_prompt %}[ASSISTANT] {% endif %}")


@pytest.mark.parametrize("source", ["jinja_file", "named_list"])
def test_chat_template_sources_as_transformers(jax_made, tmp_path, source):
    """The template from ``chat_template.jinja`` beside the config (it
    wins over the config's), or from the config's named list ("default")."""
    d = shutil.copytree(jax_made["gemma"], str(tmp_path / "ck"))
    conf_path = os.path.join(d, "tokenizer_config.json")
    with open(conf_path) as f:
        conf = json.load(f)
    if source == "jinja_file":
        with open(os.path.join(d, "chat_template.jinja"), "w") as f:
            f.write(ALT_TEMPLATE)
    else:
        conf["chat_template"] = [{"name": "tool_use", "template": "x"},
                                 {"name": "default",
                                  "template": ALT_TEMPLATE}]
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    ref = AutoTokenizer.from_pretrained(d, local_files_only=True)
    got = ttok.HFAutoTokenizer(d)
    for text in corpus(seed=8, n=20):
        msgs = [{"role": "system", "content": text},
                {"role": "user", "content": text[:5]}]
        want = list(ref.apply_chat_template(msgs, add_generation_prompt=True,
                                            tokenize=True))
        assert got.encode_chat(msgs) == want
        assert "[ASSISTANT]" in got.decode_raw(want)


def test_missing_special_tokens_are_added_as_transformers_adds_them(
        jax_made, tmp_path):
    """A bos and an additional special token that tokenizer.json lacks:
    ``transformers`` adds them as special tokens past the vocab, so they
    split out of text and skip in decode; ``clean_up_tokenization_spaces``
    as the config says."""
    d = shutil.copytree(jax_made["llama"], str(tmp_path / "ck"))
    conf_path = os.path.join(d, "tokenizer_config.json")
    with open(conf_path) as f:
        conf = json.load(f)
    conf.update(bos_token="<s>", additional_special_tokens=["<|tool|>"],
                clean_up_tokenization_spaces=True)
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    ref = AutoTokenizer.from_pretrained(d, local_files_only=True)
    got = ttok.HFAutoTokenizer(d)
    assert got.vocab_size == len(ref)
    assert got.bos_id == ref.bos_token_id
    for text in ["<s>hi <|tool|> there .", "a , b ? c ! don 't",
                 *corpus(seed=7, n=30)]:
        ids = ref.encode(text, add_special_tokens=False)
        assert got.encode(text) == ids
        assert got.decode(ids) == ref.decode(ids, skip_special_tokens=True)
        msgs = [{"role": "user", "content": text}]
        assert got.encode_chat(msgs) == list(ref.apply_chat_template(
            msgs, add_generation_prompt=True, tokenize=True))


# ---------------------------------------------------------------------------
# get_tokenizer, and what raises
# ---------------------------------------------------------------------------

def test_get_tokenizer_branches(jax_made):
    name = "tok-branch-test"
    for mod in (jconfig, tconfig):
        mod.register_model(mod.ModelConfig(
            name=name, vocab_size=2048, dim=64, n_layers=1, n_heads=4,
            n_kv_heads=2, ffn_dim=128, bos_token_id=1, eos_token_id=2))
    path = _tj(jax_made["llama"])
    got = ttok.get_tokenizer(name, tokenizer_path=path)
    ref = jtok.get_tokenizer(name, tokenizer_path=path)
    assert isinstance(got, ttok.HFTokenizer)
    assert (got.bos_id, got.eos_id) == (ref.bos_id, ref.eos_id) == (1, 2)
    text = "branch: café 12345 <|user|>"
    assert got.encode(text, add_bos=True) == ref.encode(text, add_bos=True)
    assert isinstance(ttok.get_tokenizer(name), ttok.NativeBPETokenizer)
    # a checkpoint's entry: its own tokenizer, one instance per key
    cfg = tload.register_hf_checkpoint(jax_made["gemma"], name="tok-ck")
    assert cfg.checkpoint_path == jax_made["gemma"]
    tok = ttok.get_tokenizer("xla:tok-ck")
    assert isinstance(tok, ttok.HFAutoTokenizer)
    assert tok is ttok.get_tokenizer("xla:tok-ck")


def test_get_tokenizer_not_stale_after_registration(jax_made):
    """As the JAX test: a lookup made BEFORE registration must not pin the
    fallback tokenizer once the name is registered with a checkpoint."""
    name = "stale-tok-test-port"
    for tk, ld in ((jtok, jload), (ttok, tload)):
        t1 = tk.get_tokenizer(name)
        assert not isinstance(t1, tk.HFAutoTokenizer)
        ld.register_hf_checkpoint(jax_made["llama"], name=name)
        assert isinstance(tk.get_tokenizer(name), tk.HFAutoTokenizer)
    # registered again over another checkpoint: a new tokenizer
    tload.register_hf_checkpoint(jax_made["gemma"], name=name)
    t3 = ttok.get_tokenizer(name)
    assert t3._tok.path == _tj(jax_made["gemma"])


# The files the port refused while it read byte-level BPE only. Each is
# now held against the library where the library reads it (the file's
# truncation and padding apply in HFTokenizer and not in HFAutoTokenizer,
# as in the JAX package), and refused by both packages where the library
# refuses it (a malformed Unigram, WordPiece or Metaspace; a subword
# prefix the library's merge table panics on; a partial truncation).
UNSUPPORTED = {
    "normalizer_nfc": lambda d: d.update(normalizer={"type": "NFC"}),
    "truncation": lambda d: d.update(
        truncation={"max_length": 8, "strategy": "LongestFirst",
                    "stride": 0, "direction": "Left"},
        padding={"strategy": {"Fixed": 10}, "direction": "Right",
                 "pad_to_multiple_of": None, "pad_id": 0, "pad_type_id": 0,
                 "pad_token": "<|pad|>"}),
    "truncation_partial": lambda d: d.update(truncation={"max_length": 8}),
    "model_unigram": lambda d: d["model"].update(type="Unigram"),
    "model_wordpiece": lambda d: d["model"].update(type="WordPiece"),
    "byte_fallback": lambda d: d["model"].update(byte_fallback=True),
    "subword_prefix": lambda d: d["model"].update(
        continuing_subword_prefix="##"),
    "pre_metaspace": lambda d: d.update(pre_tokenizer={
        "type": "Metaspace", "replacement": "▁"}),
    "pre_none": lambda d: d.update(pre_tokenizer=None),
    "split_removed": lambda d: d.update(pre_tokenizer={
        "type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"String": " "},
             "behavior": "Removed", "invert": False},
            dict(d["pre_tokenizer"])]}),
    "split_word_class": lambda d: d.update(pre_tokenizer={
        "type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": r"\w+"},
             "behavior": "Isolated", "invert": False},
            dict(d["pre_tokenizer"])]}),
    "decoder_metaspace": lambda d: d.update(decoder={"type": "Metaspace"}),
    "decoder_none": lambda d: d.update(decoder=None),
}
REFUSED_BY_BOTH = {"truncation_partial", "model_unigram", "model_wordpiece",
                   "subword_prefix", "decoder_metaspace"}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_components_raise(jax_made, case, tmp_path):
    path = _variant(jax_made["llama"], UNSUPPORTED[case], tmp_path)
    if case in REFUSED_BY_BOTH:
        # a library panic is a BaseException
        with pytest.raises(BaseException):
            LibTokenizer.from_file(path)
        with pytest.raises(BaseException):
            jtok.HFTokenizer(path)
        with pytest.raises((NotImplementedError, ValueError)):
            ttok.HFTokenizer(path)
        return
    texts = corpus(seed=3, n=150, extra=True)
    _matches_library(path, texts)
    ref = jtok.HFTokenizer(path, bos_id=1, eos_id=2)
    got = ttok.HFTokenizer(path, bos_id=1, eos_id=2)
    for text in texts:
        ids = ref.encode(text, add_bos=True)
        assert got.encode(text, add_bos=True) == ids, text
        assert got.decode(ids) == ref.decode(ids)
    if case != "truncation":
        return
    # the split: a bare file truncates (keeping the left end here) and
    # pads; the checkpoint's AutoTokenizer does neither
    d = shutil.copytree(jax_made["llama"], str(tmp_path / "ck"))
    shutil.copy(path, os.path.join(d, "tokenizer.json"))
    auto_ref, auto_got = jtok.HFAutoTokenizer(d), ttok.HFAutoTokenizer(d)
    assert auto_got.pad_id == auto_ref.pad_id
    long = [t for t in texts if len(auto_ref.encode(t)) > 8]
    assert long and all(len(got.encode(t)) == 10 for t in texts)
    for text in texts:
        full = auto_ref.encode(text)
        assert auto_got.encode(text) == full, text
        if len(full) > 8:
            assert got.encode(text)[:8] == full[-8:]


def test_checkpoint_without_tokenizer_json_raises(tmp_path):
    (tmp_path / "sp").mkdir()
    (tmp_path / "sp" / "tokenizer.model").write_bytes(b"\0")
    with pytest.raises(NotImplementedError, match="SentencePiece"):
        ttok.HFAutoTokenizer(str(tmp_path / "sp"))
    (tmp_path / "none").mkdir()
    with pytest.raises(ValueError, match="no tokenizer files"):
        ttok.HFAutoTokenizer(str(tmp_path / "none"))
