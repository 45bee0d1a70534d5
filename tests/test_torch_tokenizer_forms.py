"""Checkpoint tokenizers beyond byte-level BPE in the PyTorch port
(quoracle_tpu_torch/models/tokenizer.py over tokenizer_pipeline.py)
against the JAX package's ``HFTokenizer`` and ``HFAutoTokenizer``, which
wrap ``tokenizers`` and ``transformers``, on the CPU.

The files are trained here by ``tokenizers``' trainers (BPE in the
SentencePiece form, with the 256 ``<0xXX>`` byte tokens added to the
vocab as ordinary entries, never as specials; Unigram; WordPiece; BPE
with a subword prefix or a word suffix) and each is dressed in
normalizers, pre-tokenizers and decoders: every component the port
reads. Besides: chip_smoke.py's Mistral- and Gemma-form writer (its ids'
digests are the golden file the chip run checks), GPT-2 and BERT
slow-tokenizer directories, and the directories both packages refuse.
Every comparison is exact: ids, decodes, raw decodes, every id's decode,
vocab sizes, special ids, chat encodings and JSON grammar tables.
"""

import copy
import importlib.util
import json
import os

import numpy as np
import pytest
from tokenizers import Tokenizer as LibTokenizer
from tokenizers import models, normalizers, pre_tokenizers, trainers

from quoracle_tpu.models import constrained as jcons
from quoracle_tpu.models import make_checkpoint as jmk
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu_torch.models import constrained as tcons
from quoracle_tpu_torch.models import tokenizer as ttok
from test_torch_hf_tokenizer import corpus

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SP = "▁"
SPECIALS = ["<unk>", "<s>", "</s>", "<pad>"]
ENGLISH = [
    "The consensus pipeline clusters proposals by fingerprint.",
    "Agents decide the next step; the majority runs. Don't wait!",
    "Naïve café owners in Zürich sell 12 croissants for ½ price.",
    "def f(x):\n    return x + 1  # add one\n",
    '{"action": "wait", "params": {"budget": 4}, "reasoning": "ok"}',
    "漢字かな交じり文 and emoji 😀 mixed with ٣٣ digits²",
]


def _training_texts() -> list:
    return ENGLISH * 20 + corpus(seed=10, n=300, extra=True)


def _train(model, trainer, normalizer=None, pre=None) -> dict:
    tok = LibTokenizer(model)
    tok.normalizer = normalizer
    tok.pre_tokenizer = pre
    tok.train_from_iterator(_training_texts(), trainer)
    return json.loads(tok.to_str())


def _add_byte_tokens(d: dict) -> None:
    """The 256 byte tokens as ordinary vocab entries, as the shipped
    SentencePiece-form files keep them."""
    m = d["model"]
    if m["type"] == "Unigram":
        low = min(s for _, s in m["vocab"]) - 1.0
        have = {p for p, _ in m["vocab"]}
        m["vocab"] += [[f"<0x{b:02X}>", low] for b in range(256)
                       if f"<0x{b:02X}>" not in have]
    else:
        for b in range(256):
            m["vocab"].setdefault(f"<0x{b:02X}>", len(m["vocab"]))


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """The trained models (tokenizer.json dicts) the forms dress."""
    sp_norm = normalizers.Sequence([normalizers.Prepend(SP),
                                    normalizers.Replace(" ", SP)])
    out = {
        "sp": _train(models.BPE(unk_token="<unk>", fuse_unk=True,
                                byte_fallback=True),
                     trainers.BpeTrainer(vocab_size=1200,
                                         special_tokens=SPECIALS),
                     normalizer=sp_norm),
        "ug": _train(models.Unigram(),
                     trainers.UnigramTrainer(vocab_size=600,
                                             special_tokens=SPECIALS,
                                             unk_token="<unk>"),
                     pre=pre_tokenizers.Metaspace()),
        "wp": _train(models.WordPiece(unk_token="[UNK]"),
                     trainers.WordPieceTrainer(
                         vocab_size=900, special_tokens=[
                             "[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]"]),
                     normalizer=normalizers.BertNormalizer(),
                     pre=pre_tokenizers.BertPreTokenizer()),
        "prefix": _train(models.BPE(unk_token="<unk>",
                                    continuing_subword_prefix="##"),
                         trainers.BpeTrainer(
                             vocab_size=900, special_tokens=SPECIALS,
                             continuing_subword_prefix="##"),
                         pre=pre_tokenizers.Whitespace()),
        "suffix": _train(models.BPE(unk_token="<unk>",
                                    end_of_word_suffix="</w>"),
                         trainers.BpeTrainer(
                             vocab_size=900, special_tokens=SPECIALS,
                             end_of_word_suffix="</w>"),
                         pre=pre_tokenizers.WhitespaceSplit()),
    }
    _add_byte_tokens(out["sp"])
    out["ug_bytes"] = copy.deepcopy(out["ug"])
    _add_byte_tokens(out["ug_bytes"])
    out["ug_bytes"]["model"]["byte_fallback"] = True
    root = tmp_path_factory.mktemp("jax-made")
    with open(os.path.join(jmk.make_checkpoint(
            str(root / "llama"), family="llama", scale="tiny", seed=0),
            "tokenizer.json"), encoding="utf-8") as f:
        out["bl"] = json.load(f)            # byte-level BPE
    return out


# -- components ----------------------------------------------------------

def _string(s):
    return {"String": s}


def _replace(pattern, content, regex=False):
    return {"type": "Replace", "content": content,
            "pattern": {"Regex": pattern} if regex else _string(pattern)}


def _seq_n(*steps):
    return {"type": "Sequence", "normalizers": list(steps)}


def _seq_p(*steps):
    return {"type": "Sequence", "pretokenizers": list(steps)}


def _seq_d(*steps):
    return {"type": "Sequence", "decoders": list(steps)}


def _split(pattern, behavior, invert=False, regex=True):
    return {"type": "Split", "behavior": behavior, "invert": invert,
            "pattern": {"Regex": pattern} if regex else _string(pattern)}


def _metaspace(scheme, split=True):
    return {"type": "Metaspace", "replacement": SP,
            "prepend_scheme": scheme, "split": split}


BL_PRE = {"type": "ByteLevel", "add_prefix_space": False,
          "trim_offsets": True, "use_regex": False}
SP_NORM = _seq_n({"type": "Prepend", "prepend": SP}, _replace(" ", SP))
SP_DEC = [_replace(SP, " "), {"type": "ByteFallback"}, {"type": "Fuse"}]
MISTRAL_DEC = _seq_d(*SP_DEC, {"type": "Strip", "content": " ",
                               "start": 1, "stop": 0})


def _bert_norm(**kw):
    d = {"type": "BertNormalizer", "clean_text": True,
         "handle_chinese_chars": True, "strip_accents": None,
         "lowercase": True}
    d.update(kw)
    return d


def _form(base, normalizer="keep", pre="keep", decoder="keep", **model):
    return base, normalizer, pre, decoder, model


# name -> (base, normalizer, pre_tokenizer, decoder, model edits);
# "keep" keeps the trained file's component
FORMS = {
    # SentencePiece-form BPE with byte fallback
    "sp_mistral": _form("sp", SP_NORM, None, MISTRAL_DEC),
    "sp_gemma": _form("sp", _replace(" ", SP), None, _seq_d(*SP_DEC)),
    "sp_metaspace_first": _form("sp", None, _metaspace("first", False),
                                MISTRAL_DEC),
    "sp_metaspace_always": _form(
        "sp", None, _metaspace("always"),
        _seq_d({"type": "ByteFallback"}, {"type": "Metaspace",
                                          "replacement": SP,
                                          "prepend_scheme": "always"})),
    "sp_metaspace_never": _form(
        "sp", _seq_n({"type": "NFKC"}), _metaspace("never"),
        _seq_d({"type": "ByteFallback"}, {"type": "Metaspace",
                                          "replacement": SP,
                                          "prepend_scheme": "never"})),
    "sp_split_metaspace_first": _form(
        "sp", _seq_n({"type": "Strip", "strip_left": True,
                      "strip_right": False}),
        _seq_p(_split(r"\p{N}", "Isolated"), _metaspace("first")),
        # per token, not after Fuse: the library's Strip panics on an
        # empty token when it strips from the right
        _seq_d(_replace(SP, " "), {"type": "ByteFallback"},
               {"type": "Strip", "content": " ", "start": 0, "stop": 1})),
    "sp_nfd_lower": _form(
        "sp", _seq_n({"type": "NFD"}, {"type": "StripAccents"},
                     {"type": "Lowercase"}, *SP_NORM["normalizers"]),
        None, MISTRAL_DEC),
    "sp_unk_not_fused": _form("sp", SP_NORM, None, MISTRAL_DEC,
                              byte_fallback=False, fuse_unk=False),
    "sp_unk_fused": _form("sp", SP_NORM, None, MISTRAL_DEC,
                          byte_fallback=False, fuse_unk=True),
    "sp_no_decoder": _form("sp", SP_NORM, None, None),
    # normalizers over byte-level BPE
    "bl_nfc": _form("bl", {"type": "NFC"}),
    "bl_nfd": _form("bl", {"type": "NFD"}),
    "bl_nfkc": _form("bl", {"type": "NFKC"}),
    "bl_nfkd": _form("bl", {"type": "NFKD"}),
    "bl_lowercase": _form("bl", {"type": "Lowercase"}),
    "bl_replace_regex": _form("bl", _replace(r"\s+", " ", regex=True)),
    "bl_strip": _form("bl", {"type": "Strip", "strip_left": True,
                             "strip_right": True}),
    "bl_strip_accents": _form("bl", _seq_n({"type": "NFKD"},
                                           {"type": "StripAccents"})),
    "bl_bert_normalizer": _form("bl", _bert_norm()),
    "bl_bert_cased": _form("bl", _bert_norm(lowercase=False,
                                            handle_chinese_chars=False,
                                            clean_text=False)),
    "bl_bert_accents": _form("bl", _bert_norm(strip_accents=True,
                                              lowercase=False)),
    # pre-tokenizers before ByteLevel
    **{f"bl_split_{b.lower()}{'_inv' if inv else ''}": _form(
        "bl", pre=_seq_p(_split(r"\s+|\p{N}", b, inv), BL_PRE))
       for b in ("Removed", "Isolated", "MergedWithPrevious",
                 "MergedWithNext", "Contiguous") for inv in (False, True)},
    "bl_split_string": _form("bl", pre=_seq_p(
        _split(" ", "MergedWithNext", regex=False), BL_PRE)),
    "bl_split_word_class": _form("bl", pre=_seq_p(
        _split(r"\w+", "Isolated"), _split(r"\W", "Removed"), BL_PRE)),
    "bl_whitespace_split": _form("bl", pre=_seq_p(
        {"type": "WhitespaceSplit"}, BL_PRE)),
    "bl_whitespace": _form("bl", pre=_seq_p({"type": "Whitespace"},
                                            BL_PRE)),
    "bl_bert_pre": _form("bl", pre=_seq_p({"type": "BertPreTokenizer"},
                                          BL_PRE)),
    **{f"bl_punctuation_{b.lower()}": _form("bl", pre=_seq_p(
        {"type": "Punctuation", "behavior": b}, BL_PRE))
       for b in ("Isolated", "MergedWithPrevious", "MergedWithNext",
                 "Contiguous", "Removed")},
    "bl_digits": _form("bl", pre=_seq_p(
        {"type": "Digits", "individual_digits": False}, BL_PRE)),
    "bl_digits_individual": _form("bl", pre=_seq_p(
        {"type": "Digits", "individual_digits": True}, BL_PRE)),
    "bl_no_pre": _form("bl", pre=None),
    # Unigram
    "ug_metaspace": _form("ug", None, _metaspace("always"),
                          {"type": "Metaspace", "replacement": SP,
                           "prepend_scheme": "always"}),
    "ug_byte_fallback": _form("ug_bytes", {"type": "NFKC"},
                              _metaspace("first"), MISTRAL_DEC),
    "ug_lower_whitespace": _form(
        "ug", {"type": "Lowercase"},
        _seq_p({"type": "WhitespaceSplit"}, _metaspace("always")),
        {"type": "Metaspace", "replacement": SP,
         "prepend_scheme": "always"}),
    # WordPiece
    "wp_bert": _form("wp"),
    "wp_cased_no_cleanup": _form(
        "wp", _bert_norm(lowercase=False), "keep",
        {"type": "WordPiece", "prefix": "##", "cleanup": False}),
    "wp_short_words": _form("wp", max_input_chars_per_word=5),
    # BPE with a subword prefix or a word suffix
    "bpe_subword_prefix": _form("prefix", "keep", "keep",
                                {"type": "WordPiece", "prefix": "##",
                                 "cleanup": True}),
    "bpe_word_suffix": _form("suffix", "keep", "keep",
                             {"type": "BPEDecoder", "suffix": "</w>"}),
}


# added tokens of every flag, normalized ones among them (matched by
# their normalized text: under Prepend, "rs" is sought as U+2581 "rs")
ADDED = [("[INST]", ("special",)), (" ls", ("lstrip",)),
         ("rs", ("rstrip", "normalized")),
         ("word", ("single_word", "normalized")), ("héllo", ()),
         ("Hello", ("normalized",))]
FORMS.update({f"{form}_added": (*FORMS[form][:4],
                                {**FORMS[form][4], "added": True})
              for form in ("sp_mistral", "sp_metaspace_first", "bl_nfd",
                           "bl_lowercase", "ug_byte_fallback", "wp_bert")})


def _dress(bases: dict, name: str) -> dict:
    base, norm, pre, dec, model = FORMS[name]
    d = copy.deepcopy(bases[base])
    for key, v in (("normalizer", norm), ("pre_tokenizer", pre),
                   ("decoder", dec)):
        if v != "keep":
            d[key] = copy.deepcopy(v)
    model = dict(model)
    if model.pop("added", False):
        flags = ("single_word", "lstrip", "rstrip", "normalized",
                 "special")
        n = len(d["model"]["vocab"])
        d["added_tokens"] = list(d.get("added_tokens") or []) + [
            {"id": n + i, "content": content,
             **{f: f in on for f in flags}}
            for i, (content, on) in enumerate(ADDED)]
    d["model"].update(model)
    return d


def _write_dir(d: dict, out, conf: dict) -> str:
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "tokenizer.json", "w", encoding="utf-8") as f:
        json.dump(d, f, ensure_ascii=False)
    with open(out / "tokenizer_config.json", "w", encoding="utf-8") as f:
        json.dump(conf, f, ensure_ascii=False)
    return str(out)


def _specials_conf(d: dict) -> dict:
    """A PreTrainedTokenizerFast config naming the file's specials."""
    vocab = d["model"]["vocab"]
    names = ({p for p, _ in vocab} if isinstance(vocab, list)
             else set(vocab))
    conf = {"tokenizer_class": "PreTrainedTokenizerFast"}
    for key, options in (("bos_token", ("<s>", "[CLS]", "<|bos|>")),
                         ("eos_token", ("</s>", "[SEP]", "<|eos|>")),
                         ("pad_token", ("<pad>", "[PAD]", "<|pad|>"))):
        hit = [o for o in options if o in names]
        if hit:
            conf[key] = hit[0]
    return conf


def _texts(n=120):
    return corpus(seed=21, n=n, extra=True) + [
        "", " ", "  x  ", "\t", "<s>", "a<s> b</s>", "[CLS] x [SEP]",
        "abc123def 4567", "ÀÉÎõü ﬁ ① Ⅻ ｗｉｄｅ", "x̧́y", "ΣΑΣ",
        "[INST] Hello rs  word words ls, HELLO héllo [INST]rs"]


def check_bare(path: str, texts) -> None:
    """The port's HFTokenizer against the JAX one (``tokenizers``):
    ids, both decodes, every id's decode with and without specials."""
    ref = jtok.HFTokenizer(path, bos_id=1, eos_id=2)
    got = ttok.HFTokenizer(path, bos_id=1, eos_id=2)
    lib = LibTokenizer.from_file(path)
    assert got.vocab_size == ref.vocab_size
    for text in texts:
        ids = ref.encode(text, add_bos=True)
        assert got.encode(text, add_bos=True) == ids, text
        assert got.decode(ids) == ref.decode(ids), text
        assert got.decode_raw(ids) == ref.decode_raw(ids), text
    for tid in range(ref.vocab_size + 4):
        for skip in (True, False):
            assert got.decode_ids([tid], skip) == lib.decode(
                [tid], skip_special_tokens=skip), tid


def check_auto(d: str, texts, chat: bool = True) -> None:
    """The port's HFAutoTokenizer against the JAX one
    (``transformers.AutoTokenizer``)."""
    ref = jtok.HFAutoTokenizer(d)
    got = ttok.HFAutoTokenizer(d)
    assert got.vocab_size == ref.vocab_size
    assert (got.bos_id, got.eos_id, got.pad_id) == (ref.bos_id, ref.eos_id,
                                                     ref.pad_id)
    for a, b in zip(texts, texts[1:] + texts[:1]):
        for add_bos in (False, True):
            ids = ref.encode(a, add_bos=add_bos)
            assert got.encode(a, add_bos=add_bos) == ids, a
        assert got.decode(ids) == ref.decode(ids), a
        assert got.decode_raw(ids) == ref.decode_raw(ids), a
        if chat:
            msgs = [{"role": "system", "content": a},
                    {"role": "user", "content": b},
                    {"role": "assistant", "content": a[::-1]},
                    {"role": "user", "content": "next"}]
            assert got.encode_chat(msgs) == ref.encode_chat(msgs), (a, b)
    for tid in range(ref.vocab_size + 4):
        assert got.decode([tid]) == ref.decode([tid]), tid
        assert got.decode_raw([tid]) == ref.decode_raw([tid]), tid


def check_tables(d: str, vocab: int) -> None:
    ref = jtok.HFAutoTokenizer(d)
    got = ttok.HFAutoTokenizer(d)
    for enum in (None, ("orient", "wait")):
        a = jcons.JsonTokenTable.for_tokenizer(ref, vocab, ref.eos_id,
                                               action_enum=enum)
        b = tcons.JsonTokenTable.for_tokenizer(got, vocab, got.eos_id,
                                               action_enum=enum)
        assert np.array_equal(a.table, b.table)
        assert (a.start_state, a.n_states) == (b.start_state, b.n_states)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_form_matches_reference(bases, name, tmp_path):
    d = _dress(bases, name)
    path = _write_dir(d, tmp_path / "ck", _specials_conf(d))
    texts = _texts()
    check_bare(os.path.join(path, "tokenizer.json"), texts)
    check_auto(path, texts[:60])


@pytest.mark.parametrize("name", ["sp_mistral", "sp_gemma",
                                  "ug_byte_fallback", "wp_bert"])
def test_form_json_tables(bases, name, tmp_path):
    d = _dress(bases, name)
    check_tables(_write_dir(d, tmp_path / "ck", _specials_conf(d)), 2048)


# ---------------------------------------------------------------------------
# chip_smoke.py's SentencePiece-form writer, and the golden digests
# ---------------------------------------------------------------------------

SP_CAPS = {"mistral": 32000, "gemma": 256000}


@pytest.fixture(scope="module")
def chip_forms(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp-forms")
    return {form: str(root / form) for form in SP_CAPS
            if chip_smoke.write_sp_tokenizer(str(root / form), form,
                                             SP_CAPS[form])}


@pytest.mark.parametrize("form", sorted(SP_CAPS))
def test_chip_writer_forms_match_reference(chip_forms, form):
    """The writer's files as transformers reads them (LlamaTokenizerFast,
    GemmaTokenizerFast): the byte tokens are ordinary vocab entries, so
    a skipping decode keeps every byte-fallback character."""
    d = chip_forms[form]
    texts = chip_smoke.tok_corpus(n=150)
    check_auto(d, texts)
    check_bare(os.path.join(d, "tokenizer.json"), texts[:60])
    ref = jtok.HFAutoTokenizer(d)
    assert type(ref._tok).__name__ == {"mistral": "LlamaTokenizerFast",
                                       "gemma": "GemmaTokenizerFast"}[form]
    got = ttok.HFAutoTokenizer(d)
    for text in ("x² ½ 漢字 🙂\t!", "<0x41>\x00"):
        assert got.decode(got.encode(text)) == ref.decode(
            ref.encode(text))
    assert "漢字" in got.decode(got.encode("x 漢字 y"))


@pytest.mark.parametrize("form", sorted(SP_CAPS))
def test_chip_writer_json_tables(chip_forms, form):
    """The grammar tables over each form's file, the port's against the
    JAX package's (per-id decodes: ``Strip`` drops a leading space)."""
    check_tables(chip_forms[form], 20000)


def test_golden_digests(chip_forms):
    """The golden file chip_smoke.py's tok phase checks on the card: the
    JAX HFAutoTokenizer's ids over the seeded corpus, per form, by
    sha256, and the port's equal to them. QUORACLE_WRITE_TOK_GOLDEN=1
    rewrites the file from the JAX package."""
    texts = chip_smoke.tok_corpus()
    want = {"corpus": list(chip_smoke.TOK_CORPUS), "forms": {}}
    for form in sorted(SP_CAPS):
        ref = jtok.HFAutoTokenizer(chip_forms[form])
        ids = [ref.encode(t) for t in texts]
        want["forms"][form] = {
            "vocab_size": ref.vocab_size, "n_ids": sum(map(len, ids)),
            "sha256": chip_smoke.ids_digest(ids)}
        got = ttok.HFAutoTokenizer(chip_forms[form])
        assert chip_smoke.ids_digest(got.encode(t) for t in texts) == \
            want["forms"][form]["sha256"]
    if os.environ.get("QUORACLE_WRITE_TOK_GOLDEN") == "1":
        with open(chip_smoke.TOK_GOLDEN, "w") as f:
            json.dump(want, f, indent=1)
            f.write("\n")
    with open(chip_smoke.TOK_GOLDEN) as f:
        assert json.load(f) == want


# ---------------------------------------------------------------------------
# slow-tokenizer directories, and what both packages refuse
# ---------------------------------------------------------------------------

def _gpt2_dir(bases, out, conf: dict) -> str:
    m = bases["bl"]["model"]
    out.mkdir(parents=True)
    with open(out / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(m["vocab"], f, ensure_ascii=False)
    with open(out / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in m["merges"]:
            f.write(f"{a} {b}\n")
    with open(out / "tokenizer_config.json", "w") as f:
        json.dump(conf, f)
    return str(out)


def _bert_dir(bases, out, conf: dict) -> str:
    vocab = bases["wp"]["model"]["vocab"]
    out.mkdir(parents=True)
    with open(out / "vocab.txt", "w", encoding="utf-8") as f:
        for tok in sorted(vocab, key=vocab.get):
            f.write(tok + "\n")
    with open(out / "tokenizer_config.json", "w") as f:
        json.dump(conf, f)
    return str(out)


SLOW_DIRS = {
    "gpt2": (_gpt2_dir, {"tokenizer_class": "GPT2Tokenizer"}),
    "gpt2_prefix_space": (_gpt2_dir, {"tokenizer_class": "GPT2Tokenizer",
                                      "add_prefix_space": True}),
    "bert_uncased": (_bert_dir, {"tokenizer_class": "BertTokenizer",
                                 "do_lower_case": True}),
    "bert_cased": (_bert_dir, {"tokenizer_class": "BertTokenizer",
                               "do_lower_case": False}),
    "bert_default": (_bert_dir, {"tokenizer_class": "BertTokenizer"}),
}


@pytest.mark.parametrize("name", sorted(SLOW_DIRS))
def test_slow_tokenizer_dirs_convert_as_transformers(bases, name, tmp_path):
    write, conf = SLOW_DIRS[name]
    d = write(bases, tmp_path / "ck", conf)
    assert not os.path.exists(os.path.join(d, "tokenizer.json"))
    check_auto(d, _texts(60))


def test_model_type_picks_the_class(bases, tmp_path):
    """No tokenizer_class: config.json's model_type names it (gpt2's
    default specials, bert's lowercasing)."""
    for name, model_type in (("gpt2", "gpt2"), ("bert_default", "bert")):
        write, _ = SLOW_DIRS[name]
        d = write(bases, tmp_path / name, {})
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"model_type": model_type}, f)
        check_auto(d, _texts(30), chat=False)


def test_sentencepiece_model_alone_is_refused_by_both(tmp_path):
    d = tmp_path / "sp"
    d.mkdir()
    (d / "tokenizer.model").write_bytes(b"\x0a\x05hello")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "LlamaTokenizer"}))
    with pytest.raises(BaseException):
        jtok.HFAutoTokenizer(str(d))
    with pytest.raises(NotImplementedError, match="sentencepiece"):
        ttok.HFAutoTokenizer(str(d))


@pytest.mark.parametrize("cls", ["LlamaTokenizer", "GemmaTokenizer"])
def test_add_prefix_space_on_sentencepiece_classes(chip_forms, cls,
                                                   tmp_path):
    """add_prefix_space in tokenizer_config.json: LlamaTokenizerFast
    rebuilds from tokenizer.model (sentencepiece), so both packages
    refuse; GemmaTokenizerFast keeps the file, and both read it alike."""
    import shutil
    d = shutil.copytree(chip_forms["gemma" if "Gemma" in cls
                                   else "mistral"], str(tmp_path / "ck"))
    conf_path = os.path.join(d, "tokenizer_config.json")
    with open(conf_path) as f:
        conf = json.load(f)
    conf.update(add_prefix_space=True, tokenizer_class=cls)
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    if cls == "LlamaTokenizer":
        with pytest.raises(BaseException):
            jtok.HFAutoTokenizer(d)
        with pytest.raises(NotImplementedError, match="add_prefix_space"):
            ttok.HFAutoTokenizer(d)
    else:
        check_auto(d, chip_smoke.tok_corpus(n=40))


def test_unknown_tokenizer_class_is_refused(bases, tmp_path):
    """A class whose defaults the port does not follow raises (the
    reference would read it with that class's special tokens)."""
    d = _dress(bases, "sp_mistral")
    path = _write_dir(d, tmp_path / "ck",
                      {"tokenizer_class": "T5TokenizerFast"})
    with pytest.raises(NotImplementedError, match="T5TokenizerFast"):
        ttok.HFAutoTokenizer(path)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "t5"}, f)
    with pytest.raises(NotImplementedError, match="t5"):
        ttok.HFAutoTokenizer(path)


def test_unknown_component_names_itself(bases, tmp_path):
    d = _dress(bases, "sp_mistral")
    d["normalizer"] = {"type": "Precompiled", "precompiled_charsmap": ""}
    path = _write_dir(d, tmp_path / "ck", {})
    with pytest.raises(NotImplementedError, match="Precompiled"):
        ttok.HFTokenizer(os.path.join(path, "tokenizer.json"))
