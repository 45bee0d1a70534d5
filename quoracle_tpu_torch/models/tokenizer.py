"""Tokenizers for the port's model pool.

The port's own copy of the JAX package's tokenizer layer
(``quoracle_tpu/models/tokenizer.py``). A catalog model without a
checkpoint encodes through the learned byte-level BPE of
``quoracle_tpu_torch/native/`` (``NativeBPETokenizer``, re-exported here):
a C++ build of the algorithm over ``bpe_merges.txt`` beside this file, a
byte-identical copy of ``quoracle_tpu/native/bpe_merges.txt``, with an
identical pure-Python path when ``g++`` is missing; ids match the JAX
package exactly.

A checkpoint brings its own tokenizer (``HFAutoTokenizer``: its
``tokenizer.json``, special tokens and chat template; ``HFTokenizer``: a
bare ``tokenizer.json``). The JAX package wraps ``transformers`` and
``tokenizers`` for these; the port reads the files itself, without either
library or ``regex``: the added tokens split out first, then the file's
normalizer, pre-tokenizer and model (BPE, with or without byte fallback,
Unigram, WordPiece), and its decoder chain on the way back
(models/tokenizer_pipeline.py lists every component read). Directories
without ``tokenizer.json`` are converted as ``transformers`` converts
them: ``vocab.json`` with ``merges.txt`` (GPT-2) and ``vocab.txt`` (BERT
WordPiece). The chat template is rendered by ``jinja2`` as
``transformers`` renders it. A SentencePiece ``tokenizer.model`` alone,
and any component outside that list, raise ``NotImplementedError``.
"""

from __future__ import annotations

import abc
import json
import os
import re
import threading
from typing import Optional, Sequence

from quoracle_tpu_torch.models.tokenizer_pipeline import (
    GPT2_PATTERN, SPACE_RE, build_decoder, build_model, build_normalizer,
    build_pre_tokenizer, byte_chars, decode_tokens, is_word_char,
    translate_regex,
)
from quoracle_tpu_torch.utils.normalize import (
    stringify_content as _stringify_content,
)

__all__ = [
    "BOS_ID", "EOS_ID", "GPT2_PATTERN", "PAD_ID", "ByteTokenizer",
    "HFAutoTokenizer", "HFTokenizer", "NativeBPETokenizer", "Tokenizer",
    "byte_chars", "get_tokenizer", "native_available", "translate_regex",
]

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_N_SPECIALS = 3

# the native BPE's names, re-exported (the native module imports
# ``Tokenizer`` from here, so they resolve at first use)
_NATIVE_NAMES = ("NativeBPETokenizer", "native_available", "MERGES_PATH")


def __getattr__(name: str):
    if name in _NATIVE_NAMES:
        from quoracle_tpu_torch.native import tokenizer as native
        return getattr(native, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Tokenizer(abc.ABC):
    """Interface the runtime depends on."""

    pad_id: int = PAD_ID
    bos_id: int = BOS_ID
    eos_id: int = EOS_ID

    @abc.abstractmethod
    def encode(self, text: str, add_bos: bool = False) -> list[int]: ...

    @abc.abstractmethod
    def decode(self, ids: Sequence[int]) -> str: ...

    def decode_raw(self, ids: Sequence[int]) -> str:
        """Decode for TEXT-PREFIX comparison (session splicing). Byte-level
        tokenizers keep their default decode."""
        return self.decode(ids)

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    def count(self, text: str) -> int:
        return len(self.encode(text))

    # One neutral chat template for every family, as in the JAX package.
    def render_chat(self, messages: Sequence[dict]) -> str:
        parts = []
        for m in messages:
            role = m.get("role", "user")
            content = m.get("content", "")
            if not isinstance(content, str):
                content = _stringify_content(content)
            parts.append(f"<|{role}|>\n{content}\n")
        parts.append("<|assistant|>\n")
        return "".join(parts)

    def encode_chat(self, messages: Sequence[dict]) -> list[int]:
        return self.encode(self.render_chat(messages), add_bos=True)


class ByteTokenizer(Tokenizer):
    """Byte-level reversible tokenizer: id = byte + 3 specials offset."""

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = [b + _N_SPECIALS for b in text.encode("utf-8")]
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        # ids beyond the byte range (model vocab > tokenizer vocab) skip
        data = bytes(i - _N_SPECIALS for i in ids
                     if _N_SPECIALS <= i < 256 + _N_SPECIALS)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return 256 + _N_SPECIALS


# ---------------------------------------------------------------------------
# HF tokenizer files: tokenizer.json
# ---------------------------------------------------------------------------

class _Added:
    """One entry of a tokenizer file's ``added_tokens``."""
    __slots__ = ("id", "content", "special", "lstrip", "rstrip",
                 "single_word", "normalized")

    def __init__(self, d: dict):
        self.id = int(d["id"])
        self.content = d["content"]
        self.special = bool(d.get("special", False))
        self.lstrip = bool(d.get("lstrip", False))
        self.rstrip = bool(d.get("rstrip", False))
        self.single_word = bool(d.get("single_word", False))
        self.normalized = bool(d.get("normalized", not self.special))


def _limits(spec: dict) -> tuple:
    """The file's truncation (max length, keep the left end) and padding
    (fixed length or None, multiple, pad id, pad on the left)."""
    trunc = pad = None
    t = spec.get("truncation")
    p = spec.get("padding")
    for name, block, keys in (
            ("truncation", t, ("max_length", "strategy", "stride")),
            ("padding", p, ("strategy", "direction", "pad_id",
                            "pad_type_id", "pad_token"))):
        missing = [k for k in keys if block is not None and k not in block]
        if missing:
            raise ValueError(f"tokenizer.json: {name} lacks {missing}")
    if t is not None:
        trunc = (int(t["max_length"]), t.get("direction", "Right") == "Left")
    if p is not None:
        strategy = p["strategy"]
        fixed = (int(strategy["Fixed"]) if isinstance(strategy, dict)
                 else None)
        pad = (fixed, p.get("pad_to_multiple_of") or 0, int(p["pad_id"]),
               p["direction"] == "Left")
    return trunc, pad


class HFTokenizer(Tokenizer):
    """A ``tokenizer.json`` run by the port, ids and texts as the
    ``tokenizers`` library gives them (``Tokenizer.from_file``, encoded
    without added specials):

    * the added tokens are split out of the text first (leftmost-longest;
      ``lstrip``, ``rstrip``, ``single_word``): the non-normalized ones
      on the raw text; each text between them is normalized on its own,
      and the normalized ones (their contents normalized too) are split
      out of it;
    * each remaining text is pre-tokenized and each piece run through
      the model (tokenizer_pipeline.py);
    * the file's ``truncation``, then its ``padding``, apply to the ids
      (``limits=False`` drops both, as ``transformers`` does);
    * decoding maps ids to tokens (the added tokens' contents; special
      ones dropped unless asked), then runs the decoder chain, or joins
      the tokens with spaces when the file has no decoder.
    """

    def __init__(self, path: Optional[str] = None, bos_id: int = BOS_ID,
                 eos_id: int = EOS_ID, extra_specials: Sequence[str] = (),
                 spec: Optional[dict] = None, limits: bool = True):
        if spec is None:
            with open(path, encoding="utf-8") as f:
                spec = json.load(f)
        self.path = path
        self.bos_id, self.eos_id = bos_id, eos_id
        # the library checks both blocks whether or not they apply
        self._trunc, self._pad = _limits(spec)
        if not limits:
            self._trunc = self._pad = None
        self._model = build_model(spec.get("model") or {})
        self._vocab = self._model.vocab
        self._normalizer = build_normalizer(spec.get("normalizer"))
        self._pre = build_pre_tokenizer(spec.get("pre_tokenizer"))
        self._decoder = build_decoder(spec.get("decoder"))
        # only a Metaspace prepending to the input's first piece reads
        # where each character came from
        self._offsets = bool(self._pre and self._pre.needs_offsets)
        self._added: list[_Added] = []
        for d in spec.get("added_tokens") or []:
            self._add(_Added(d))
        for content in extra_specials:
            if not any(a.content == content for a in self._added):
                self._add(_Added({"id": -1, "content": content,
                                  "special": True, "normalized": False}))
        self._index_added()

    # -- the file ------------------------------------------------------------
    def _add(self, tok: _Added) -> None:
        """Register an added token under the id the library gives it (the
        file's id is only checked there): its vocab id, else one past
        the largest added id at or above the vocab's size."""
        if not tok.content or any(a.content == tok.content
                                  for a in self._added):
            return
        ids = [a.id for a in self._added]
        if tok.content in self._vocab:
            tok.id = self._vocab[tok.content]
        elif ids and max(ids) >= len(self._vocab):
            tok.id = max(ids) + 1
        else:
            tok.id = len(self._vocab)
        self._added.append(tok)

    def _index_added(self) -> None:
        self._added_by_id = {a.id: a for a in self._added}
        self._added_by_content = {a.content: a for a in self._added}
        self._special_contents = {a.content for a in self._added
                                  if a.special}
        # the normalized tokens match by their normalized contents
        self._added_by_match: list[dict] = [{}, {}]
        self._added_res = []
        for k, normalized in enumerate((False, True)):
            table = self._added_by_match[k]
            for a in self._added:
                if a.normalized != normalized:
                    continue
                pat = a.content
                if normalized and self._normalizer is not None:
                    pat = self._normalizer.text(pat)
                if pat:
                    table.setdefault(pat, a)
            group = sorted(table, key=lambda c: -len(c))
            self._added_res.append(
                re.compile("|".join(map(re.escape, group)))
                if group else None)

    # -- encoding ------------------------------------------------------------
    def _split_added(self, text: str, k: int) -> list:
        """[(added token or None, start, stop)] over ``text``: the
        library's ``find_matches`` with the non-normalized (k 0) or the
        normalized (k 1) tokens."""
        pattern = self._added_res[k]
        if pattern is None or not text:
            return [(None, 0, len(text))]
        table = self._added_by_match[k]
        out, at = [], 0
        for m in pattern.finditer(text):
            tok = table[m.group(0)]
            start, stop = m.start(), m.end()
            if tok.single_word and (
                    (start > 0 and is_word_char(text[start - 1]))
                    or (stop < len(text) and is_word_char(text[stop]))):
                continue
            if tok.lstrip:
                s = start
                while s > 0 and SPACE_RE.match(text[s - 1]):
                    s -= 1
                start = max(s, at)
            if tok.rstrip:
                while stop < len(text) and SPACE_RE.match(text[stop]):
                    stop += 1
            if at < start:
                out.append((None, at, start))
            out.append((tok, start, stop))
            at = stop
        if at < len(text):
            out.append((None, at, len(text)))
        return out

    def encode_ids(self, text: str) -> list[int]:
        """The library's ``encode(text, add_special_tokens=False).ids``."""
        out: list[int] = []
        norm, pre, tokenize = self._normalizer, self._pre, \
            self._model.tokenize
        for tok, s0, e0 in self._split_added(text, 0):
            if tok is not None:
                out.append(tok.id)
                continue
            seg = text[s0:e0]
            al = list(range(s0, e0)) if self._offsets else None
            if norm is not None:
                seg, al = norm(seg, al)
            for tok2, s1, e1 in self._split_added(seg, 1):
                if tok2 is not None:
                    out.append(tok2.id)
                    continue
                if s1 == e1:
                    continue
                piece = (seg[s1:e1], None if al is None else al[s1:e1])
                if pre is None:
                    out.extend(tokenize(piece[0]))
                    continue
                for word, _ in pre([piece]):
                    out.extend(tokenize(word))
        if self._trunc is not None:
            n, left = self._trunc
            if len(out) > n:
                out = out[len(out) - n:] if left else out[:n]
        if self._pad is not None:
            fixed, multiple, pad_id, left = self._pad
            target = len(out) if fixed is None else fixed
            if multiple and target % multiple:
                target += multiple - target % multiple
            if len(out) < target:
                fill = [pad_id] * (target - len(out))
                out = fill + out if left else out + fill
        return out

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self.encode_ids(text)
        return [self.bos_id] + ids if add_bos else ids

    # -- decoding ------------------------------------------------------------
    def token_to_id(self, token: str) -> Optional[int]:
        a = self._added_by_content.get(token)
        return a.id if a is not None else self._vocab.get(token)

    def decode_ids(self, ids: Sequence[int], skip_special: bool) -> str:
        tokens = []
        for tid in ids:
            tid = int(tid)
            a = self._added_by_id.get(tid)
            tok = a.content if a is not None else \
                self._model.id_to_token(tid)
            if tok is None or (skip_special
                               and tok in self._special_contents):
                continue
            tokens.append(tok)
        return decode_tokens(self._decoder, tokens)

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_ids(ids, skip_special=True)

    def decode_raw(self, ids: Sequence[int]) -> str:
        return self.decode_ids(ids, skip_special=False)

    @property
    def vocab_size(self) -> int:
        """Model vocab and added tokens, each text once (the library's
        ``get_vocab_size(with_added_tokens=True)``)."""
        return len(set(self._vocab) | set(self._added_by_content))


# ---------------------------------------------------------------------------
# checkpoint directories, as transformers' AutoTokenizer reads them
# ---------------------------------------------------------------------------

_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")

# transformers' tokenizer classes the port follows, with each class's
# special tokens where tokenizer_config.json names none
_CLASSES = {
    "llama": {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>"},
    "gemma": {"unk_token": "<unk>", "bos_token": "<bos>",
              "eos_token": "<eos>", "pad_token": "<pad>"},
    "gpt2": {"unk_token": "<|endoftext|>", "bos_token": "<|endoftext|>",
             "eos_token": "<|endoftext|>"},
    "bert": {"unk_token": "[UNK]", "sep_token": "[SEP]",
             "pad_token": "[PAD]", "cls_token": "[CLS]",
             "mask_token": "[MASK]"},
    "qwen2": {"unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
              "pad_token": "<|endoftext|>"},
    None: {},
}
_CLASS_NAMES = {"LlamaTokenizer": "llama", "GemmaTokenizer": "gemma",
                "GPT2Tokenizer": "gpt2", "BertTokenizer": "bert",
                "Qwen2Tokenizer": "qwen2"}
# config.json's model_type -> tokenizer class, where tokenizer_config.json
# names none
_MODEL_TYPES = {"llama": "llama", "mistral": "llama", "gemma": "gemma",
                "gpt2": "gpt2", "bert": "bert", "qwen2": "qwen2"}


def _token_text(v) -> Optional[str]:
    """A tokenizer_config special token: a string or an AddedToken dict."""
    if v is None or isinstance(v, str):
        return v
    return v["content"]


def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _tokenizer_class(path: str, conf: dict) -> Optional[str]:
    """The transformers class the directory loads as, by
    ``tokenizer_config.json``'s name, else ``config.json``'s model type
    (None: ``PreTrainedTokenizerFast``). A class whose defaults the port
    does not follow raises rather than read the files otherwise."""
    name = conf.get("tokenizer_class")
    if name:
        base = name.removesuffix("Fast")
        if base == "PreTrainedTokenizer":
            return None
        if base not in _CLASS_NAMES:
            raise NotImplementedError(
                f"checkpoint dir {path!r}: tokenizer class {name!r} is not "
                f"one the port follows ({sorted(_CLASS_NAMES)})")
        return _CLASS_NAMES[base]
    model_type = _read_json(os.path.join(path, "config.json")).get(
        "model_type")
    if model_type is None:
        raise ValueError(f"checkpoint dir {path!r}: tokenizer_config.json "
                         f"names no tokenizer_class and config.json no "
                         f"model_type")
    if model_type not in _MODEL_TYPES:
        raise NotImplementedError(
            f"checkpoint dir {path!r}: model type {model_type!r} has a "
            f"tokenizer class the port does not follow")
    return _MODEL_TYPES[model_type]


def _gpt2_spec(path: str, conf: dict) -> dict:
    """transformers' GPT2Converter over ``vocab.json`` and ``merges.txt``
    (the slow tokenizer drops the merges file's first and last lines)."""
    vocab = _read_json(os.path.join(path, "vocab.json"))
    with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
        lines = f.read().split("\n")[1:-1]
    merges = list(dict.fromkeys(tuple(ln.split()) for ln in lines))
    prefix = bool(conf.get("add_prefix_space", False))
    byte_level = {"type": "ByteLevel", "add_prefix_space": prefix,
                  "trim_offsets": True, "use_regex": True}
    return {"normalizer": None, "pre_tokenizer": byte_level,
            "decoder": dict(byte_level),
            "model": {"type": "BPE", "vocab": vocab,
                      "merges": [list(m) for m in merges]}}


def _bert_spec(path: str, conf: dict) -> dict:
    """transformers' BertConverter over ``vocab.txt``."""
    vocab: dict[str, int] = {}
    with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as f:
        for i, line in enumerate(f.readlines()):
            vocab[line.rstrip("\n")] = i
    basic = conf.get("do_basic_tokenize", True)
    lower = bool(conf.get("do_lower_case", True))
    unk = _token_text(conf.get("unk_token", "[UNK]"))
    return {"normalizer": {
                "type": "BertNormalizer", "clean_text": True,
                "handle_chinese_chars":
                    bool(conf.get("tokenize_chinese_chars", True)) and basic,
                "strip_accents": conf.get("strip_accents") if basic
                else False,
                "lowercase": lower and basic},
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "decoder": {"type": "WordPiece", "prefix": "##",
                        "cleanup": True},
            "model": {"type": "WordPiece", "vocab": vocab,
                      "unk_token": unk, "continuing_subword_prefix": "##",
                      "max_input_chars_per_word": 100}}


def _load_spec(path: str, conf: dict) -> tuple:
    """(the directory's ``tokenizer.json``, or the file ``transformers``
    converts its slow-tokenizer files into; the tokenizer class)."""
    def has(*names):
        return all(os.path.isfile(os.path.join(path, n)) for n in names)
    if has("tokenizer.json"):
        return _read_json(os.path.join(path, "tokenizer.json")), \
            _tokenizer_class(path, conf)
    if not (has("tokenizer.model") or has("vocab.json") or has("vocab.txt")):
        raise ValueError(
            f"checkpoint dir {path!r} has no tokenizer files "
            "(tokenizer.json) — a served checkpoint must ship its own "
            "tokenizer")
    cls = (_tokenizer_class(path, conf)
           if has("vocab.json") or has("vocab.txt") else None)
    if cls == "gpt2" and has("vocab.json", "merges.txt"):
        return _gpt2_spec(path, conf), cls
    if cls == "bert" and has("vocab.txt"):
        return _bert_spec(path, conf), cls
    raise NotImplementedError(
        f"checkpoint dir {path!r} has no tokenizer.json and its "
        f"slow-tokenizer files are not ones the port converts (GPT-2 "
        f"vocab.json + merges.txt, BERT vocab.txt; a SentencePiece "
        f"tokenizer.model needs the sentencepiece library)")


def _template_env():
    """The jinja2 environment ``transformers`` renders chat templates in."""
    import datetime

    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None,
               sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = \
        lambda fmt: datetime.datetime.now().strftime(fmt)
    return env


def _clean_up_spaces(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


class HFAutoTokenizer(Tokenizer):
    """The tokenizer of a served checkpoint directory, as the JAX
    package's ``transformers.AutoTokenizer`` gives it: ``tokenizer.json``
    (or the slow-tokenizer files converted as ``transformers`` converts
    them) through ``HFTokenizer`` with the file's truncation and padding
    off; the tokenizer class (``tokenizer_config.json``'s, else
    ``config.json``'s model type) with its default special tokens and
    the class's edits to the file (``add_prefix_space``, BERT's
    normalizer flags); the special tokens of ``tokenizer_config.json``
    (those the file lacks are added, as ``transformers`` adds them) and
    its ``clean_up_tokenization_spaces``; its chat template (or
    ``chat_template.jinja``), rendered as ``transformers`` renders it and
    encoded without added specials. Without a template the neutral one
    serves."""

    def __init__(self, path: str):
        conf = _read_json(os.path.join(path, "tokenizer_config.json"))
        spec, cls = _load_spec(path, conf)
        defaults = _CLASSES[cls]
        # clean_up_tokenization_spaces is off but where the slow
        # BertTokenizer's default (on) carries over
        clean_up = cls == "bert" and not os.path.isfile(
            os.path.join(path, "tokenizer.json"))
        pre = spec.get("pre_tokenizer")
        if cls == "llama" and conf.get("add_prefix_space") is not None:
            # LlamaTokenizerFast rebuilds itself from the SentencePiece
            # model then, which needs the sentencepiece library
            raise NotImplementedError(
                f"checkpoint dir {path!r}: add_prefix_space on a Llama "
                f"tokenizer converts from tokenizer.model (sentencepiece)")
        if (cls != "llama" and isinstance(pre, dict)
                and pre.get("type") == "ByteLevel"):
            # the class sets ByteLevel's add_prefix_space to its own
            spec["pre_tokenizer"] = dict(
                pre, add_prefix_space=bool(conf.get("add_prefix_space",
                                                    False)))
        norm = spec.get("normalizer")
        if cls == "bert" and norm is None:
            # BertTokenizerFast reads its normalizer's state at build
            raise ValueError(f"checkpoint dir {path!r}: a BERT tokenizer "
                             f"without a normalizer")
        if cls == "bert" and norm.get("type") == "BertNormalizer":
            want = (bool(conf.get("do_lower_case", True)),
                    conf.get("strip_accents"),
                    bool(conf.get("tokenize_chinese_chars", True)))
            if (norm.get("lowercase"), norm.get("strip_accents"),
                    norm.get("handle_chinese_chars")) != want:
                spec["normalizer"] = dict(
                    norm, lowercase=want[0], strip_accents=want[1],
                    handle_chinese_chars=want[2])
        # the template's special-token variables (transformers'
        # special_tokens_map): the config's, else the class's defaults,
        # else (the pad token) the file's padding block's
        self.special_tokens: dict = {}
        for k in _SPECIAL_KEYS:
            if k in conf:
                v = _token_text(conf[k])
            elif k in defaults:
                v = defaults[k]
            else:
                v = (spec.get("padding") or {}).get(k)
            if v is not None:
                self.special_tokens[k] = v
        extra = [_token_text(t)
                 for t in conf.get("additional_special_tokens") or []]
        if extra:
            self.special_tokens["additional_special_tokens"] = extra
        if cls in ("llama", "gemma"):
            # the class's post-processor adds bos (and, if asked, eos)
            for key, default in (("bos", True), ("eos", False)):
                if conf.get(f"add_{key}_token", default) and \
                        self.special_tokens.get(f"{key}_token") is None:
                    raise ValueError(f"checkpoint dir {path!r}: "
                                     f"add_{key}_token without a "
                                     f"{key}_token")
        self._tok = HFTokenizer(
            os.path.join(path, "tokenizer.json"), spec=spec, limits=False,
            extra_specials=[self.special_tokens[k] for k in _SPECIAL_KEYS
                            if k in self.special_tokens] + extra)
        for tid, d in (conf.get("added_tokens_decoder") or {}).items():
            if self._tok.token_to_id(d["content"]) != int(tid):
                raise NotImplementedError(
                    f"tokenizer_config.json adds token {d['content']!r} "
                    f"(id {tid}), which tokenizer.json lacks")

        def special_id(key: str) -> Optional[int]:
            text = self.special_tokens.get(key)
            return None if text is None else self._tok.token_to_id(text)
        # no invented specials: without a bos token add_bos adds nothing
        bos, eos, pad = (special_id(k) for k in
                         ("bos_token", "eos_token", "pad_token"))
        self._has_bos = bos is not None
        self.bos_id = bos if self._has_bos else BOS_ID
        self.eos_id = eos if eos is not None else EOS_ID
        self.pad_id = pad if pad is not None else self.eos_id
        self._clean_up = bool(conf.get("clean_up_tokenization_spaces",
                                       clean_up))
        template = conf.get("chat_template")
        jinja_file = os.path.join(path, "chat_template.jinja")
        if os.path.isfile(jinja_file):
            with open(jinja_file, encoding="utf-8") as f:
                template = f.read()
        if isinstance(template, list):
            template = {t["name"]: t["template"]
                        for t in template}.get("default")
        self._template = (_template_env().from_string(template)
                          if template else None)

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self._tok.encode_ids(text)
        return [self.bos_id] + ids if add_bos and self._has_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        text = self._tok.decode_ids(ids, skip_special=True)
        return _clean_up_spaces(text) if self._clean_up else text

    def decode_raw(self, ids: Sequence[int]) -> str:
        # template markers kept: the splice suffix must re-encode to them
        return self._tok.decode_ids(ids, skip_special=False)

    @property
    def vocab_size(self) -> int:
        return self._tok.vocab_size

    def encode_chat(self, messages: Sequence[dict]) -> list[int]:
        msgs = [{"role": m.get("role", "user"),
                 "content": m.get("content", "")
                 if isinstance(m.get("content", ""), str)
                 else _stringify_content(m.get("content"))}
                for m in messages]
        if self._template is None:
            return self.encode(self.render_chat(msgs), add_bos=True)
        return self._tok.encode_ids(self._template.render(
            messages=msgs, tools=None, documents=None,
            add_generation_prompt=True, **self.special_tokens))


_TOK_CACHE: dict[tuple, Tokenizer] = {}
# backends and engines may be built from several threads; one tokenizer
# per key, so every engine of a model shares its (stateless) instance
_TOK_LOCK = threading.Lock()


def get_tokenizer(model_name: str,
                  tokenizer_path: Optional[str] = None) -> Tokenizer:
    """Tokenizer for a catalog model: a checkpoint's own
    (``HFAutoTokenizer``), else the ``tokenizer.json`` at
    ``tokenizer_path`` (``HFTokenizer``), else the learned BPE sized to
    the model's vocab (``NativeBPETokenizer``, through its C++ build).
    bos/eos come from the catalog entry (a checkpoint's tokenizer brings
    its own), so the tokenizer and the engine's stop condition agree. The
    cache key holds the checkpoint path: a name registered again, or
    after a first lookup, never keeps a stale tokenizer."""
    from quoracle_tpu_torch.models.config import get_model_config
    from quoracle_tpu_torch.native.tokenizer import NativeBPETokenizer
    try:
        cfg = get_model_config(model_name)
        bos, eos, vocab = cfg.bos_token_id, cfg.eos_token_id, cfg.vocab_size
        ckpt = cfg.checkpoint_path
    except KeyError:
        bos, eos, vocab, ckpt = BOS_ID, EOS_ID, 32768, None
    key = (model_name, tokenizer_path, ckpt, bos, eos, vocab)
    with _TOK_LOCK:
        cached = _TOK_CACHE.get(key)
        if cached is None:
            if ckpt:
                cached = HFAutoTokenizer(ckpt)
            elif tokenizer_path:
                cached = HFTokenizer(tokenizer_path, bos_id=bos, eos_id=eos)
            else:
                cached = NativeBPETokenizer.for_vocab(vocab)
                cached.bos_id, cached.eos_id = bos, eos
            _TOK_CACHE[key] = cached
    return cached


# the reset hook the JAX package's get_tokenizer has
get_tokenizer.cache_clear = _TOK_CACHE.clear
