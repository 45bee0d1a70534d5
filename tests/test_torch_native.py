"""The port's native byte-level BPE (quoracle_tpu_torch/native/: bpe.cpp
built with g++ at first use into build/native/, its ctypes binding and
the pure-Python path) against itself and the JAX package's
``NativeBPETokenizer``, on the CPU: the cases of tests/test_native.py,
native against Python ids over the repository's text, ids against the
JAX package, and the build (cached by the source's hash, rebuilt when it
changes, the Python path with a warning when g++ fails)."""

import concurrent.futures
import importlib.util
import logging
import os
import shutil

import pytest

from quoracle_tpu.native import tokenizer as jnative
from quoracle_tpu_torch import native
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.native import tokenizer as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SAMPLES = [
    "hello world",
    "The consensus pipeline clusters proposals by fingerprint.",
    '{"action": "spawn_child", "params": {"budget": 4}, "wait": false}',
    "def f(x):\n    return x + 1\n",
    "Zürich naïveté — 日本語テキスト mixed unicode",
    "a" * 500,
    "  leading space\nand\nnewlines\t\ttabs",
    "",
]


def test_native_builds_and_loads():
    assert tnative.native_available()
    tok = tnative.NativeBPETokenizer.for_vocab(32768)
    assert tok.native and tok.n_merges > 10_000
    so = native.so_path(tnative.SRC_PATH)
    assert os.path.isfile(so)
    assert os.path.dirname(so) == native.BUILD_DIR
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(tnative.SRC_PATH)))


@pytest.mark.parametrize("text", SAMPLES)
def test_roundtrip_and_native_python_lockstep(text):
    tok = tnative.NativeBPETokenizer.for_vocab(32768)
    ids = tok.encode(text)
    assert tok.decode(ids) == text
    assert tnative._py_encode(text, tok.n_merges) == ids
    assert all(0 <= i < tok.vocab_size for i in ids)
    assert jnative.NativeBPETokenizer.for_vocab(32768).encode(text) == ids


def test_native_python_and_jax_ids_over_repository_text():
    text = chip_smoke.repo_text()      # what the tok phase encodes
    for vocab in (512, 32768):
        tok = tnative.NativeBPETokenizer.for_vocab(vocab)
        ids = tok.encode(text)
        assert ids == tnative._py_encode(text, tok.n_merges)
        assert ids == jnative.NativeBPETokenizer.for_vocab(vocab).encode(
            text)
        assert tok.decode(ids) == text


def test_vocab_prefix_truncation():
    full = tnative.NativeBPETokenizer.for_vocab(32768)
    tiny = tnative.NativeBPETokenizer.for_vocab(512)
    assert tiny.n_merges == 512 - tnative.FIRST_MERGE_ID
    text = "the quick brown fox"
    tids = tiny.encode(text)
    assert max(tids) < 512
    assert tiny.decode(tids) == text
    byte_level = tnative.NativeBPETokenizer.byte_level()
    assert byte_level.encode(text) == [b + 3 for b in text.encode()]
    assert byte_level.vocab_size == 259
    assert len(full.encode(text)) <= len(tids)


def test_bos_encoding_and_chat():
    tok = tnative.NativeBPETokenizer.for_vocab(32768)
    ref = jnative.NativeBPETokenizer.for_vocab(32768)
    ids = tok.encode("x", add_bos=True)
    assert ids[0] == tok.bos_id
    msgs = [{"role": "user", "content": "hi"}]
    chat = tok.encode_chat(msgs)
    assert chat == ref.encode_chat(msgs)
    assert chat[0] == tok.bos_id and "<|user|>" in tok.decode(chat)


def test_get_tokenizer_uses_native_bpe_for_catalog_models():
    from quoracle_tpu.models.tokenizer import get_tokenizer as jget
    ttok.get_tokenizer.cache_clear()
    text = "The quick brown fox jumps over the lazy dog."
    for name in ("llama-1b", "tiny", "xla:llama-3-8b"):
        got, ref = ttok.get_tokenizer(name), jget(name)
        assert isinstance(got, ttok.NativeBPETokenizer) and got.native
        assert (got.bos_id, got.eos_id, got.vocab_size) == (
            ref.bos_id, ref.eos_id, ref.vocab_size)
        assert got.encode(text, add_bos=True) == ref.encode(text,
                                                           add_bos=True)
    assert len(ttok.get_tokenizer("llama-1b").encode(text)) < len(text)
    assert max(ttok.get_tokenizer("tiny").encode(text)) < 512
    # the re-exported names are the native module's
    assert ttok.NativeBPETokenizer is tnative.NativeBPETokenizer
    assert ttok.native_available is tnative.native_available


def test_concurrent_encodes_with_different_vocabs_do_not_race():
    full = tnative.NativeBPETokenizer.for_vocab(32768)
    tiny = tnative.NativeBPETokenizer.for_vocab(512)
    text = ("the consensus pipeline clusters proposals by fingerprint "
            "and merges parameters by rule. ") * 40
    expect_full, expect_tiny = full.encode(text), tiny.encode(text)
    assert expect_full != expect_tiny

    def worker(i):
        tok, expect = ((full, expect_full) if i % 2 == 0
                       else (tiny, expect_tiny))
        return all(tok.encode(text) == expect for _ in range(30))

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        assert all(pool.map(worker, range(16)))
    assert full.encode(text) == expect_full


def test_rebuild_when_the_source_changes(tmp_path):
    src = tmp_path / "bpe.cpp"
    shutil.copy(tnative.SRC_PATH, src)
    build = str(tmp_path / "build")
    lib = native.build_and_load(str(src), build_dir=build)
    first = native.so_path(str(src), build_dir=build)
    assert lib is not None and os.path.isfile(first)
    mtime = os.path.getmtime(first)
    assert native.build_and_load(str(src), build_dir=build) is not None
    assert os.path.getmtime(first) == mtime          # cached, not rebuilt
    with open(src, "a") as f:
        f.write("\n// edited\n")
    second = native.so_path(str(src), build_dir=build)
    assert second != first
    lib2 = native.build_and_load(str(src), build_dir=build)
    assert lib2 is not None and os.path.isfile(second)
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]


def test_failed_build_falls_back_with_a_warning(tmp_path, monkeypatch,
                                                caplog):
    src = tmp_path / "bpe.cpp"
    src.write_text("this is not C++\n")
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.build_and_load(str(src),
                                     build_dir=str(tmp_path)) is None
    assert "Python fallback" in caplog.text
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    # without a native build the Python path serves, ids unchanged
    monkeypatch.setattr(tnative, "_load_native", lambda: None)
    tok = tnative.NativeBPETokenizer.for_vocab(32768)
    assert not tok.native
    assert tok.encode(SAMPLES[4]) == \
        jnative.NativeBPETokenizer.for_vocab(32768).encode(SAMPLES[4])
