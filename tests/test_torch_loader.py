"""Checkpoint loading in the PyTorch port (quoracle_tpu_torch/models/
safetensors_io.py, loader.py, make_checkpoint.py) against the JAX
package's loader and the ``safetensors`` and ``transformers`` libraries,
on the CPU.

* The format: the port's writer read by the library and the library's
  writer read by the port, for every dtype the port maps, with empty and
  scalar tensors, and a two-shard index layout; the same names, dtypes,
  shapes, bytes and metadata.
* ``config_from_hf``: the JAX function's configs field for field, and its
  errors.
* Weights, exactly: ``load_params`` against ``params_from_jax`` of the
  JAX ``load_params`` (bf16 and fp32), exports read back across the
  packages, ``write_weights`` against the JAX module's draws.
* Logits within 1e-4 of the JAX forward (two fp32 layers, sums in
  another order) and within tests/test_loader.py's 2e-4 of
  ``transformers``' eager model; greedy tokens of the two engines equal.

Checkpoints are tests/test_loader.py's tiny ``transformers`` models and
the JAX ``make_checkpoint``'s tiny llama and gemma, written in tmp_path.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file as lib_load
from safetensors.torch import save_file as lib_save

from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import loader as jload
from quoracle_tpu.models import make_checkpoint as jmk
from quoracle_tpu.models import transformer as jtr
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import loader as tload
from quoracle_tpu_torch.models import make_checkpoint as tmk
from quoracle_tpu_torch.models import safetensors_io as S
from quoracle_tpu_torch.models import transformer as ttr
from quoracle_tpu_torch.models.convert import params_from_jax
from test_loader import FACTORIES, make_llama, make_mistral, torch_logits

torch.set_num_threads(1)

DTYPES = sorted(S.DTYPES)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TORCH_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_loader.py's


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------

def _tensors(name: str, seed: int = 0) -> dict:
    """A 2-D, a 1-D, a scalar and an empty tensor of one dtype."""
    g = torch.Generator().manual_seed(seed)
    dt = S.DTYPES[name]
    if dt.is_floating_point:
        full = torch.randn(6, 5, generator=g).to(dt)
    elif dt == torch.bool:
        full = torch.randint(0, 2, (6, 5), generator=g).bool()
    else:
        lo = 0 if dt == torch.uint8 else -100
        full = torch.randint(lo, 100, (6, 5), generator=g).to(dt)
    return {f"{name}.matrix": full, f"{name}.row": full[1].clone(),
            f"{name}.scalar": full[2, 3].clone(),
            f"{name}.empty": torch.empty((0, 3), dtype=dt)}


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert tuple(a[k].shape) == tuple(b[k].shape), k
        assert a[k].reshape(-1).view(torch.uint8).tolist() \
            == b[k].reshape(-1).view(torch.uint8).tolist(), k


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_writer_is_the_library_format(dtype, tmp_path):
    """The port's file is the library's byte for byte (one metadata
    key; the tensors of several dtypes, so their order in the buffer
    shows), and the library reads back the same tensors and metadata."""
    t = {**_tensors(dtype), **_tensors("BOOL", seed=3),
         **_tensors("I64", seed=4), **_tensors("F16", seed=5)}
    ours, theirs = str(tmp_path / "port.st"), str(tmp_path / "lib.st")
    n = S.save_file(t, ours, metadata={"format": "pt"})
    lib_save(t, theirs, metadata={"format": "pt"})
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        raw = f.read()
        assert raw == g.read()
    assert n == len(raw)
    _same(lib_load(ours), t)
    with safe_open(ours, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_reader_reads_the_library_file(dtype, tmp_path):
    t = {**_tensors(dtype, seed=1), **_tensors("F32", seed=2)}
    path = str(tmp_path / "lib.st")
    lib_save(t, path, metadata={"format": "pt", "note": "x"})
    f = S.SafetensorsFile(path)
    _same({k: f.get(k).clone() for k in f.keys()}, t)
    assert f.metadata == {"format": "pt", "note": "x"}
    view = f.get(f"{dtype}.matrix")      # a view of the map, no copy
    assert torch.equal(view, t[f"{dtype}.matrix"])
    del view
    f.close()


def test_two_shard_index_layout(tmp_path):
    """``ShardedReader`` over a ``model.safetensors.index.json``, and
    over the directory's files without one: every tensor from its
    shard."""
    a, b = _tensors("BF16"), _tensors("I32")
    lib_save(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    lib_save(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    with open(tmp_path / S.INDEX_FILE, "w") as f:
        json.dump({"metadata": {}, "weight_map": {
            **{k: "model-00001-of-00002.safetensors" for k in a},
            **{k: "model-00002-of-00002.safetensors" for k in b}}}, f)
    r = S.ShardedReader(str(tmp_path))
    assert r.names() == set(a) | set(b)
    _same({k: r.get(k).clone() for k in r.names()}, {**a, **b})
    r.close()
    # no index: every *.safetensors file of the directory
    os.remove(tmp_path / S.INDEX_FILE)
    r = S.ShardedReader(str(tmp_path))
    _same({k: r.get(k).clone() for k in r.names()}, {**a, **b})
    r.close()


def test_sharded_checkpoint_loads_as_in_jax(tmp_path):
    from transformers import LlamaForCausalLM
    path, _ = make_llama(tmp_path / "one")
    sharded = str(tmp_path / "sharded")
    LlamaForCausalLM.from_pretrained(path).save_pretrained(
        sharded, max_shard_size="60KB", safe_serialization=True)
    with open(os.path.join(sharded, S.INDEX_FILE)) as f:
        assert len(set(json.load(f)["weight_map"].values())) >= 2
    _assert_loads_as_jax(sharded, torch.float32)


@pytest.mark.parametrize("case", ["gap", "dtype", "span", "tail"])
def test_reader_rejects_broken_headers(case, tmp_path):
    path = str(tmp_path / "x.st")
    lib_save({"a": torch.zeros(4), "b": torch.ones(2)}, path)
    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[:8], "little")
    head = json.loads(raw[8:8 + n])
    body = raw[8 + n:]
    if case == "gap":
        head["a"]["data_offsets"] = [8, 24]
        head["b"]["data_offsets"] = [24, 32]
        body = body + b"\0" * 8
    elif case == "dtype":
        head["a"]["dtype"] = "F8_E4M3"
    elif case == "span":
        head["a"]["shape"] = [5]
    else:
        body = body + b"\0"
    text = json.dumps(head).encode()
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text + body)
    with pytest.raises(ValueError):
        S.SafetensorsFile(path)


# ---------------------------------------------------------------------------
# config_from_hf
# ---------------------------------------------------------------------------

def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("vision")
    return d


def _hf(**kw) -> dict:
    return {"architectures": ["LlamaForCausalLM"], "vocab_size": 8,
            "hidden_size": 8, "num_hidden_layers": 1,
            "num_attention_heads": 2, "intermediate_size": 8, **kw}


@pytest.mark.parametrize("family", sorted(FACTORIES))
def test_config_from_hf_matches_jax(family, tmp_path):
    path, _ = FACTORIES[family](tmp_path / family)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    assert _fields(tload.config_from_hf(hf, "x", path)) == _fields(
        jload.config_from_hf(hf, "x", path))


@pytest.mark.parametrize("hf", [
    _hf(rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32}),
    _hf(rope_scaling={"type": "linear", "factor": 2.0}),
    _hf(rope_scaling={"rope_type": "default"}),
    _hf(eos_token_id=[128001, 128008, 128009], bos_token_id=128000),
    _hf(eos_token_id=0, bos_token_id=0),
    _hf(architectures=["Qwen2ForCausalLM"], sliding_window=4096,
        use_sliding_window=False),
    _hf(architectures=["MistralForCausalLM"], sliding_window=64,
        num_key_value_heads=1, head_dim=16, tie_word_embeddings=True,
        attention_bias=True, hidden_act="gelu_new", rms_norm_eps=1e-6),
], ids=["llama3", "linear", "default", "eos_list", "eos_zero",
        "no_sliding", "mistral_misc"])
def test_config_variants_match_jax(hf):
    assert _fields(tload.config_from_hf(hf, "v")) == _fields(
        jload.config_from_hf(hf, "v"))


@pytest.mark.parametrize("hf", [
    _hf(architectures=["GPTBigCodeForCausalLM"]),
    _hf(rope_scaling={"rope_type": "yarn", "factor": 2.0}),
    _hf(hidden_act="relu"),
], ids=["arch", "rope", "act"])
def test_config_from_hf_raises_where_jax_raises(hf):
    with pytest.raises(ValueError) as jerr:
        jload.config_from_hf(hf, "bad")
    with pytest.raises(ValueError) as terr:
        tload.config_from_hf(hf, "bad")
    assert str(terr.value) == str(jerr.value)


VISION_HF = _hf(image_token_id=3, vision_config=dict(
    image_size=28, patch_size=14, hidden_size=32, num_hidden_layers=1,
    num_attention_heads=2, intermediate_size=64))


def test_vision_config_raises_not_implemented():
    """Once refused, now read as the JAX loader reads it: a
    ``vision_config`` gives the same ModelConfig field for field (the
    tower's geometry included), and a missing ``image_token_id`` the same
    error."""
    got = tload.config_from_hf(VISION_HF, "vlm")
    want = jload.config_from_hf(VISION_HF, "vlm")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vision.n_patches == want.vision.n_patches == 4
    bad = {k: v for k, v in VISION_HF.items() if k != "image_token_id"}
    with pytest.raises(ValueError) as jerr:
        jload.config_from_hf(bad, "vlm")
    with pytest.raises(ValueError) as terr:
        tload.config_from_hf(bad, "vlm")
    assert str(terr.value) == str(jerr.value)


def test_vlm_checkpoint_roundtrip_and_serves_images(tmp_path):
    """tests/test_loader.py's vlm case on both packages: the JAX
    make_checkpoint's tiny vlm directory registers with the same config,
    loads the same weights, the tower's bit for bit (fp32 and bf16), and
    both backends serve a multimodal message with the same text (fp32
    engines over the loaded weights, the checkpoint's tokenizer)."""
    import base64
    from quoracle_tpu.models import embeddings as jemb
    from quoracle_tpu.models import runtime as jrt
    from quoracle_tpu.models import tokenizer as jtok
    from quoracle_tpu.models.images import write_png
    from quoracle_tpu_torch.models import runtime as trt
    from quoracle_tpu_torch.models import tokenizer as ttok

    out = jmk.make_checkpoint(str(tmp_path / "vlm"), family="vlm",
                              scale="tiny")
    jcfg = jload.register_hf_checkpoint(out, name="ck-vlm-test")
    tcfg = tload.register_hf_checkpoint(out, name="ck-vlm-test")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.vision.n_patches == 4 and tcfg.image_token_id is not None
    for dtype in (torch.float32, torch.bfloat16):
        _, model = _assert_loads_as_jax(out, dtype)
        tower = model.vision
        assert tower.layers[0].wqkv.weight.shape == (3 * tcfg.vision.dim,
                                                     tcfg.vision.dim)
        assert tower.projector.weight.shape == (tcfg.dim, tcfg.vision.dim)

    rng = np.random.default_rng(3)
    png = str(tmp_path / "i.png")
    write_png(png, rng.integers(0, 255, (28 * 28 * 3,),
                                dtype=np.uint8).tobytes(), 28, 28)
    b64 = base64.b64encode(open(png, "rb").read()).decode()
    spec = "xla:ck-vlm-test"
    msgs = [{"role": "user", "content": [
        {"type": "text", "text": "describe"},
        {"type": "image_base64", "data": b64}]}]
    jp = jax.tree.map(jnp.asarray, jload.load_params(out, jcfg, np.float32))
    je = jgen.GenerateEngine(jcfg, jp, jtok.get_tokenizer(spec))
    te = tgen.GenerateEngine(tcfg, tload.load_params(out, tcfg, device="cpu",
                                                     dtype=torch.float32),
                             ttok.get_tokenizer(spec), device="cpu")
    jb = jrt.TPUBackend([spec], engines={spec: je},
                        embedder=jemb.EmbeddingEncoder(jcfg, jp,
                                                       je.tokenizer))
    tb = trt.TorchBackend([spec], device="cpu", engines={spec: te})
    got = []
    for b, mod in ((jb, jrt), (tb, trt)):
        r = b.query([mod.QueryRequest(spec, msgs, temperature=0.0,
                                      max_tokens=6)])[0]
        assert r.ok, r.error
        got.append((r.text, r.usage.prompt_tokens,
                    r.usage.completion_tokens))
    assert got[1] == got[0]
    assert got[1][1] > tcfg.vision.n_patches


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else ml_dtypes.bfloat16


def _assert_same_model(a, b) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


def _assert_loads_as_jax(path: str, dtype: torch.dtype):
    tcfg = tload._read_config(path, "w")
    jcfg = jload._read_config(path, "w")
    got = tload.load_params(path, tcfg, device="cpu", dtype=dtype)
    want = params_from_jax(jload.load_params(path, jcfg, _np_dtype(dtype)),
                           tcfg, dtype=dtype)
    _assert_same_model(got, want)
    return tcfg, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("family", sorted(FACTORIES))
def test_load_params_equals_jax_load_params(family, dtype, tmp_path):
    path, _ = FACTORIES[family](tmp_path / family)
    _assert_loads_as_jax(path, dtype)


@pytest.fixture(scope="module")
def jax_made(tmp_path_factory):
    """The JAX make_checkpoint's tiny llama and gemma."""
    root = tmp_path_factory.mktemp("jax-made")
    return {fam: jmk.make_checkpoint(str(root / fam), family=fam,
                                     scale="tiny", seed=i)
            for i, fam in enumerate(("llama", "gemma"))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_load_params_of_jax_made_checkpoints(jax_made, family, dtype):
    _, model = _assert_loads_as_jax(jax_made[family], dtype)
    assert (model.lm_head is None) == (family == "gemma")


def test_prefix_free_naming_loads_as_in_jax(tmp_path):
    """Exports without the decoder's "model." prefix; lm_head stays at
    the top level."""
    path, _ = make_llama(tmp_path / "ck")
    file = os.path.join(path, "model.safetensors")
    t = lib_load(file)
    lib_save({k[len("model."):] if k.startswith("model.") else k: v
              for k, v in t.items()}, file, metadata={"format": "pt"})
    assert "embed_tokens.weight" in lib_load(file)
    _assert_loads_as_jax(path, torch.float32)


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_exports_read_across_packages(jax_made, family, tmp_path):
    """The port's export read by the JAX loader and the JAX export read
    by the port's loader give the same weights (bf16 on disk)."""
    base = jax_made[family]
    tcfg, model = tload.load_checkpoint(base, "x", device="cpu",
                                        dtype=torch.float32)
    jcfg = jload._read_config(base, "x")
    out = tload.export_hf_checkpoint(model, tcfg, str(tmp_path / "port"),
                                     base)
    assert sorted(os.listdir(out)) == sorted(
        [".complete", "config.json", "model.safetensors", "tokenizer.json",
         "tokenizer_config.json"])
    with safe_open(os.path.join(out, "model.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt"}
    back = params_from_jax(jload.load_params(out, jcfg, np.float32), tcfg)
    _assert_same_model(back, model)      # bf16 weights survive bf16

    jout = jload.export_hf_checkpoint(
        jload.load_params(base, jcfg, np.float32), jcfg,
        str(tmp_path / "jax"), base)
    _assert_same_model(tload.load_params(jout, tcfg, device="cpu",
                                         dtype=torch.float32), model)
    # the two exports hold the same tensors
    a, b = lib_load(os.path.join(out, "model.safetensors")), lib_load(
        os.path.join(jout, "model.safetensors"))
    _same(a, b)


@pytest.mark.parametrize("scale,family", [("tiny", "llama"),
                                          ("tiny", "gemma"),
                                          ("tiny", "vlm"),
                                          ("small", "llama")])
def test_write_weights_matches_the_jax_module(scale, family, tmp_path):
    hf = dict(jmk.FAMILY_CONFIGS[scale][family], bos_token_id=1,
              eos_token_id=2)
    assert tmk.FAMILY_CONFIGS[scale][family] == \
        jmk.FAMILY_CONFIGS[scale][family]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jmk.write_weights(str(tmp_path / "j"), hf, seed=5)
    n = tmk.write_weights(str(tmp_path / "t"), hf, seed=5)
    a = lib_load(str(tmp_path / "j" / "model.safetensors"))
    b = lib_load(str(tmp_path / "t" / "model.safetensors"))
    _same(a, b)
    assert n == os.path.getsize(tmp_path / "t" / "model.safetensors")


@pytest.mark.parametrize("case", ["missing", "shape", "extra", "nofile"])
def test_load_params_raises(case, tmp_path):
    path, _ = make_llama(tmp_path / "ck")
    cfg = tload._read_config(path, "bad")
    file = os.path.join(path, "model.safetensors")
    t = lib_load(file)
    if case == "missing":
        del t["model.layers.1.mlp.up_proj.weight"]
        err = KeyError
    elif case == "shape":
        cfg = dataclasses.replace(cfg, ffn_dim=96)
        err = ValueError
    elif case == "extra":
        t["model.layers.0.self_attn.q_norm.weight"] = torch.ones(16)
        err = ValueError
    else:
        os.remove(file)
        err = FileNotFoundError
    if case in ("missing", "extra"):
        lib_save(t, file)
    with pytest.raises(err):
        tload.load_params(path, cfg, device="cpu")


def test_tied_lm_head_in_file_is_allowed(jax_made, tmp_path):
    """A tied model's file may still carry lm_head (some exports do);
    the weight it uses is the embedding, as in the JAX loader."""
    import shutil
    path = shutil.copytree(jax_made["gemma"], str(tmp_path / "g"))
    file = os.path.join(path, "model.safetensors")
    t = lib_load(file)
    t["lm_head.weight"] = t["model.embed_tokens.weight"].clone()
    lib_save(t, file)
    _assert_loads_as_jax(path, torch.float32)


# ---------------------------------------------------------------------------
# logits and tokens
# ---------------------------------------------------------------------------

def _port_logits(cfg, model, ids: np.ndarray) -> np.ndarray:
    B, T = ids.shape
    tokens = torch.as_tensor(ids, dtype=torch.int32)
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    cache = ttr.init_cache(cfg, B, T, "cpu", dtype=torch.float32)
    h, _ = ttr.forward_hidden(model, cfg, tokens, pos, cache,
                              torch.zeros(B, dtype=torch.int32),
                              torch.full((B,), T, dtype=torch.int32))
    return ttr.project_logits(model, cfg, h).numpy()


def _jax_logits(cfg, params, ids: np.ndarray) -> np.ndarray:
    B, T = ids.shape
    cache = jtr.init_cache(cfg, B, T, dtype=jnp.float32)
    logits, _ = jtr.forward(
        params, cfg, jnp.asarray(ids, jnp.int32),
        jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T)),
        cache, write_offset=jnp.zeros((B,), jnp.int32),
        kv_lens=jnp.full((B,), T, jnp.int32))
    return np.asarray(logits)


def _make_llama3(path):
    return make_llama(path, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 32})


LOGIT_CASES = {
    # name: (factory, ids shape, seed)
    **{f: (FACTORIES[f], (2, 16), 42) for f in FACTORIES},
    "mistral_window": (make_mistral, (1, 16), 7),   # T 16 > window 8
    "llama3_rope": (_make_llama3, (1, 48), 11),
}


@pytest.mark.parametrize("case", sorted(LOGIT_CASES))
def test_logits_match_jax_and_transformers(case, tmp_path):
    factory, shape, seed = LOGIT_CASES[case]
    path, _ = factory(tmp_path / case)
    tcfg, model = tload.load_checkpoint(path, f"lg-{case}", device="cpu",
                                        dtype=torch.float32)
    jcfg, params = jload.load_checkpoint(path, f"lg-{case}",
                                         dtype=np.float32)
    if case == "mistral_window":
        assert tcfg.sliding_window == 8
    if case == "llama3_rope":
        assert tcfg.rope_scaling == ("llama3", 8.0, 1.0, 4.0, 32)
    ids = np.random.default_rng(seed).integers(3, 250, shape)
    ours = _port_logits(tcfg, model, ids)
    np.testing.assert_allclose(
        ours, _jax_logits(jcfg, jax.tree.map(jnp.asarray, params), ids),
        **LOGIT_TOL)
    np.testing.assert_allclose(ours, torch_logits(path, ids), **TORCH_TOL)


class _IdTok:
    """Identity 'tokenizer': the engines run on raw ids."""
    pad_id, bos_id, eos_id = 0, 1, 2

    def decode(self, ids):
        return " ".join(map(str, ids))


def _engines(path: str, name: str, **replace):
    tcfg, model = tload.load_checkpoint(path, name, device="cpu",
                                        dtype=torch.float32)
    jcfg, params = jload.load_checkpoint(path, name, dtype=np.float32)
    tcfg = dataclasses.replace(tcfg, **replace)
    jcfg = dataclasses.replace(jcfg, **replace)
    return (jgen.GenerateEngine(jcfg, jax.tree.map(jnp.asarray, params),
                                _IdTok(), max_seq=64,
                                prompt_buckets=(16, 32)),
            tgen.GenerateEngine(tcfg, model, _IdTok(), max_seq=64,
                                prompt_buckets=(16, 32), device="cpu"))


def _greedy(eng, prompt, n=8):
    r = eng.generate([prompt], temperature=0.0, max_new_tokens=n)[0]
    return list(r.token_ids), r.finish_reason


@pytest.mark.parametrize("family", ["llama", "gemma", "qwen2"])
def test_engine_greedy_tokens_match_jax(family, tmp_path):
    path, _ = FACTORIES[family](tmp_path / family)
    jeng, teng = _engines(path, f"gd-{family}")
    prompt = [int(x) for x in np.random.default_rng(9).integers(3, 250, 12)]
    assert _greedy(teng, prompt) == _greedy(jeng, prompt)


def test_engines_stop_on_a_secondary_stop_id(tmp_path):
    path, _ = make_llama(tmp_path / "st")
    prompt = [int(x) for x in np.random.default_rng(5).integers(3, 250, 8)]
    _, teng = _engines(path, "st0")
    base, _ = _greedy(teng, prompt)
    assert len(base) >= 2
    second = base[1]
    jeng, teng = _engines(path, "st1", stop_token_ids=(second,))
    got = _greedy(teng, prompt)
    assert got == _greedy(jeng, prompt)
    assert got == (base[:base.index(second)], "stop")


def test_make_checkpoint_with_overrides_loads(tmp_path):
    """A family's config with fields replaced (the chip smoke's tiny
    checkpoints at the kernels' head dims): config.json, weights and
    tokenizer files agree with each other and the loader reads them."""
    widths = dict(hidden_size=256, intermediate_size=512,
                  num_attention_heads=2, num_key_value_heads=2,
                  head_dim=256)
    d = tmk.make_checkpoint(str(tmp_path / "g"), family="gemma",
                            scale="tiny", seed=3, overrides=widths)
    cfg, model = tload.load_checkpoint(d, "ov", device="cpu",
                                       dtype=torch.float32)
    assert (cfg.dim, cfg.head_dim, cfg.n_heads, cfg.vocab_size) == (
        256, 256, 2, 2048)
    assert cfg.tie_embeddings and cfg.rmsnorm_plus_one
    assert model.layers[0].wq.weight.shape == (512, 256)
    assert (cfg.bos_token_id, cfg.eos_token_id) == (1, 2)
    # the JAX loader reads the port's directory the same way
    _assert_loads_as_jax(d, torch.float32)
