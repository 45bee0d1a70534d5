"""Serving checkpoints whose tokenizers are SentencePiece-form BPE, in the
PyTorch port against the JAX package, on the CPU.

Tiny checkpoints (the JAX ``make_checkpoint``'s llama and gemma, fp32,
and the llama as a windowed Mistral) carry chip_smoke.py's Mistral-form
and Gemma-form tokenizer files (byte fallback; the Prepend and Replace
normalizers; the Replace, ByteFallback, Fuse and Strip decoders;
``[INST]`` or ``<start_of_turn>`` chat templates). Greedy, both
packages: a session's round and two resumed rounds through each backend
(the session splice re-encodes the suffix after ``decode_raw``: with a
Prepend normalizer the suffix gains a leading U+2581 the full prompt
lacks), then a decide of the port's ConsensusEngine over the port's
TorchBackend against the JAX engine over the JAX TPUBackend, and the
agent's next step; then the CLI's ``--checkpoint``. Texts, cached
tokens, token counts and outcomes must be equal.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_consensus import outcome_view
from quoracle_tpu.consensus import engine as jce
from quoracle_tpu.models import config as jconfig
from quoracle_tpu.models import embeddings as jemb
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import loader as jload
from quoracle_tpu.models import make_checkpoint as jmk
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.models import transformer as jtr
from quoracle_tpu_torch.consensus import engine as tce
from quoracle_tpu_torch.models import config as tconfig
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import loader as tload
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import tokenizer as ttok

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# checkpoint name -> (tokenizer form, family, seed, sliding window)
CKPTS = {"mistral": ("mistral", "llama", 0, None),
         "gemma": ("gemma", "gemma", 1, None),
         "mistral-window": ("mistral", "llama", 2, 64)}
POOL = ["xla:sp-mistral", "xla:sp-gemma"]
SYSTEM = ("You are one agent of a consensus pool. Respond with a single "
          "JSON action object. Rule: keep it short; don't wait — ½ ✓.")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Each form's files over a tiny checkpoint of its family, the
    config's special ids set to the form's; mistral-window is the
    Mistral form over a windowed model (MistralForCausalLM, window 64)."""
    root = tmp_path_factory.mktemp("sp-ckpts")
    out = {}
    for name, (form, family, seed, window) in CKPTS.items():
        d = jmk.make_checkpoint(str(root / name), family=family,
                                scale="tiny", seed=seed)
        with open(os.path.join(d, "config.json")) as f:
            hf = json.load(f)
        ids = chip_smoke.write_sp_tokenizer(d, form, hf["vocab_size"])
        f = chip_smoke.SP_FORMS[form]
        hf.update(bos_token_id=ids[f["bos"]], eos_token_id=ids[f["eos"]],
                  pad_token_id=ids[f["pad"] or f["eos"]])
        if window:
            hf.update(architectures=["MistralForCausalLM"],
                      sliding_window=window)
        with open(os.path.join(d, "config.json"), "w") as fh:
            json.dump(hf, fh)
        for mod in (jload, tload):
            mod.register_hf_checkpoint(d, name=f"sp-{name}")
        out[name] = d
    return out


def _engine(pkg: str, spec: str):
    """An fp32 engine over ``spec``'s checkpoint on the unified tier,
    prefix sharing off."""
    if pkg == "jax":
        cfg = jconfig.get_model_config(spec)
        params = jax.tree.map(jnp.asarray, jload.load_params(
            cfg.checkpoint_path, cfg, np.float32))
        eng = jgen.GenerateEngine(cfg, params, jtok.get_tokenizer(spec))
    else:
        cfg = tconfig.get_model_config(spec)
        eng = tgen.GenerateEngine(
            cfg, tload.load_params(cfg.checkpoint_path, cfg, device="cpu",
                                   dtype=torch.float32),
            ttok.get_tokenizer(spec), device="cpu")
    eng.unified_min_tokens = 0
    eng.prefix_sharing = False
    return eng


def _backend(pkg: str, pool: list):
    engines = {s: _engine(pkg, s) for s in pool}
    if pkg == "jax":
        e0 = engines[pool[0]]
        return jrt.TPUBackend(pool, engines=engines,
                              embedder=jemb.EmbeddingEncoder(
                                  e0.cfg, e0.params, e0.tokenizer))
    return trt.TorchBackend(pool, device="cpu", engines=engines)


@pytest.fixture
def greedy(monkeypatch):
    for mod in (jce, tce):
        monkeypatch.setattr(mod, "temperature_for_round",
                            lambda *a, **kw: 0.0)
    monkeypatch.setattr(jemb, "init_cache", functools.partial(
        jtr.init_cache, dtype=jnp.float32))


@pytest.mark.parametrize("name", sorted(CKPTS))
def test_resumed_rounds_match_jax(ckpts, name):
    """A windowed model resumes only on a clean extension (both packages'
    rule), which a re-encoded answer under a Prepend normalizer seldom
    gives: its cached tokens are held equal, not above zero."""
    spec = f"xla:sp-{name}"
    rt = {"jax": jrt, "port": trt}
    runs = {}
    for pkg in ("jax", "port"):
        backend = _backend(pkg, [spec])
        tok = backend.engines[spec].tokenizer
        assert type(tok).__name__ == "HFAutoTokenizer"
        msgs = [{"role": "system", "content": SYSTEM},
                {"role": "user", "content": "Report status  漢字 🙂."}]
        rows = []
        for rnd in range(3):
            r = backend.query([rt[pkg].QueryRequest(
                spec, msgs, temperature=0.0, max_tokens=24,
                session_id="sp-session", constrain_json=rnd != 1)])[0]
            assert r.ok, r.error
            rows.append((r.text, r.cached_tokens, r.usage.prompt_tokens,
                         r.usage.completion_tokens))
            msgs = msgs + [{"role": "assistant", "content": r.text},
                           {"role": "user", "content": f"refine {rnd}"}]
        runs[pkg] = rows, tok.encode_chat(msgs), tok.decode_raw(
            tok.encode_chat(msgs))
        backend.close()
    assert runs["port"] == runs["jax"]
    rows = runs["port"][0]
    assert rows[0][1] == 0
    if CKPTS[name][3] is None:
        assert rows[1][1] > 0 and rows[2][1] > rows[1][1]


def _decides(ce, backend):
    messages = [{"role": "system", "content": SYSTEM},
                {"role": "user", "content": "decide the next step"}]
    engine = ce.ConsensusEngine(backend, ce.ConsensusConfig(
        model_pool=list(POOL), max_refinement_rounds=2,
        session_key="sp-agent", allowed_actions={"wait"}, max_tokens=24))
    first = engine.decide({m: list(messages) for m in POOL})
    nxt = {}
    for m in POOL:
        raw = next((p.raw_text for p in first.proposals
                    if p.model_spec == m), None)
        if raw is None:
            raw = next((f.raw_text for f in first.failures
                        if f.model_spec == m), "")
        nxt[m] = messages + [{"role": "assistant", "content": raw},
                             {"role": "user", "content": "result: waited"}]
    return first, engine.decide(nxt)


def test_decide_matches_jax(ckpts, greedy):
    ref = _decides(jce, _backend("jax", POOL))
    got = _decides(tce, _backend("port", POOL))
    assert [outcome_view(o) for o in got] == [outcome_view(o) for o in ref]
    assert got[0].cached_tokens == 0 and got[1].cached_tokens > 0


def test_cli_checkpoint_flag_serves_the_form(ckpts, tmp_path):
    """``--checkpoint DIR`` (the CLI's flags through its RuntimeConfig):
    the runtime registers the directory and its backend serves it with
    the directory's own tokenizer."""
    import shutil

    from quoracle_tpu_torch import cli
    from quoracle_tpu_torch.runtime import Runtime
    d = shutil.copytree(ckpts["gemma"], str(tmp_path / "sp-cli-gemma"))
    args = cli.build_parser().parse_args(
        ["run", "--backend", "torch", "--device", "cpu", "--checkpoint", d,
         "task"])
    rt = Runtime(cli._config(args))
    try:
        spec = "xla:sp-cli-gemma"
        tok = rt.backend.engines[spec].tokenizer
        want = jtok.HFAutoTokenizer(d)
        assert isinstance(tok, ttok.HFAutoTokenizer)
        msgs = [{"role": "user", "content": "status  漢字"}]
        assert tok.encode_chat(msgs) == want.encode_chat(msgs)
        r = rt.backend.query([trt.QueryRequest(
            spec, msgs, temperature=0.0, max_tokens=6)])[0]
        assert r.ok, r.error
    finally:
        rt.close()
