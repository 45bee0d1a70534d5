"""Checkpoint serving in the PyTorch port against the JAX package, on the
CPU: a generated HF checkpoint (the JAX ``make_checkpoint``'s tiny llama
and gemma) -> the loader -> the checkpoint's own tokenizer and chat
template -> ``TorchBackend``, with sessions, constrained decoding and
speculative serving.

The JAX file's backend cases (tests/test_checkpoint_serving.py, and
tests/test_speculative.py's two checkpoint-backed backend cases) run on
both packages with fp32 engines over the same checkpoint: texts, cached
tokens, prefill counts and the decoders' sessions must be equal.
``TorchBackend``'s own build (bf16, no engines handed in) must load the
checkpoint bit for bit; the embedder's vectors agree within 1e-5 (fp32
sums in another order); int8 over the loaded weights equals JAX
``quantize_params`` bit for bit.
"""

import functools
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quoracle_tpu.models import config as jconfig
from quoracle_tpu.models import embeddings as jemb
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import loader as jload
from quoracle_tpu.models import make_checkpoint as jmk
from quoracle_tpu.models import quant as jq
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.models import transformer as jtr
from quoracle_tpu_torch.models import config as tconfig
from quoracle_tpu_torch.models import embeddings as temb
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import loader as tload
from quoracle_tpu_torch.models import quant as tq
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import tokenizer as ttok

torch.set_num_threads(1)

JAX = types.SimpleNamespace(name="jax", rt=jrt, gen=jgen, load=jload,
                            tok=jtok, cfg=jconfig)
PORT = types.SimpleNamespace(name="port", rt=trt, gen=tgen, load=tload,
                             tok=ttok, cfg=tconfig)
PKGS = (JAX, PORT)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """target llama (seed 0), draft llama (seed 9), gemma (seed 1): the
    draft shares the target's tokenizer (same corpus and vocab)."""
    root = tmp_path_factory.mktemp("ckpts")
    out = {name: jmk.make_checkpoint(str(root / name), family=fam,
                                     scale="tiny", seed=seed)
           for name, fam, seed in (("llama-t", "llama", 0),
                                   ("llama-d", "llama", 9),
                                   ("gemma-t", "gemma", 1))}
    for pkg in PKGS:
        for name, path in out.items():
            pkg.load.register_hf_checkpoint(path, name=f"ts-{name}")
    return out


def _engine(pkg, spec: str):
    """An fp32 engine over the checkpoint of ``spec``."""
    cfg = pkg.cfg.get_model_config(spec)
    if pkg is JAX:
        params = jax.tree.map(jnp.asarray, jload.load_params(
            cfg.checkpoint_path, cfg, np.float32))
        return jgen.GenerateEngine(cfg, params, jtok.get_tokenizer(spec))
    model = tload.load_params(cfg.checkpoint_path, cfg, device="cpu",
                              dtype=torch.float32)
    return tgen.GenerateEngine(cfg, model, ttok.get_tokenizer(spec),
                               device="cpu")


def _backend(pkg, pool, extra=(), **kw):
    engines = {s: _engine(pkg, s) for s in (*pool, *extra)}
    if pkg is JAX:
        e0 = engines[pool[0]]
        return jrt.TPUBackend(pool, engines=engines,
                              embedder=jemb.EmbeddingEncoder(
                                  e0.cfg, e0.params, e0.tokenizer), **kw)
    return trt.TorchBackend(pool, device="cpu", engines=engines, **kw)


def both(script):
    """``script(pkg)`` on both packages; equal outputs."""
    out = {pkg.name: script(pkg) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def test_checkpoint_registers_with_own_tokenizer(ckpts):
    def script(pkg):
        cfg = pkg.cfg.get_model_config("xla:ts-llama-t")
        assert cfg.checkpoint_path == ckpts["llama-t"]
        tok = pkg.tok.get_tokenizer("xla:ts-llama-t")
        assert isinstance(tok, pkg.tok.HFAutoTokenizer)
        ids = tok.encode_chat([{"role": "user", "content": "hello"}])
        assert ids[0] == cfg.bos_token_id
        assert tok.decode(tok.encode("hello world")) == "hello world"
        assert tok.count("hello world") == len(tok.encode("hello world"))
        return ids, tok.encode("hello world"), tok.vocab_size
    both(script)


def test_backend_serves_checkpoint_with_sessions_and_grammar(ckpts):
    """tests/test_checkpoint_serving.py's case on both packages, greedy
    (the JAX case samples): a constrained sessioned round, the refinement
    round resumes (only the suffix prefills), the drop forgets the
    session."""
    spec = "xla:ts-llama-t"
    msgs = [{"role": "system", "content": "You decide actions."},
            {"role": "user", "content": "Report status, then continue."}]

    def script(pkg):
        backend = _backend(pkg, [spec])
        engine = backend.engines[spec]
        r1 = backend.query([pkg.rt.QueryRequest(
            model_spec=spec, messages=msgs, max_tokens=48,
            temperature=0.0, session_id="agent-e2e",
            constrain_json=True)])[0]
        assert r1.ok, r1.error
        assert r1.usage.prompt_tokens > 0 and r1.usage.completion_tokens > 0
        msgs2 = msgs + [{"role": "assistant", "content": r1.text or "…"},
                        {"role": "user", "content": "Refine your proposal."}]
        r2 = backend.query([pkg.rt.QueryRequest(
            model_spec=spec, messages=msgs2, max_tokens=32,
            temperature=0.0, session_id="agent-e2e",
            constrain_json=True)])[0]
        assert r2.ok, r2.error
        full = len(engine.tokenizer.encode_chat(msgs2))
        assert engine.last_prefill_tokens < full
        prefill = engine.last_prefill_tokens
        backend.drop_session("agent-e2e")
        assert len(engine.sessions) == 0
        backend.close()
        return ([(r.text, r.cached_tokens, r.usage.prompt_tokens,
                  r.usage.completion_tokens) for r in (r1, r2)], prefill)
    both(script)


def test_backend_draft_map_serves_speculatively(ckpts):
    """tests/test_speculative.py's checkpoint-backed draft_map case on
    both packages: greedy JSON rows through the batch-1 decoder equal a
    vanilla backend's, the decoder's sessions grow across refinement
    rounds, the draft is not a servable member, a prompt with no room
    falls through to context_overflow."""
    t, d = "xla:ts-llama-t", "xla:ts-llama-d"
    msgs1 = [{"role": "system", "content": "Respond with JSON."},
             {"role": "user", "content": "report status"}]

    def script(pkg):
        R = pkg.rt
        vanilla = _backend(pkg, [t])
        spec = _backend(pkg, [t], extra=[d], draft_map={t: d}, draft_k=4)
        assert t in spec._spec_decoders
        assert d in spec.engines and d not in spec.pool

        def ask(backend, msgs, session=None):
            return backend.query([R.QueryRequest(
                t, msgs, temperature=0.0, max_tokens=32,
                constrain_json=True, session_id=session)])[0]
        bad = spec.query([R.QueryRequest(d, msgs1, max_tokens=8)])[0]
        assert not bad.ok and bad.permanent_error
        over = spec.query([R.QueryRequest(
            t, [{"role": "user", "content": "x " * 3000}],
            max_tokens=8)])[0]
        assert not over.ok and "context_overflow" in (over.error or "")
        want, got = ask(vanilla, msgs1), ask(spec, msgs1)
        assert got.ok and want.ok
        assert got.text == want.text, "speculative backend diverged"
        assert got.usage.completion_tokens == want.usage.completion_tokens
        r1 = ask(spec, msgs1, session="ag1")
        dec = spec._spec_decoders[t]
        resident = list(dec._sessions["ag1"]["ctx"])
        msgs2 = msgs1 + [{"role": "assistant", "content": r1.text},
                         {"role": "user", "content": "refine it"}]
        r2 = ask(spec, msgs2, session="ag1")
        assert r2.ok
        grown = list(dec._sessions["ag1"]["ctx"])
        assert len(grown) > len(resident)
        v1 = ask(vanilla, msgs1, session="vg1")
        v2 = ask(vanilla, msgs2, session="vg1")
        assert (v1.text, v2.text) == (r1.text, r2.text)
        vanilla.close()
        spec.close()
        return ([(r.text, r.cached_tokens, r.spec_rounds,
                  r.usage.completion_tokens) for r in (got, r1, r2)],
                [int(x) for x in resident], [int(x) for x in grown],
                over.error, bad.error)
    both(script)


def test_backend_contention_falls_back_to_batching(ckpts):
    """tests/test_speculative.py's contention case on both packages, a
    self-draft over the checkpoint: with the decoder's lock held every
    caller takes the baton path and completes; an uncontended re-ask
    reproduces the speculative path's answer."""
    t = "xla:ts-llama-t"

    def script(pkg):
        spec = _backend(pkg, [t], draft_map={t: t}, draft_k=3)
        vanilla = _backend(pkg, [t])
        dec = spec._spec_decoders[t]

        def ask(backend, i):
            return backend.query([pkg.rt.QueryRequest(
                t, [{"role": "user", "content": f"concurrent task {i}"}],
                temperature=0.0, max_tokens=16)])[0]
        r0 = ask(spec, 0)
        assert r0.ok and r0.spec_rounds > 0
        assert r0.text == ask(vanilla, 0).text
        results: list = [None] * 4
        dec.lock.acquire()
        try:
            threads = [threading.Thread(
                target=lambda i=i: results.__setitem__(i, ask(spec, i)))
                for i in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        finally:
            dec.lock.release()
        assert all(r is not None and r.ok and r.text for r in results)
        assert all(r.spec_rounds == 0 for r in results)
        again = ask(spec, 0)
        assert again.text == r0.text
        spec.close()
        vanilla.close()
        return r0.text, sorted(r.text for r in results)
    both(script)


def test_torch_backend_builds_from_the_checkpoint(ckpts):
    """No engines handed in: members, drafts and the embedder's own model
    load the checkpoint (bf16, bit for bit), with its tokenizer."""
    t, d, g = "xla:ts-llama-t", "xla:ts-llama-d", "xla:ts-gemma-t"
    b = trt.TorchBackend([t], device="cpu", draft_map={t: d}, draft_k=2,
                         embed_model=g)
    for spec in (t, d):
        cfg = tconfig.get_model_config(spec)
        want = tload.load_params(cfg.checkpoint_path, cfg, device="cpu")
        got = b.engines[spec].params
        assert got.dtype == torch.bfloat16
        for (k, v), (k2, w) in zip(got.state_dict().items(),
                                   want.state_dict().items()):
            assert k == k2 and torch.equal(v, w), k
        assert isinstance(b.engines[spec].tokenizer, ttok.HFAutoTokenizer)
    assert g not in b.engines
    gcfg = tconfig.get_model_config(g)
    want = tload.load_params(gcfg.checkpoint_path, gcfg, device="cpu")
    assert torch.equal(b.embedder.params.embed.weight, want.embed.weight)
    assert isinstance(b.embedder.tokenizer, ttok.HFAutoTokenizer)
    r = b.query([trt.QueryRequest(t, [{"role": "user", "content": "hi"}],
                                  temperature=0.0, max_tokens=8)])[0]
    assert r.ok, r.error
    b.close()


def test_unsupported_checkpoint_raises_in_the_backend(ckpts, tmp_path):
    """No fallback: a checkpoint whose tokenizer the port cannot read
    fails the backend's build, never serving the native tokenizer."""
    import json
    import shutil
    d = shutil.copytree(ckpts["llama-t"], str(tmp_path / "ck"))
    with open(f"{d}/tokenizer.json") as f:
        spec = json.load(f)
    spec["normalizer"] = {"type": "Precompiled", "precompiled_charsmap": ""}
    with open(f"{d}/tokenizer.json", "w") as f:
        json.dump(spec, f)
    tload.register_hf_checkpoint(d, name="ts-bad")
    with pytest.raises(NotImplementedError, match="normalizer"):
        trt.TorchBackend(["xla:ts-bad"], device="cpu")


@pytest.fixture
def fp32_cache(monkeypatch):
    """The JAX encoder's working cache in the fp32 weights' dtype (its
    own is always bf16, tests/test_torch_embeddings.py)."""
    monkeypatch.setattr(jemb, "init_cache", functools.partial(
        jtr.init_cache, dtype=jnp.float32))


@pytest.mark.parametrize("name", ["llama-t", "gemma-t"])
def test_embedder_over_the_checkpoint_matches_jax(ckpts, fp32_cache, name):
    spec = f"xla:ts-{name}"
    je, te = _engine(JAX, spec), _engine(PORT, spec)
    jenc = jemb.EmbeddingEncoder(je.cfg, je.params, je.tokenizer)
    tenc = temb.EmbeddingEncoder(te.cfg, te.params, te.tokenizer)
    texts = ["wait for the reply", "orient: read the file café ½",
             "x " * 300, ""]
    for a, b in zip(jenc.embed(texts), tenc.embed(texts)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("name", ["llama-t", "gemma-t"])
def test_int8_over_the_loaded_weights_matches_jax(ckpts, name):
    spec = f"xla:ts-{name}"
    jcfg, tcfg = (m.get_model_config(spec) for m in (jconfig, tconfig))
    jp = jload.load_params(jcfg.checkpoint_path, jcfg, np.float32)
    jqp = jax.device_get(jq.quantize_params(
        jax.tree.map(jnp.asarray, jp), jcfg))
    tqp = tq.quantize_params(tload.load_params(
        tcfg.checkpoint_path, tcfg, device="cpu", dtype=torch.float32), tcfg)

    def eq(t, a) -> bool:
        return np.array_equal(t.numpy(), np.asarray(a))
    assert eq(tqp.embed.q8, jqp["embed"]["q8"])
    assert eq(tqp.embed.scale_r, jqp["embed"]["scale_r"])
    for li, layer in enumerate(tqp.layers):
        for key in tq.LAYER_WEIGHT_KEYS:
            leaf, lin = jqp["layers"][key], getattr(layer, key)
            assert eq(lin.q8, np.asarray(leaf["q8"][li]).T)
            assert eq(lin.scale, leaf["scale"][li])
    assert (tqp.lm_head is None) == ("lm_head" not in jqp)
    if tqp.lm_head is not None:
        assert eq(tqp.lm_head.q8, np.asarray(jqp["lm_head"]["q8"]).T)
    # and the int8 backend serves it
    b = trt.TorchBackend([spec], device="cpu", quantize_weights=True,
                         quantize_kv=True)
    r = b.query([trt.QueryRequest(spec, [{"role": "user", "content": "hi"}],
                                  temperature=0.0, max_tokens=6,
                                  session_id="q")])[0]
    assert r.ok, r.error
    b.close()


def test_bench_longctx_serves_the_checkpoint(ckpts):
    """tools/bench_longctx.py over a checkpoint, as the JAX tool builds
    its engine: the widened entry, the loaded weights, the checkpoint's
    tokenizer; the unified and gather paths' rounds equal a JAX engine's
    over the same checkpoint."""
    import dataclasses

    from quoracle_tpu.tools import bench_longctx as jbl
    from quoracle_tpu_torch.tools import bench_longctx as tbl
    resident, rounds, new = 300, 1, 6
    path = ckpts["llama-t"]
    teng, ttk = tbl.build_engine(resident, rounds, new, checkpoint=path,
                                 device="cpu", dtype=torch.float32,
                                 session_max_bytes=64 << 20)
    assert isinstance(ttk, ttok.HFAutoTokenizer)
    assert teng.cfg.checkpoint_path == path
    assert teng.cfg.context_window == teng.max_seq == tbl.session_max_seq(
        resident, rounds, new)
    want = tload.load_params(path, teng.cfg, device="cpu",
                             dtype=torch.float32)
    assert torch.equal(teng.params.layers[1].w_up.weight,
                       want.layers[1].w_up.weight)
    base = jload.register_hf_checkpoint(path, name="longctx-base")
    jcfg = dataclasses.replace(base, name="longctx",
                               context_window=teng.max_seq)
    jeng = jgen.GenerateEngine(
        jcfg, jax.tree.map(jnp.asarray, jload.load_params(
            path, jcfg, np.float32)),
        jtok.get_tokenizer("xla:longctx-base"), max_seq=teng.max_seq,
        prompt_buckets=(256, 1024, resident, teng.max_seq),
        session_max_bytes=64 << 20)
    calls: list = []
    orig = jeng.generate

    def spy(*a, **kw):           # the JAX harness returns no tokens
        res = orig(*a, **kw)
        calls.append([(list(r.token_ids), r.n_cached_tokens) for r in res])
        return res
    jeng.generate = spy
    paths = ("unified", "gather")
    got = tbl.measure_paths(teng, ttk, resident, rounds, new, paths=paths)
    jbl.measure_paths(jeng, jeng.tokenizer, resident, rounds, new,
                      paths=paths)
    n = rounds + 1
    for k, p in enumerate(paths):
        want = [c[0] for c in calls[-len(paths) * n:][k * n:(k + 1) * n]]
        assert got[p]["token_ids"] == [w[0] for w in want], p
        assert got[p]["reused_tokens"] == [w[1] for w in want], p
        assert min(got[p]["reused_tokens"]) >= resident
