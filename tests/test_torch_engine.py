"""The whole slice: the PyTorch port's GenerateEngine and TorchBackend
against the JAX package's, on the CPU.

The same fp32 weights (tests/_torch_parity.py) serve in a JAX
``GenerateEngine`` with the unified ragged path forced on and the radix
prefix cache off (the seam tests/test_ragged_attention.py uses) and in
the port's engine on ``device="cpu"``, unified forced on and the cache
off the same way (tests/test_torch_paged_kv.py covers the direct and
gather tiers, tests/test_torch_prefix_cache.py the sharing default). At temperature 0 the token ids
must be IDENTICAL: sessionless rows (dense path), sessioned round 1 and
the resumed round 2 (unified ragged path, equal cached-token counts),
grammar-constrained JSON rows, and a sliding-window model whose session
pages get trimmed between rounds. The logits agree to ~1e-5
(tests/test_torch_transformer.py), far inside the gaps argmax decides on.
"""

import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.models.embeddings import EmbeddingEncoder
from quoracle_tpu_torch.models.transformer import Transformer

# tier-1 runs several xdist workers on a few cores: torch's own thread
# pool would oversubscribe them and spin between the small ops here
torch.set_num_threads(1)

KW = dict(max_seq=256, prompt_buckets=(32, 64, 128))


def _engines(name):
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=7)
    spec = f"xla:{name}"
    je = jgen.GenerateEngine(jcfg, params, jtok.get_tokenizer(spec), **KW)
    je.unified_min_tokens = 0       # force the unified ragged path
    te = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer(spec),
                             device="cpu", **KW)
    te.unified_min_tokens = 0       # on the CPU, AUTO leaves unified off
    # these tests pin the unshared tiers (tests/test_torch_prefix_cache.py
    # holds both packages at their sharing default)
    je.prefix_sharing = te.prefix_sharing = False
    return je, te


@pytest.fixture(scope="module")
def tiny():
    return _engines("tiny")


def _prompts(tok, texts):
    return [tok.encode_chat([{"role": "user", "content": t}]) for t in texts]


def _same(jres, tres):
    assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
    assert [r.finish_reason for r in tres] == [r.finish_reason
                                               for r in jres]
    assert [r.n_cached_tokens for r in tres] == [r.n_cached_tokens
                                                 for r in jres]
    assert [r.json_state for r in tres] == [r.json_state for r in jres]


def test_sessionless_rows_identical(tiny):
    je, te = tiny
    prompts = _prompts(te.tokenizer, ["a short one", "x " * 40,
                                      "a medium prompt about plans"])
    kw = dict(temperature=0.0, max_new_tokens=[12, 20, 16])
    jres = je.generate(prompts, **kw)
    tres = te.generate(prompts, **kw)
    _same(jres, tres)
    assert all(r.n_gen_tokens > 0 for r in tres)
    assert te.kernel_launches() == {"flash_fwd": 0, "flash_bwd": 0,
                                    "ragged_fwd": 0,
                                    "ragged_q8_fwd": 0, "paged_fwd": 0,
                                    "paged_prefill_fwd": 0}


def test_sessioned_rounds_identical(tiny):
    """Round 1 prefills three fresh sessions through the unified tick;
    round 2 extends each conversation by its own response plus a new
    message and resumes from resident pages."""
    je, te = tiny
    sids = ["eng-a", "eng-b", "eng-c"]
    p1 = _prompts(te.tokenizer, ["pick a plan", "y " * 30, "orient first"])
    kw = dict(temperature=0.0, max_new_tokens=16, session_ids=sids)
    j1, t1 = je.generate(p1, **kw), te.generate(p1, **kw)
    _same(j1, t1)
    for sid in sids:
        assert te.session_tokens(sid) == je.session_tokens(sid)
    extra = te.tokenizer.encode("\n<|user|>\nrefine it\n<|assistant|>\n")
    p2 = [p + r.token_ids + extra for p, r in zip(p1, t1)]
    j2, t2 = je.generate(p2, **kw), te.generate(p2, **kw)
    _same(j2, t2)
    assert all(r.n_cached_tokens > 0 for r in t2)
    assert te.sessions.free_pages() == je.sessions.free_pages()
    for sid in sids:
        je.drop_session(sid)
        te.drop_session(sid)
    assert te.sessions.free_pages() == je.sessions.free_pages()


def test_constrained_json_rows_identical(tiny):
    """Grammar-masked rows, sessioned and sessionless, with a mixed-grammar
    batch (one row with an action enum): identical ids, final grammar
    states, and texts that are JSON object prefixes."""
    je, te = tiny
    prompts = _prompts(te.tokenizer, ["act", "decide now", "json please"])
    kw = dict(temperature=0.0, max_new_tokens=24,
              constrain_json=[True, True, False],
              action_enums=[None, ("orient", "wait"), None])
    _same(je.generate(prompts, **kw), te.generate(prompts, **kw))
    kw["session_ids"] = ["json-a", "json-b", None]
    jres, tres = je.generate(prompts, **kw), te.generate(prompts, **kw)
    _same(jres, tres)
    for r in tres[:2]:
        assert r.text.lstrip().startswith("{")


def test_sliding_window_sessions_trim_and_resume_identically():
    """tiny-window (window 16): round 1's session outgrows window + page,
    so its leading page is released and start_pos moves; round 2 resumes
    with a nonzero kv position offset."""
    je, te = _engines("tiny-window")
    p1 = _prompts(te.tokenizer, [" ".join(f"q{i}" for i in range(36))])
    kw = dict(temperature=0.0, max_new_tokens=24, session_ids=["win"])
    j1, t1 = je.generate(p1, **kw), te.generate(p1, **kw)
    _same(j1, t1)
    assert te.sessions.get("win").start_pos == je.sessions.get(
        "win").start_pos > 0
    p2 = [p1[0] + t1[0].token_ids + te.tokenizer.encode(" more")]
    _same(je.generate(p2, **kw), te.generate(p2, **kw))


def test_backend_query_texts_identical(tiny):
    """Chat messages through both backends: the consensus-shaped round
    (three sessioned, constrained rows at temperatures 1.0/0.7/0.0 become
    0.0 here for exactness) and the resumed round that splices the
    session's own ids."""
    je, te = tiny
    jb = jrt.TPUBackend(["xla:tiny"], engines={"xla:tiny": je})
    tb = trt.TorchBackend(["xla:tiny"], device="cpu",
                          engines={"xla:tiny": te})
    msgs = [{"role": "system", "content": "you are an agent"},
            {"role": "user", "content": "pick the next action"}]

    def round_(mod, backend, history):
        return backend.query([
            mod.QueryRequest("xla:tiny", history[i], temperature=0.0,
                             max_tokens=20, session_id=f"be-{i}",
                             constrain_json=True)
            for i in range(3)])

    hist = [list(msgs) for _ in range(3)]
    jr, tr = round_(jrt, jb, hist), round_(trt, tb, hist)
    assert [r.text for r in tr] == [r.text for r in jr]
    assert all(r.ok for r in tr)
    hist = [h + [{"role": "assistant", "content": r.text},
                 {"role": "user", "content": "refine"}]
            for h, r in zip(hist, tr)]
    jr, tr = round_(jrt, jb, hist), round_(trt, tb, hist)
    assert [r.text for r in tr] == [r.text for r in jr]
    assert [r.cached_tokens for r in tr] == [r.cached_tokens for r in jr]
    assert all(r.cached_tokens > 0 for r in tr)
    assert tb.count_tokens("xla:tiny", "hello") == jb.count_tokens(
        "xla:tiny", "hello")
    for i in range(3):
        tb.drop_session(f"be-{i}")
        jb.drop_session(f"be-{i}")


def test_entry_points_default_to_the_gpu_and_raise_without_one():
    """No device means the card; with no card the port refuses instead of
    quietly serving on the CPU. The embedder (``TorchBackend.embed``,
    ``EmbeddingEncoder``) runs where its weights live, never elsewhere."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.TorchBackend(["xla:tiny"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.TorchBackend(["xla:tiny"], embed_model="xla:tiny-gemma")
    _, tcfg = both_configs("tiny")
    _, model = shared_params("tiny")
    tok = ttok.get_tokenizer("xla:tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.GenerateEngine(tcfg, model, tok)
    eng = tgen.GenerateEngine(tcfg, model, tok, device="cpu")
    b = trt.TorchBackend(["xla:tiny"], device="cpu",
                         engines={"xla:tiny": eng})
    assert b.embedder.device == torch.device("cpu")
    assert b.embed(["hello"])[0].shape == (tcfg.dim,)
    # weights on another device: the encoder computes there, and reading
    # a result back off the meta device fails rather than falling back
    meta = Transformer.empty(tcfg, "meta", torch.float32)
    enc = EmbeddingEncoder(tcfg, meta, tok)
    assert enc.device == torch.device("meta")
    with pytest.raises(NotImplementedError):
        enc.embed(["hello"])
