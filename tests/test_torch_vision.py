"""The port's VLM path (quoracle_tpu_torch/models/vision.py, the engine's
``generate(images=)``, the backend's multimodal rows) against the JAX
package's, on the CPU in fp32: the cases of tests/test_vision.py run on
both packages over the same weights, carried across by
``params_from_jax`` / ``vision_params_from_jax``.

Tolerances: the tower's soft tokens within 1e-5 (fp32 sums in another
order); the splice exact (a gather); engine and backend texts, token ids,
cached tokens and errors identical at temperature 0."""

import base64
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_configs
from quoracle_tpu.context import history as jhist
from quoracle_tpu.context import message_builder as jmb
from quoracle_tpu.context import token_manager as jtm
from quoracle_tpu.models import embeddings as jemb
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.models import vision as jvis
from quoracle_tpu.models.images import write_png
from quoracle_tpu.models.transformer import init_params as jax_init_params
from quoracle_tpu_torch.context import history as thist
from quoracle_tpu_torch.context import message_builder as tmb
from quoracle_tpu_torch.context import token_manager as ttm
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.models import vision as tvis
from quoracle_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

VLM = "tiny-vlm"
SPEC = "xla:" + VLM
# the tower geometries held against the JAX tower: tiny-vlm's, the JAX
# test's, and a wider cut (dim 64, 2 layers, 16 patches)
TOWERS = {
    "tiny-vlm": dict(image_size=28, patch_size=14, dim=32, n_layers=1,
                     n_heads=2, ffn_dim=64, out_dim=64),
    "jax-test": dict(image_size=28, patch_size=14, dim=32, n_layers=2,
                     n_heads=2, ffn_dim=64, out_dim=48),
    "wide": dict(image_size=56, patch_size=14, dim=64, n_layers=2,
                 n_heads=4, ffn_dim=256, out_dim=64),
}


def img(seed: float, size: int = 28) -> np.ndarray:
    """tests/test_vision.py's smooth test image."""
    x = np.linspace(-1, 1, size, dtype=np.float32)
    grid = np.stack(np.meshgrid(x, x), -1).sum(-1)
    return np.stack([np.sin(grid * 3 + seed), np.cos(grid * 2 - seed),
                     grid * 0 + np.tanh(seed)], axis=-1).astype(np.float32)


def _redraw_norms(vtree: dict, rng) -> dict:
    """The tower's LayerNorm weights start at 1; redraw them so a swapped
    leaf cannot hide."""
    layers = dict(vtree["layers"])
    for leaf in ("ln1", "ln2"):
        layers[leaf] = (1.0 + 0.1 * rng.standard_normal(
            layers[leaf].shape)).astype(np.float32)
    return dict(vtree, layers=layers, final_ln=(
        1.0 + 0.1 * rng.standard_normal(vtree["final_ln"].shape))
        .astype(np.float32))


def tower_pair(name: str, seed: int = 1):
    kw = TOWERS[name]
    jc, tc = jvis.VisionConfig(**kw), tvis.VisionConfig(**kw)
    tree = jax.device_get(jvis.init_vision_params(
        jc, jax.random.PRNGKey(seed), dtype=jnp.float32))
    tree = _redraw_norms(tree, np.random.default_rng(seed))
    return (jc, jax.tree.map(jnp.asarray, tree), tc,
            tvis.vision_params_from_jax(tree, tc))


def vlm_params(seed: int = 0):
    """fp32 tiny-vlm weights for both packages (the tower's norms
    redrawn)."""
    jcfg, tcfg = both_configs(VLM)
    tree = jax.device_get(jax_init_params(jcfg, jax.random.PRNGKey(seed),
                                          dtype=jnp.float32))
    tree = dict(tree, vision=_redraw_norms(tree["vision"],
                                           np.random.default_rng(seed)))
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg))


def engines(seed: int = 0, **kw):
    """tests/test_vision.py's engine on both packages over one set of
    weights (byte tokenizer, max_seq 256, buckets 32/64/128), on the
    unified tier."""
    jcfg, jp, tcfg, tp = vlm_params(seed)
    kw = dict(dict(max_seq=256, prompt_buckets=(32, 64, 128)), **kw)
    je = jgen.GenerateEngine(jcfg, jp, jtok.ByteTokenizer(), **kw)
    te = tgen.GenerateEngine(tcfg, tp, ttok.ByteTokenizer(), device="cpu",
                             **kw)
    je.unified_min_tokens = te.unified_min_tokens = 0
    return je, te


def vlm_prompt(tok, cfg, text="describe the image: "):
    return (tok.encode(text, add_bos=True)
            + [cfg.image_token_id] * cfg.vision.n_patches
            + tok.encode(" answer:"))


def view(results) -> list:
    return [(r.token_ids, r.text, r.n_prompt_tokens, r.n_cached_tokens,
             r.finish_reason) for r in results]


# ---------------------------------------------------------------------------
# Tower units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TOWERS))
def test_vision_encode_shapes_and_determinism(name):
    jc, jp, tc, tp = tower_pair(name)
    pixels = np.stack([img(0.1, jc.image_size), img(0.9, jc.image_size)])
    want = np.asarray(jvis.vision_encode(jp, jc, jnp.asarray(pixels)))
    got = tvis.vision_encode(tp, tc, torch.from_numpy(pixels))
    assert got.shape == (2, tc.n_patches, tc.out_dim) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    again = tvis.vision_encode(tp, tc, torch.from_numpy(pixels))
    assert torch.equal(got, again)
    # different images produce different patch embeddings
    assert not torch.allclose(got[0], got[1])
    # the patch order is the JAX package's
    np.testing.assert_array_equal(
        tvis.patchify(torch.from_numpy(pixels), tc.patch_size).numpy(),
        np.asarray(jvis.patchify(jnp.asarray(pixels), jc.patch_size)))


@pytest.mark.parametrize("tokens,P", [
    ([[7, 3, 3, 3, 9, 9]], 3),                 # the JAX test's row
    ([[3, 3, 3, 3, 3, 9], [9, 9, 9, 9, 9, 9]], 3),   # past P; a text row
    ([[9, 3, 9, 3, 9, 3], [3, 9, 9, 9, 9, 3]], 4),
], ids=["jax-case", "clamp", "scattered"])
def test_splice_replaces_only_placeholders(tokens, P):
    tokens = np.asarray(tokens, np.int32)
    B, T = tokens.shape
    D = 4
    embeds = np.random.default_rng(0).standard_normal(
        (B, T, D)).astype(np.float32)
    patches = (np.arange(B * P * D, dtype=np.float32).reshape(B, P, D)
               + 1)
    want = np.asarray(jvis.splice_image_embeds(
        jnp.asarray(embeds), jnp.asarray(tokens), jnp.asarray(patches), 3))
    got = tvis.splice_image_embeds(
        torch.from_numpy(embeds), torch.from_numpy(tokens),
        torch.from_numpy(patches), 3).numpy()
    np.testing.assert_array_equal(got, want)
    if tokens[0].tolist() == [7, 3, 3, 3, 9, 9]:
        np.testing.assert_array_equal(got[0, 0], embeds[0, 0])
        np.testing.assert_array_equal(got[0, 3], patches[0, 2])


# ---------------------------------------------------------------------------
# Engine path
# ---------------------------------------------------------------------------

def test_engine_generates_conditioned_on_image():
    je, te = engines()
    prompt = vlm_prompt(te.tokenizer, te.cfg)
    got = []
    for eng in (je, te):
        got.append([eng.generate([prompt], temperature=0.0,
                                 max_new_tokens=12, images=[im])[0]
                    for im in (img(0.2), img(0.2), img(2.5))])
    assert view(got[1]) == view(got[0])
    a, b, c = got[1]
    assert a.token_ids == b.token_ids          # deterministic
    assert a.token_ids != c.token_ids          # the image conditions output
    assert a.n_prompt_tokens == len(prompt)    # patches count as prompt


def test_mixed_batch_text_rows_unaffected_by_image_rows():
    je, te = engines()
    tok = te.tokenizer
    text_prompt = tok.encode("plain text row", add_bos=True)
    vp = vlm_prompt(tok, te.cfg)
    got = []
    for eng in (je, te):
        alone = eng.generate([text_prompt], temperature=0.0,
                             max_new_tokens=8)[0]
        mixed = eng.generate([vp, text_prompt], temperature=0.0,
                             max_new_tokens=8, images=[img(0.4), None])
        got.append((alone, mixed))
    assert view([got[1][0], *got[1][1]]) == view([got[0][0], *got[0][1]])
    assert got[1][1][1].token_ids == got[1][0].token_ids


def test_text_only_model_rejects_images():
    jcfg, tcfg = both_configs("tiny")
    je = jgen.GenerateEngine(
        jcfg, jax_init_params(jcfg, jax.random.PRNGKey(0),
                              dtype=jnp.float32),
        jtok.ByteTokenizer(), max_seq=256, prompt_buckets=(32,))
    gen = torch.Generator().manual_seed(0)
    from quoracle_tpu_torch.models.transformer import init_params
    te = tgen.GenerateEngine(tcfg, init_params(tcfg, gen, dtype=torch.float32),
                             ttok.ByteTokenizer(), max_seq=256,
                             prompt_buckets=(32,), device="cpu")
    errs = []
    for eng in (je, te):
        with pytest.raises(ValueError, match="no vision tower") as e:
            eng.generate([[1, 2, 3]], images=[img(0.1)])
        errs.append(str(e.value))
    assert errs[1] == errs[0]


def test_mixed_sessioned_text_and_image_rows_split():
    """A batch mixing a sessioned text row with an image row keeps the
    text row's KV residency (the engine splits the batch internally)."""
    je, te = engines()
    tok = te.tokenizer
    text_p = tok.encode("a sessioned conversation " * 4, add_bos=True)
    got = []
    for eng in (je, te):
        r1 = eng.generate([text_p], temperature=0.0, max_new_tokens=6,
                          session_ids=["t"])[0]
        text_p2 = text_p + r1.token_ids + tok.encode(" more")
        res = eng.generate([vlm_prompt(tok, eng.cfg), text_p2],
                           temperature=0.0, max_new_tokens=6,
                           session_ids=[None, "t"],
                           images=[img(0.3), None])
        got.append(([r1, *res], eng.session_tokens("t"),
                    len(eng.sessions)))
    assert view(got[1][0]) == view(got[0][0])
    assert got[1][1:] == got[0][1:]
    r1, img_row, txt_row = got[1][0]
    assert txt_row.n_cached_tokens > 0         # resumed despite the image
    assert img_row.n_gen_tokens > 0 and got[1][2] == 1   # stored nothing


def test_vision_engines_never_share_prefixes():
    """Two new sessions over one long page-aligned prompt: a text model
    would adopt the first's pages (radix cache); a vision model never
    does, in either package (the wave split and the insert are off)."""
    je, te = engines(max_seq=512, prompt_buckets=(128, 256, 384))
    prompt = te.tokenizer.encode("shared system prompt " * 16,
                                 add_bos=True)
    got = []
    for eng in (je, te):
        res = eng.generate([prompt, prompt + [70]], temperature=0.0,
                           max_new_tokens=4, session_ids=["a", "b"])
        again = eng.generate([prompt + [71]], temperature=0.0,
                             max_new_tokens=4, session_ids=["c"])
        got.append(view(res + again))
    assert got[1] == got[0]
    assert all(row[3] == 0 for row in got[1])


def test_drop_session_drops_image_keyed_variants():
    je, te = engines()
    tok = te.tokenizer
    p = tok.encode("conversation", add_bos=True)
    got = []
    for eng in (je, te):
        eng.generate([p, p, p], temperature=0.0, max_new_tokens=2,
                     session_ids=["a", "a|img:12ab", "b|img:12ab"])
        eng.drop_session("a")
        got.append(sorted(eng.sessions._sessions))
    assert got[1] == got[0] == ["b|img:12ab"]


def test_image_sessions_drop_the_image_in_the_reference_and_refuse_here():
    """``image_sessions=True`` with a session sends the JAX engine's rows
    down its paged tiers, which never run the tower: two different images
    give the same tokens (the image is dropped). The port refuses."""
    je, te = engines()
    prompt = vlm_prompt(te.tokenizer, te.cfg)
    outs = [je.generate([prompt], temperature=0.0, max_new_tokens=8,
                        session_ids=[f"s{k}"], images=[im],
                        image_sessions=True)[0].token_ids
            for k, im in enumerate((img(0.2), img(2.5)))]
    assert outs[0] == outs[1]
    conditioned = je.generate([prompt], temperature=0.0, max_new_tokens=8,
                              images=[img(2.5)])[0].token_ids
    assert conditioned != outs[1]
    with pytest.raises(ValueError, match="image_sessions=True"):
        te.generate([prompt], temperature=0.0, max_new_tokens=8,
                    session_ids=["s0"], images=[img(0.2)],
                    image_sessions=True)
    # without a session the flag changes nothing: the dense VLM prefill
    got = te.generate([prompt], temperature=0.0, max_new_tokens=8,
                      images=[img(2.5)], image_sessions=True)[0].token_ids
    assert got == conditioned


# ---------------------------------------------------------------------------
# Backend multimodal message path
# ---------------------------------------------------------------------------

def _png_b64(tmp_path, seed=5) -> str:
    rng = np.random.default_rng(seed)
    w = h = 32
    pixels = rng.integers(0, 255, (h * w * 3,), dtype=np.uint8).tobytes()
    path = str(tmp_path / f"img{seed}.png")
    write_png(path, pixels, w, h)
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


def backends(**kw):
    """Both backends over tiny-vlm's shared weights (the pool's
    tokenizer, the default max_seq), the unified tier."""
    jcfg, jp, tcfg, tp = vlm_params(3)
    je = jgen.GenerateEngine(jcfg, jp, jtok.get_tokenizer(SPEC))
    te = tgen.GenerateEngine(tcfg, tp, ttok.get_tokenizer(SPEC),
                             device="cpu")
    je.unified_min_tokens = te.unified_min_tokens = 0
    jb = jrt.TPUBackend([SPEC], engines={SPEC: je},
                        embedder=jemb.EmbeddingEncoder(jcfg, jp,
                                                       je.tokenizer), **kw)
    tb = trt.TorchBackend([SPEC], device="cpu", engines={SPEC: te}, **kw)
    return jb, tb


def result_view(r) -> tuple:
    return (r.ok, r.text, r.error, r.usage.prompt_tokens if r.ok else None,
            r.usage.completion_tokens if r.ok else None, r.cached_tokens)


def _multimodal(b64, text="what is shown here?", **req):
    msgs = [{"role": "user", "content": [
        {"type": "text", "text": text},
        {"type": "image_base64", "data": b64}]}]
    return trt.QueryRequest(model_spec=SPEC, messages=msgs,
                            temperature=0.0, max_tokens=8, **req)


def _query_both(jb, tb, reqs) -> list:
    out = []
    for b, mod in ((jb, jrt), (tb, trt)):
        out.append([result_view(r) for r in b.query([
            mod.QueryRequest(**vars(q)) for q in reqs])])
    assert out[1] == out[0]
    return out[1]


def test_backend_serves_multimodal_messages(tmp_path):
    jb, tb = backends()
    try:
        (r,) = _query_both(jb, tb, [_multimodal(_png_b64(tmp_path))])
        (r2,) = _query_both(jb, tb, [_multimodal(_png_b64(tmp_path, 11))])
    finally:
        jb.close()
        tb.close()
    vc = tb.engines[SPEC].cfg.vision
    assert r[0], r[2]
    assert r[3] > vc.n_patches         # one placeholder per patch
    assert r2[0] and r2[1] != r[1]     # a different image, other text


def test_backend_degrades_bad_image_to_text(tmp_path, caplog):
    """A part that does not decode is the text "[image]", with a warning;
    a second image part is "[image]" too; a session id rides the text
    rows only (image rows run sessionless)."""
    jb, tb = backends()
    bad = base64.b64encode(b"not a png").decode()
    good = _png_b64(tmp_path)
    two = [{"role": "user", "content": [
        {"type": "text", "text": "look:"},
        {"type": "image_base64", "data": good},
        {"type": "image", "data": _png_b64(tmp_path, 7)}]}]
    try:
        with caplog.at_level(logging.WARNING):
            rows = _query_both(jb, tb, [
                _multimodal(bad, "look:", session_id="agent-1"),
                trt.QueryRequest(model_spec=SPEC, messages=two,
                                 temperature=0.0, max_tokens=6)])
    finally:
        jb.close()
        tb.close()
    assert rows[0][0] and rows[1][0], rows
    warned = [r for r in caplog.records
              if r.name == "quoracle_tpu_torch.models.runtime"
              and "could not be decoded" in r.getMessage()]
    assert len(warned) == 1


def test_continuous_backend_serves_image_rows(tmp_path):
    """Under ``continuous`` an image row takes a direct engine call beside
    the loop's text rows."""
    jb, tb = backends(continuous=True)
    text = trt.QueryRequest(model_spec=SPEC, messages=[
        {"role": "user", "content": "a text row"}], temperature=0.0,
        max_tokens=8, session_id="agent-2", constrain_json=True)
    try:
        rows = _query_both(jb, tb, [_multimodal(_png_b64(tmp_path)), text])
    finally:
        jb.close()
        tb.close()
    assert all(r[0] for r in rows), rows


# ---------------------------------------------------------------------------
# ImageDetector parity: image payloads in action results flow through the
# history -> messages pipeline as multimodal parts
# ---------------------------------------------------------------------------

def test_result_images_become_message_parts():
    got = []
    for hist, mb in ((jhist, jmb), (thist, tmb)):
        ctx = hist.AgentContext()
        ctx.append("m", hist.HistoryEntry(kind=hist.USER,
                                          content="fetch the chart"))
        ctx.append("m", hist.HistoryEntry(
            kind=hist.RESULT, action_type="fetch_web",
            content={"action": "fetch_web", "result": {
                "status": "ok", "content_type": "image/png",
                "image_base64": "QUJD"}}))
        got.append(mb.build_messages_for_model(ctx, "m",
                                               system_prompt="sys"))
    assert got[1] == got[0]
    last = got[1][-1]
    assert [p["type"] for p in last["content"]] == ["text", "image_base64"]
    assert last["content"][1]["data"] == "QUJD"
    assert "QUJD" not in last["content"][0]["text"]
    assert "[attached image #1]" in last["content"][0]["text"]


def test_injections_append_to_multimodal_messages():
    """TODO/budget/token-count injections compose with parts content."""
    got = []
    for hist, mb, tm in ((jhist, jmb, jtm), (thist, tmb, ttm)):
        ctx = hist.AgentContext()
        ctx.append("m", hist.HistoryEntry(
            kind=hist.RESULT, action_type="fetch_web",
            content={"result": {"image_base64": "QUJD"}}))
        ctx.todos = [{"task": "t", "done": False}]
        mgr = tm.TokenManager(lambda spec, text: max(1, len(text) // 4),
                              context_limit_fn=lambda spec: 1000)
        got.append(mb.build_messages_for_model(ctx, "m", token_manager=mgr))
    assert got[1] == got[0]
    content = got[1][-1]["content"]
    flat = "\n".join(p.get("text", "") for p in content
                     if p.get("type") == "text")
    assert "[CURRENT TODO LIST]" in flat and "[CONTEXT:" in flat
    assert any(p.get("type") == "image_base64" for p in content)
