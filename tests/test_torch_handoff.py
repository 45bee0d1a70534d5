"""The port's KV handoff (serving/handoff.py) and its int8 tier moves
against the JAX package's, on the CPU.

Each case runs on both packages over the same fp32 tiny weights
(tests/_torch_parity.py) and returns what it observed; the two lists must
be equal:

  * a session prefilled by one engine, exported, adopted by a second
    engine and continued there gives the tokens and cached count of the
    first engine continuing itself (greedy and grammar-constrained, on
    the gather and the unified tiers);
  * engines of another pool dtype (fp32 against bf16, int8 against float)
    reject the envelope with ``reason == "signature"`` before any bytes
    reach the destination tier (tests/test_cluster.py,
    tests/test_quant.py);
  * int8 pools: a hibernated session's pages AND scale blocks restore
    bit-identical, and the resumed round gives the never-evicted
    control's tokens; int8 prefix blocks persist to disk and warm a new
    engine; a flipped scale byte is rejected by the crc and unlinked;
  * the ledger: ``inflight``, ``note_replaced``, ``forget``, ``stats``.
"""

import copy
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_configs
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.serving import handoff as jho
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.serving import handoff as tho
from test_torch_kvtier import (
    ENUM, JAX, KW, SYS, _kv, _weights, both, enc, entry_arrays, gen,
    hibernate_all, make_engine, pool_pages, row, state,
)

torch.set_num_threads(1)

MEMBER = "xla:tiny"


def _ho(side):
    return jho if side is JAX else tho


def _case_handoff_continues(side, tier, constrained):
    """Prefill one token on A, hand the session to B, continue on B: the
    tokens of A continuing itself."""
    kw = (dict(constrain_json=[True], action_enums=[ENUM]) if constrained
          else {})
    p1 = enc(SYS + (" respond with an action json." if constrained
                    else " task: count to five."))
    ctl = make_engine(side, tier)
    c1 = gen(ctl, p1, "h", 1, **kw)
    js = c1.json_state if constrained else None
    p2 = p1 + c1.token_ids
    ckw = dict(kw, initial_json_state=[js]) if constrained else {}
    c2 = gen(ctl, p2, "h", 24, **ckw)
    a = make_engine(side, tier)
    b = make_engine(side, tier)
    a.attach_tier(host_mb=64)
    tb = b.attach_tier(host_mb=64)
    a1 = gen(a, p1, "h", 1, **kw)
    assert a1.token_ids == c1.token_ids
    ho = _ho(side).KVHandoff()
    env = ho.export(a, "h", MEMBER, src_replica="a", json_state=js)
    assert env.signature == a.kv_signature() == b.kv_signature()
    # the sampled token has not run through the forward yet: the
    # session holds the prompt's KV
    assert env.n_tokens == len(p1)
    assert env.trace is None and env.tree is None
    # exported out of A: gone from its pool and its host tier
    assert a.sessions.get("h") is None and not a.sessions.tier.has_session(
        "h")
    exported = entry_arrays(env.entry)
    ho.adopt(b, env, dst_replica="b")
    assert b.sessions.get("h") is not None       # prefetched on adopt
    assert tb.restored_sessions == 1
    for got, want in zip(pool_pages(b, b.sessions.get("h").pages),
                         exported):
        assert np.array_equal(got, want)
    b2 = gen(b, p2, "h", 24, **ckw)
    assert b2.token_ids == c2.token_ids
    assert b2.n_cached_tokens == c2.n_cached_tokens > 0
    assert ho.inflight(MEMBER, "h") is env
    obs = [row(c2), row(b2), ho.stats(), state(a), state(b)]
    ho.forget(MEMBER, "h")
    return obs + [ho.stats()]


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["greedy", "constrained"])
@pytest.mark.parametrize("tier", ["gather", "unified"])
def test_handoff_continuation_matches_self_continuation(tier, constrained):
    obs = both(_case_handoff_continues, tier, constrained)
    assert obs[2] == {"exports": 1, "adopts": 1, "rejects": 0,
                      "replaced": 0, "inflight": 1}
    assert obs[-1]["inflight"] == 0


def _case_signature_rejected(side, src_kw, dst_kw):
    src = make_engine(side, "unified", **src_kw)
    dst = make_engine(side, "unified", **dst_kw)
    src.attach_tier(host_mb=64)
    dst.attach_tier(host_mb=64)
    assert src.kv_signature() != dst.kv_signature()
    gen(src, enc(SYS + " task: say hi."), "h", 4)
    ho = _ho(side).KVHandoff()
    env = ho.export(src, "h", MEMBER)
    with pytest.raises(_ho(side).HandoffError) as ei:
        ho.adopt(dst, env)
    assert ei.value.reason == "signature"
    # no byte landed: the destination tier and pool hold nothing
    assert not dst.sessions.tier.has_session("h")
    assert dst.sessions.get("h") is None
    return [src.kv_signature(), dst.kv_signature(), ho.stats(),
            state(dst)]


def _bf16(side):
    """A tiered engine over the fp32 weights cast to bf16 (a copy: the
    shared fp32 weights stay as they are)."""
    jcfg, tcfg = both_configs("tiny")
    params, model = _weights()
    if side is JAX:
        eng = jgen.GenerateEngine(
            jcfg, jax.tree.map(lambda x: x.astype(jnp.bfloat16), params),
            jtok.ByteTokenizer(), **KW)
    else:
        eng = tgen.GenerateEngine(
            tcfg, copy.deepcopy(model).to(torch.bfloat16),
            ttok.ByteTokenizer(), device="cpu", **KW)
    eng.attach_tier(host_mb=64)
    return eng


def _case_fp32_bf16_rejected(side):
    src = make_engine(side)
    src.attach_tier(host_mb=64)
    dst = _bf16(side)
    gen(src, enc("signature test prompt"), "h1", 1)
    ho = _ho(side).KVHandoff()
    env = ho.export(src, "h1", MEMBER)
    with pytest.raises(_ho(side).HandoffError) as ei:
        ho.adopt(dst, env)
    assert ei.value.reason == "signature"
    assert not dst.sessions.tier.has_session("h1")
    return [src.kv_signature(), dst.kv_signature(), ho.stats()]


def test_signature_mismatch_rejected_before_bytes_land():
    obs = both(_case_fp32_bf16_rejected)
    assert obs[0].endswith("-float32") and obs[1].endswith("-bfloat16")
    assert obs[2]["rejects"] == 1 and obs[2]["adopts"] == 0


@pytest.mark.parametrize("src_q", [True, False],
                         ids=["int8_to_float", "float_to_int8"])
def test_quantized_and_unquantized_peers_reject_handoff(src_q):
    q = dict(quantize_weights=True, quantize_kv=True)
    obs = both(_case_signature_rejected, q if src_q else {},
               {} if src_q else q)
    int8_sig = obs[0] if src_q else obs[1]
    assert int8_sig.endswith("-int8-q8kv")
    assert obs[2] == {"exports": 1, "adopts": 0, "rejects": 1,
                      "replaced": 0, "inflight": 1}


def _case_export_errors(side):
    untiered = make_engine(side)
    ho = _ho(side).KVHandoff()
    reasons = []
    with pytest.raises(_ho(side).HandoffError) as ei:
        ho.export(untiered, "nobody", MEMBER)
    reasons.append(ei.value.reason)
    tiered = make_engine(side)
    tiered.attach_tier(host_mb=64)
    with pytest.raises(_ho(side).HandoffError) as ei:
        ho.export(tiered, "nobody", MEMBER)
    reasons.append(ei.value.reason)
    # a session already hibernated is handed over as it is
    gen(tiered, enc(SYS + " parked"), "p", 4)
    hibernate_all(tiered)
    env = ho.export(tiered, "p", MEMBER)
    assert not tiered.sessions.tier.has_session("p")
    return reasons + [env.n_tokens, ho.stats()]


def test_export_errors_and_hibernated_export():
    obs = both(_case_export_errors)
    assert obs[:2] == ["no_tier", "export_failed"]


def _case_ledger(side):
    ho = _ho(side).KVHandoff()
    env = _ho(side).HandoffEnvelope(
        session_id="s", model_spec=MEMBER, signature="sig",
        entry=type("E", (), {"tokens": [1, 2, 3]})())
    with ho._lock:
        ho._inflight[ho._key(MEMBER, "s")] = env
    out = [ho.inflight(MEMBER, "s") is env, ho.inflight(MEMBER, "t"),
           env.n_tokens]
    ho.note_replaced(MEMBER)
    out.append(ho.stats())
    ho.forget(MEMBER, "s")
    ho.forget(MEMBER, "never-there")
    return out + [ho.inflight(MEMBER, "s"), ho.stats()]


def test_ledger_inflight_forget_stats():
    obs = both(_case_ledger)
    assert obs[0] is True and obs[1] is None and obs[2] == 3
    assert obs[3]["replaced"] == 1 and obs[3]["inflight"] == 1
    assert obs[-1]["inflight"] == 0


# ---------------------------------------------------------------------------
# Int8 pools through the tiers
# ---------------------------------------------------------------------------

Q8 = dict(quantize_weights=True, quantize_kv=True)


def _case_int8_hibernate_restore(side):
    tok_suffix = enc(" continue")[1:]
    p1 = enc(SYS + " task: count to five.")
    ctl = make_engine(side, "unified", **Q8)
    a1 = gen(ctl, p1, "s", 24)
    p2 = p1 + a1.token_ids + tok_suffix
    a2 = gen(ctl, p2, "s", 24)
    eng = make_engine(side, "unified", **Q8)
    t = eng.attach_tier(host_mb=64)
    b1 = gen(eng, p1, "s", 24)
    assert b1.token_ids == a1.token_ids
    demoted_from = pool_pages(eng, [p for p in eng.sessions.get("s").pages
                                    if p])
    hibernate_all(eng)
    entry = t.host.sessions["s"]
    assert entry.k_scale is not None and entry.v_scale is not None
    assert str(entry.k.dtype).endswith("int8")
    arrays = entry_arrays(entry)
    assert len(arrays) == 4
    # payload pages and scale blocks restore bit-identical
    assert eng.prefetch_session("s") is True
    restored = pool_pages(eng, [p for p in eng.sessions.get("s").pages
                                if p])
    for a, b, c in zip(demoted_from, arrays, restored):
        assert np.array_equal(a, b) and np.array_equal(b, c)
    b2 = gen(eng, p2, "s", 24)
    assert b2.token_ids == a2.token_ids
    assert b2.n_cached_tokens == a2.n_cached_tokens > 0
    return [row(a1), row(a2), row(b2), entry.nbytes, state(eng)]


def test_int8_hibernate_restore_pages_and_scales_bit_equal():
    both(_case_int8_hibernate_restore)


def _case_int8_disk_warm_start(side, root):
    d = str(root / side.name)
    p1 = enc(SYS + " task one")
    e1 = make_engine(side, "unified", **Q8)
    t1 = e1.attach_tier(host_mb=64, disk_dir=d)
    r1 = gen(e1, p1, "a")
    t1.flush_spills()
    files = sorted(os.listdir(t1.disk.dir))
    assert files and t1.disk.dir.endswith("-int8-q8kv")
    with np.load(os.path.join(t1.disk.dir, files[0])) as z:
        assert "k_scale" in z.files and str(z["dtype"]) == "int8"
    e2 = make_engine(side, "unified", **Q8)
    t2 = e2.attach_tier(host_mb=64, disk_dir=d)
    r2 = gen(e2, p1, "b")
    t2.flush_spills()
    assert r2.token_ids == r1.token_ids
    assert t2.restored_prefix_pages == len(files)
    assert r2.n_cached_tokens >= e2.sessions.page
    # the restored block's page and scales are the file's bytes
    blk = t2.disk.load(files[0][:-len(".npz")],
                       [int(t) for t in p1[:e2.sessions.page]])
    page = e2.sessions.prefix_cache.match(p1, len(p1))[0][0]
    for got, want in zip(pool_pages(e2, [page]),
                         [x[:, None] for x in blk]):
        assert np.array_equal(got, np.asarray(
            want.numpy() if torch.is_tensor(want) else want))
    return [files, row(r1), row(r2), state(e2)]


def test_int8_disk_warm_start_restores_scales(tmp_path):
    both(_case_int8_disk_warm_start, tmp_path)


def _case_disk_rejects_flipped_scale(side, root):
    s = side.kv.DiskPrefixStore(str(root / side.name), "sig-q8", model="m")
    toks = list(range(128))
    k = np.ones((2, 128, 2, 16), np.int8)
    ks = np.full((2, 2, 128), 0.5, np.float32)
    key = s.block_key(toks)
    assert s.save(key, toks, *[_kv(side, a) for a in (k, k, ks, ks)])
    path = s._path(key)
    with zipfile.ZipFile(path) as zf:
        off = zf.getinfo("v_scale.npy").header_offset + 256
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    assert s.load(key, toks) is None
    assert not os.path.exists(path)
    return [s.corrupt, s.stats()["entries"]]


def test_disk_rejects_flipped_scale_bytes(tmp_path):
    assert both(_case_disk_rejects_flipped_scale, tmp_path) == [1, 0]

