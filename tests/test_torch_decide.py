"""The gate of the port's consensus slice: a whole decide, on the CPU.

Pool ``["xla:tiny", "xla:tiny-gemma"]``, one session key, allowed actions
``{"wait"}`` (the grammar forces the action name; ``wait``'s ``reason``
is a semantic rule), two refinement rounds at most, then the agent's next
step on the same session (history, the member's answer and a result
message), which must resume resident KV. Three runs over the same fp32
weights (tests/_torch_parity.py):

  (a) the JAX ``ConsensusEngine`` over the JAX ``TPUBackend``;
  (b) the same JAX engine over the port's ``TorchBackend(device="cpu")``;
  (c) the port's ``ConsensusEngine`` over the port's ``TorchBackend``.

Both packages' engines are forced onto the unified ragged tier, and
these decides run without the radix prefix cache on either side; one
more test runs two agents' decides with sharing at its default. A decide never samples at temperature 0 by itself
(consensus/temperature.py descends from 1.0 to 0.2), so the runs are made
greedy by pointing both engine modules' ``temperature_for_round`` at 0.0.
The three must agree on status, decision, rounds, cached tokens, every
member's texts, the failures and the audit record
(tests/test_torch_consensus.py ``outcome_view``). One more decide,
sampled on the default schedule, runs on the port alone.
"""

import functools
import json

import jax.numpy as jnp
import pytest
import torch

from _torch_parity import both_configs, shared_params
from test_torch_consensus import outcome_view
from quoracle_tpu.consensus import engine as jce
from quoracle_tpu.models import embeddings as jemb
from quoracle_tpu.models import generate as jgen
from quoracle_tpu.models import runtime as jrt
from quoracle_tpu.models import tokenizer as jtok
from quoracle_tpu.models import transformer as jtr
from quoracle_tpu_torch.consensus import engine as tce
from quoracle_tpu_torch.consensus.parser import ActionProposal, parse_response
from quoracle_tpu_torch.models import generate as tgen
from quoracle_tpu_torch.models import runtime as trt
from quoracle_tpu_torch.models import tokenizer as ttok
from quoracle_tpu_torch.tools import json_closure

torch.set_num_threads(1)

POOL = ["xla:tiny", "xla:tiny-gemma"]
SESSION = "agent-decide"
SYSTEM = ("You are one agent of a consensus pool. Respond with a single "
          "JSON action object.")
MESSAGES = [{"role": "system", "content": SYSTEM},
            {"role": "user", "content": "decide the next step"}]
MAX_TOKENS = 32


def _jax_backend(sharing=False):
    engines = {}
    for spec in POOL:
        jcfg, _ = both_configs(spec.split(":")[1])
        params, _ = shared_params(spec.split(":")[1], seed=7)
        e = jgen.GenerateEngine(jcfg, params, jtok.get_tokenizer(spec))
        e.unified_min_tokens = 0       # the unified ragged tier
        e.prefix_sharing = sharing     # as the port's engines below
        engines[spec] = e
    e0 = engines[POOL[0]]
    return jrt.TPUBackend(POOL, engines=engines, embedder=jemb.EmbeddingEncoder(
        e0.cfg, e0.params, e0.tokenizer))


def _torch_backend(sharing=False):
    engines = {}
    for spec in POOL:
        _, tcfg = both_configs(spec.split(":")[1])
        _, model = shared_params(spec.split(":")[1], seed=7)
        e = tgen.GenerateEngine(tcfg, model, ttok.get_tokenizer(spec),
                                device="cpu")
        e.unified_min_tokens = 0       # on the CPU the default is gather
        # the two-decide tests pin the unshared tier; the sharing default
        # is test_second_agent_adopts_the_prompt_at_the_default's
        e.prefix_sharing = sharing
        engines[spec] = e
    return trt.TorchBackend(POOL, device="cpu", engines=engines)


def _next_step(outcome, messages) -> dict:
    """The agent's next step: each member's history plus its own answer of
    the decide (the text its session holds) and the action's result."""
    out = {}
    for m in POOL:
        raw = next((p.raw_text for p in outcome.proposals
                    if p.model_spec == m), None)
        if raw is None:
            raw = next((f.raw_text for f in outcome.failures
                        if f.model_spec == m), "")
        out[m] = list(messages) + [
            {"role": "assistant", "content": raw},
            {"role": "user", "content": "result: waited; no new events"}]
    return out


def _two_decides(ce, backend):
    engine = ce.ConsensusEngine(backend, ce.ConsensusConfig(
        model_pool=list(POOL), max_refinement_rounds=2,
        session_key=SESSION, allowed_actions={"wait"},
        max_tokens=MAX_TOKENS))
    first = engine.decide({m: list(MESSAGES) for m in POOL})
    second = engine.decide(_next_step(first, MESSAGES))
    return first, second


@pytest.fixture
def greedy(monkeypatch):
    for mod in (jce, tce):
        monkeypatch.setattr(mod, "temperature_for_round",
                            lambda *a, **kw: 0.0)
    # the JAX encoder's working cache in the fp32 weights' dtype
    # (tests/test_torch_embeddings.py)
    monkeypatch.setattr(jemb, "init_cache", functools.partial(
        jtr.init_cache, dtype=jnp.float32))


def test_greedy_decides_identical_in_both_packages(greedy):
    runs = {"jax_engine_tpu_backend": _two_decides(jce, _jax_backend()),
            "jax_engine_torch_backend": _two_decides(jce, _torch_backend()),
            "port_engine_torch_backend": _two_decides(tce, _torch_backend())}
    ref = [outcome_view(o) for o in runs["jax_engine_tpu_backend"]]
    for name, outs in runs.items():
        assert [outcome_view(o) for o in outs] == ref, name
    first, second = runs["port_engine_torch_backend"]
    assert first.cached_tokens == 0 and second.cached_tokens > 0
    for out in (first, second):
        texts = [p.raw_text for p in out.proposals] + [
            f.raw_text for f in out.failures]
        assert len(texts) == len(POOL) and all(texts)
        if out.decision is not None:
            assert out.decision.action == "wait"


def _two_agents(ce, backend):
    """One decide each by two agents (two session keys) with the same
    action set and messages (a system prompt of more than a page), in
    turn. Returns the outcomes and, per agent, each member's cached tokens
    in each round."""
    system = SYSTEM + " " + " ".join(
        f"Rule {i}: keep step {i} short." for i in range(8))
    messages = [{"role": "system", "content": system}, MESSAGES[1]]
    cached: list = []
    orig = backend.query

    def query(requests):
        res = orig(requests)
        cached[-1].append({r.model_spec: r.cached_tokens for r in res})
        return res
    backend.query = query
    outs = []
    for agent in ("agent-one", "agent-two"):
        cached.append([])
        outs.append(ce.ConsensusEngine(backend, ce.ConsensusConfig(
            model_pool=list(POOL), max_refinement_rounds=2,
            session_key=agent, allowed_actions={"wait"},
            max_tokens=MAX_TOKENS)).decide({m: list(messages)
                                            for m in POOL}))
    return outs, cached


def test_second_agent_adopts_the_prompt_at_the_default(greedy):
    """Both packages at their sharing default: the second agent's first
    decide adopts the radix-cached pages of the prompt the first agent's
    decide prefilled, on every member (neither tiny member has a window),
    and both packages agree on the outcomes, the audit records and each
    member's cached tokens."""
    jouts, jcached = _two_agents(jce, _jax_backend(sharing=True))
    touts, tcached = _two_agents(tce, _torch_backend(sharing=True))
    assert [outcome_view(o) for o in touts] == [outcome_view(o)
                                                for o in jouts]
    assert tcached == jcached
    assert all(n == 0 for n in tcached[0][0].values())
    assert all(n >= 128 for n in tcached[1][0].values()), tcached
    assert touts[1].cached_tokens > touts[0].cached_tokens


def test_sampled_decide_on_the_port():
    """The default schedule (1.0 falling to 0.2): every proposal the port
    returns parses, and the next step resumes."""
    first, second = _two_decides(tce, _torch_backend())
    for out in (first, second):
        assert out.status == "ok", [(f.kind, f.error) for f in out.failures]
        assert out.decision.action == "wait"
        assert out.proposals
        for p in out.proposals:
            assert isinstance(parse_response(p.model_spec, p.raw_text),
                              ActionProposal)
    assert second.cached_tokens > 0


def test_json_closure_tool_counts_closed_answers(capsys):
    """tools/json_closure.py, which sizes the decide phase's token budget
    on the card: shares of closed answers per budget, rising with it."""
    assert json_closure.main(["xla:tiny", "--trials", "6",
                              "--max-tokens", "48", "--seed", "3"]) == 0
    out = json.loads(capsys.readouterr().out)
    for mode in ("iid", "fixed"):
        shares = [out[mode][str(b)] for b in (12, 24, 48)]
        assert shares == sorted(shares) and 0.0 <= shares[0] <= 1.0
        assert all(round(x * 6) == x * 6 for x in shares)
