"""The training step of the PyTorch port (quoracle_tpu_torch/models/
train.py, training/trainer.py's loss and optimizer) against the JAX
package, on the CPU in fp32, plus the checkpoint round trip of
tests/test_train_checkpoint.py in the port's own format.

Configs: ``tiny`` (GQA), ``tiny-gemma`` (tied head, plus-one norms,
scaled embeddings, softcap-free) and ``tiny-window`` (sliding window 16
over 24-token rows). Weights reach the port through ``params_from_jax``;
the JAX gradient tree goes through the same converter, so every leaf is
compared in the port's layout.

Tolerances, each with its reason:

* logits 1e-4: two layers of fp32 products summed in another order, over
  activations of order 1-10 (tests/test_torch_transformer.py's);
* loss and gradients 1e-5: the same sums, reduced to O(1) values;
* the optimizers 1e-6: the same gradients fed to optax and to the port's
  AdamW, warmup-cosine and global-norm clip included: the same formulas
  in fp32, one rounding apart;
* five train steps: the losses within 1e-4. The parameters after them
  are held only to 1e-2: AdamW's first update is about +-lr wherever
  |g| >> eps, whatever |g| is, so an element whose gradient is near 0
  on one side and of the other sign on the other (a 1e-7 difference can
  flip it) moves 2 lr apart; the losses, which every element feeds, stay
  close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import both_configs, shared_params
from quoracle_tpu.models import train as jtrain
from quoracle_tpu.models import transformer as jtr
from quoracle_tpu.training import trainer as jtrainer
from quoracle_tpu_torch.models import train as ttrain
from quoracle_tpu_torch.models import transformer as ttr
from quoracle_tpu_torch.models.config import get_model_config
from quoracle_tpu_torch.models.convert import params_from_jax
from quoracle_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(1)

CONFIGS = ["tiny", "tiny-gemma", "tiny-window"]
B, T = 2, 24


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    targets = rng.integers(3, cfg.vocab_size, (B, T)).astype(np.int32)
    weights = rng.choice([0.0, 0.25, 1.0], (B, T)).astype(np.float32)
    return tokens, mask, targets, weights


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _grad_model(grads, tcfg):
    """The JAX gradient tree in the port's layout (params_from_jax
    transposes the projections)."""
    return params_from_jax(jax.device_get(grads), tcfg, device="cpu")


def _assert_grads(tgrads, jgrads_model, model, tol):
    for (name, _), g, w in zip(model.named_parameters(), tgrads,
                               jgrads_model.parameters()):
        torch.testing.assert_close(g, w.detach(), msg=name, **tol)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_logits_match_jax(name):
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=2)
    tokens = _batch(jcfg)[0]
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    cache = jtr.init_cache(jcfg, B, T, dtype=jnp.float32)
    want, _ = jtr.forward(params, jcfg, jnp.asarray(tokens),
                          jnp.asarray(pos), cache,
                          write_offset=jnp.zeros((B,), jnp.int32),
                          kv_lens=jnp.full((B,), T, jnp.int32))
    got = ttr.forward(model, tcfg, _t(tokens), _t(pos))
    assert got.dtype == torch.float32 and got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_grads_match_jax_value_and_grad(name):
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=3)
    tokens, mask, _, _ = _batch(jcfg, seed=1)
    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(
        params, jcfg, jnp.asarray(tokens), jnp.asarray(mask))
    loss = ttrain.loss_fn(model, tcfg, _t(tokens), _t(mask))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-5)
    grads = ttrain.grads_of(loss, model)
    _assert_grads(grads, _grad_model(jgrads, tcfg), model,
                  dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("name", CONFIGS)
def test_distill_loss_and_grads_match_jax(name):
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=4)
    tokens, _, targets, weights = _batch(jcfg, seed=2)
    jloss, jgrads = jax.value_and_grad(jtrainer.distill_loss_fn)(
        params, jcfg, jnp.asarray(tokens), jnp.asarray(targets),
        jnp.asarray(weights))
    loss = ttrainer.distill_loss_fn(model, tcfg, _t(tokens), _t(targets),
                                    _t(weights))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-5)
    _assert_grads(ttrain.grads_of(loss, model), _grad_model(jgrads, tcfg),
                  model, dict(rtol=1e-5, atol=1e-5))


def test_distill_loss_with_targets_equal_tokens_is_the_finetune_loss():
    jcfg, tcfg = both_configs("tiny")
    _, model = shared_params("tiny", seed=5)
    tokens, mask, _, _ = _batch(jcfg, seed=3)
    a = ttrain.loss_fn(model, tcfg, _t(tokens), _t(mask))
    b = ttrainer.distill_loss_fn(model, tcfg, _t(tokens), _t(tokens),
                                 _t(mask))
    assert torch.equal(a, b)


OPT_CASES = {
    "adamw": dict(warmup=0, clip_norm=0.0),
    "warmup-cosine": dict(warmup=2, clip_norm=0.0),
    "clip": dict(warmup=0, clip_norm=0.05),
    "warmup-cosine-clip": dict(warmup=3, clip_norm=0.05),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_updates_match_optax(case):
    """The same gradients fed to the JAX trainer's optax chain and to the
    port's AdamW for several updates: the parameters agree within 1e-6
    (the clip cases clip every step: the gradients' norm is above 0.05)."""
    jcfg, tcfg = both_configs("tiny")
    params, model = shared_params("tiny", seed=6)
    kw = OPT_CASES[case]
    jt = jtrainer.TrainerConfig(steps=7, lr=1e-2, **kw)
    tt = ttrainer.TrainerConfig(steps=7, lr=1e-2, **kw)
    jopt = jtrainer.make_optimizer(jt)
    topt = ttrainer.make_optimizer(tt)
    jstate = jopt.init(params)
    tstate = topt.init(model)
    rng = np.random.default_rng(7)
    for step in range(7):
        gtree = jax.tree.map(
            lambda x: jnp.asarray(0.05 * rng.standard_normal(x.shape),
                                  jnp.float32), params)
        upd, jstate = jopt.update(gtree, jstate, params)
        params = optax.apply_updates(params, upd)
        grads = [p.detach().clone() for p in
                 _grad_model(gtree, tcfg).parameters()]
        tstate = topt.update(grads, tstate, model)
    assert tstate.count == 7
    for (name, p), w in zip(model.named_parameters(),
                            _grad_model(params, tcfg).parameters()):
        torch.testing.assert_close(p.detach(), w.detach(), rtol=1e-6,
                                   atol=1e-6, msg=name)


def test_schedule_values_match_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 4, 20,
                                               end_value=3e-4)
    mine = ttrain.warmup_cosine_decay_schedule(0.0, 3e-3, 4, 20,
                                               end_value=3e-4)
    for count in range(25):
        assert mine(count) == pytest.approx(float(sched(count)), rel=1e-6,
                                            abs=1e-12)


@pytest.mark.parametrize("name", CONFIGS)
def test_five_train_steps_track_jax(name):
    jcfg, tcfg = both_configs(name)
    params, model = shared_params(name, seed=8)
    jopt = jtrain.make_optimizer(1e-3)
    jstate = jtrain.TrainState(params, jopt.init(params),
                               jnp.zeros((), jnp.int32))
    topt = ttrain.make_optimizer(1e-3)
    tstate = ttrain.init_train_state(model, topt)
    jl, tl = [], []
    for i in range(5):
        tokens, mask, _, _ = _batch(jcfg, seed=10 + i)
        jstate, jloss = jtrain.train_step(jstate, jcfg, jopt,
                                          jnp.asarray(tokens),
                                          jnp.asarray(mask))
        tstate, tloss = ttrain.train_step(tstate, tcfg, topt, _t(tokens),
                                          _t(mask))
        jl.append(float(jloss))
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert tstate.step == int(jstate.step) == 5
    for p, w in zip(model.parameters(),
                    _grad_model(jstate.params, tcfg).parameters()):
        torch.testing.assert_close(p.detach(), w.detach(), rtol=0,
                                   atol=1e-2)


# ---------------------------------------------------------------------------
# tests/test_train_checkpoint.py's cases, in the port's format
# ---------------------------------------------------------------------------


def _ckpt_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32))
    return tokens, torch.ones((2, 16), dtype=torch.float32)


def _bf16_state(cfg, opt, seed):
    params = ttr.init_params(cfg, torch.Generator().manual_seed(seed),
                             device="cpu", dtype=torch.bfloat16)
    return ttrain.init_train_state(params, opt)


def test_train_state_roundtrip_resumes_identically(tmp_path):
    cfg = get_model_config("xla:tiny")
    opt = ttrain.make_optimizer(1e-3)
    state = _bf16_state(cfg, opt, 0)
    tokens, mask = _ckpt_batch(cfg)
    state, _ = ttrain.train_step(state, cfg, opt, tokens, mask)
    ttrain.save_train_state(str(tmp_path / "ckpt"), state)

    restored = ttrain.load_train_state(str(tmp_path / "ckpt"),
                                       _bf16_state(cfg, opt, 7))
    assert restored.step == 1 and restored.opt_state.count == 1
    for a, b in zip(state.params.state_dict().values(),
                    restored.params.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                    restored.opt_state.mu + restored.opt_state.nu):
        assert torch.equal(a, b)
    # resuming from the restore matches continuing the original run
    t2, m2 = _ckpt_batch(cfg, seed=1)
    s_cont, loss_cont = ttrain.train_step(state, cfg, opt, t2, m2)
    s_rest, loss_rest = ttrain.train_step(restored, cfg, opt, t2, m2)
    assert torch.equal(loss_cont, loss_rest)
    assert s_cont.step == s_rest.step == 2
    for a, b in zip(s_cont.params.parameters(), s_rest.params.parameters()):
        assert torch.equal(a, b)


def test_save_overwrites_stable_path(tmp_path):
    """Periodic saves to one path (ckpt/latest every N steps) overwrite,
    and leave no temp file behind."""
    cfg = get_model_config("xla:tiny")
    opt = ttrain.make_optimizer(1e-3)
    state = _bf16_state(cfg, opt, 0)
    path = str(tmp_path / "latest")
    ttrain.save_train_state(path, state)
    tokens, mask = _ckpt_batch(cfg)
    state, _ = ttrain.train_step(state, cfg, opt, tokens, mask)
    ttrain.save_train_state(path, state)     # second save: must overwrite
    restored = ttrain.load_train_state(path, _bf16_state(cfg, opt, 3))
    assert restored.step == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["latest"]


def test_bf16_head_gets_its_gradient():
    """The serving head_f32() copy is detached; the training forward
    upcasts the head with its gradient, as the JAX package does."""
    cfg = get_model_config("xla:tiny")
    state = _bf16_state(cfg, ttrain.make_optimizer(1e-3), 0)
    tokens, mask = _ckpt_batch(cfg)
    loss = ttrain.loss_fn(state.params, cfg, tokens, mask)
    grads = dict(zip([n for n, _ in state.params.named_parameters()],
                     ttrain.grads_of(loss, state.params)))
    head = "embed.weight" if cfg.tie_embeddings else "lm_head.weight"
    assert grads[head].abs().sum() > 0
    assert all(g.abs().sum() > 0 for n, g in grads.items()
               if n.endswith(("wq.weight", "wk.weight", "wv.weight")))
