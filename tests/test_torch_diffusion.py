"""The port's diffusion image backend (quoracle_tpu_torch/models/
diffusion.py) against the JAX package's, on the CPU in fp32: the cases
of tests/test_diffusion.py on both packages, and the pieces the layouts
could break held against JAX over the same weights (carried across by
``diffusion_params_from_jax``).

Tolerances: one ``denoise`` call within 1e-5 (fp32 convolutions summed in
another order); the schedule's step indices equal, its alpha-bar within
1e-6 (a sequential ``torch.cumprod`` against XLA's); the 30-step DDIM loop
from JAX's own initial noise within 1e-3 on images in [0, 1] (a quarter
of one 8-bit step: the first steps multiply eps by rsqrt(alpha-bar) ~
158, so the ulps of each step grow; 3.5e-4 seen). The noise itself cannot
match: ``jax.random.normal`` against a ``torch.Generator``, so the PNGs
differ between the packages (ROADMAP Queue 3)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _agent_parity import BOTH, JAX, PORT, j, run
from quoracle_tpu.models import diffusion as jd
from quoracle_tpu_torch.models import diffusion as td
from test_torch_world_actions import run_actions, scripted

torch.set_num_threads(1)

TINY_KW = dict(image_size=16, base_ch=8, ch_mult=(1, 2), emb_ch=16,
               groups=4, sample_steps=4)
TINY = td.DiffusionConfig(**TINY_KW)
CONFIGS = {"tiny": TINY_KW, "default": {}}


def pair(name: str, seed: int = 0):
    """(JAX config, JAX params, port config, port UNet) over one tree;
    the GroupNorm weights redrawn so a swapped leaf cannot hide."""
    jc = jd.DiffusionConfig(**CONFIGS[name])
    tc = td.DiffusionConfig(**CONFIGS[name])
    tree = jax.device_get(jd.init_diffusion_params(
        jc, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def redraw(t):
        if isinstance(t, dict):
            return {k: (1.0 + 0.1 * rng.standard_normal(v.shape))
                    .astype(np.float32) if k in ("n1", "n2") else redraw(v)
                    for k, v in t.items()}
        if isinstance(t, list):
            return [redraw(v) for v in t]
        return t
    tree = redraw(tree)
    tree["out_n"] = (1.0 + 0.1 * rng.standard_normal(
        tree["out_n"].shape)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return jc, jp, tc, td.diffusion_params_from_jax(tree, tc)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def backend():
    return td.DiffusionImageBackend(cfg=TINY, seed=0, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_diffusion.py's cases
# ---------------------------------------------------------------------------

def test_sampler_shapes_and_determinism(backend):
    ids = torch.zeros((2, 8), dtype=torch.int32)
    ids[0, :3] = torch.tensor([10, 20, 30])
    ids[1, :3] = torch.tensor([11, 21, 31])
    a = td.ddim_sample(backend.params, TINY, ids,
                       torch.Generator().manual_seed(1))
    b = td.ddim_sample(backend.params, TINY, ids,
                       torch.Generator().manual_seed(1))
    assert a.shape == (2, 16, 16, 3)
    assert torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    # rows see different noise and different prompts
    assert float((a[0] - a[1]).abs().max()) > 1e-4


def test_backend_writes_pngs_at_requested_size(backend, tmp_path):
    imgs = backend.generate("a red square", count=2, size="32x24",
                            out_dir=str(tmp_path))
    assert len(imgs) == 2
    for im in imgs:
        assert im.width == 32 and im.height == 24
        assert im.model == "xla:diffusion-v0"
        data = open(im.path, "rb").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # same prompt -> same pixels; different prompt -> different pixels
    again = backend.generate("a red square", count=1, size="32x24",
                             out_dir=str(tmp_path))
    other = backend.generate("a blue circle", count=1, size="32x24",
                             out_dir=str(tmp_path))
    assert open(again[0].path, "rb").read()[33:] == \
        open(imgs[0].path, "rb").read()[33:]
    assert open(other[0].path, "rb").read() != \
        open(again[0].path, "rb").read()
    with pytest.raises(ValueError, match="expected WxH"):
        backend.generate("x", size="big")


def test_runtime_composes_diffusion_backend():
    for pkg, kw in ((JAX, {}), (PORT, {"device": "cpu"})):
        rt = pkg.rt.Runtime(pkg.rt.RuntimeConfig(image_backend="diffusion",
                                                 **kw))
        try:
            assert type(rt.deps.images).__name__ == "DiffusionImageBackend"
            assert type(rt.deps.images).__module__ == \
                f"{pkg.name}.models.diffusion"
        finally:
            rt.close()


def test_generate_images_action_over_diffusion(tmp_path):
    """The generate_images action serves from each package's diffusion
    backend through the seam the procedural backend uses (a live agent,
    scripted consensus): the same result text but for the file path."""
    def case(pkg):
        async def main():
            images = (jd.DiffusionImageBackend(cfg=jd.DiffusionConfig(
                **TINY_KW)) if pkg is JAX else td.DiffusionImageBackend(
                    cfg=TINY, device="cpu"))
            backend = scripted(
                pkg, j("generate_images", {"prompt": "sunrise over water",
                                           "count": 1, "size": "16x16"}),
                j("wait", {}))
            return await run_actions(
                pkg, backend, working_dir=str(tmp_path / pkg.name),
                images=images)
        return main()
    got = [run(case(pkg))[1][0] for pkg in BOTH]
    paths = []
    for text in got:
        start = text.index('"path": "') + len('"path": "')
        paths.append(text[start:text.index('"', start)])
        assert os.path.isfile(paths[-1])
    assert got[1].replace(paths[1], "P") == got[0].replace(paths[0], "P")
    assert '"model": "xla:diffusion-v0"' in got[1]
    assert '"width": 16' in got[1]


# ---------------------------------------------------------------------------
# the pieces against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_denoise_matches_jax(name):
    jc, jp, tc, model = pair(name)
    rng = np.random.default_rng(1)
    S = jc.image_size
    x = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    t = np.asarray([0.3, 0.9], np.float32)
    te = rng.standard_normal((2, jc.emb_ch)).astype(np.float32)
    want = np.asarray(jd.denoise(jp, jc, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(te)))
    got = td.denoise(model, tc, nchw(x), torch.from_numpy(t),
                     torch.from_numpy(te)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_thirty_step_loop_from_jax_noise():
    """The default config's 30 DDIM steps: JAX's ``ddim_sample`` against
    the port's ``ddim_loop`` from the same initial noise, drawn here with
    the key JAX's sampler draws it with."""
    jc, jp, tc, model = pair("default")
    assert tc.sample_steps == 30
    ids = np.zeros((2, 64), np.int32)
    ids[0, :5] = [10, 20, 30, 40, 50]
    ids[1, :3] = [70, 80, 90]
    key = jax.random.PRNGKey(7)
    want = np.asarray(jd.ddim_sample(jp, jc, jnp.asarray(ids), key))
    x0 = np.asarray(jax.random.normal(key, (2, 64, 64, 3)))
    got = td.ddim_loop(model, tc, nchw(x0), td.prompt_embedding(
        model, torch.from_numpy(ids))).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_schedule_matches_jax():
    jc = jd.DiffusionConfig()
    idx, a_t, a_prev = td.ddim_schedule(td.DiffusionConfig())
    want_idx = np.asarray(jnp.linspace(jc.train_steps - 1, 0,
                                       jc.sample_steps).astype(jnp.int32))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    abar = np.asarray(jnp.cumprod(1.0 - jnp.linspace(1e-4, 0.02,
                                                     jc.train_steps)))
    np.testing.assert_allclose(a_t.numpy(), abar[want_idx], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(
        a_prev.numpy(), np.concatenate([abar[want_idx[1:]], [1.0]]),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("size", [16, 17, 8, 9, 64])
@pytest.mark.parametrize("stride,k", [(2, 3), (1, 3), (1, 1)],
                         ids=["s2k3", "s1k3", "s1k1"])
def test_same_padding_matches_xla(size, stride, k):
    """XLA's "SAME" at stride 2 pads an even input (0, 1), an odd one
    (1, 1); ``conv_same`` is held against ``jax.lax`` at both, and
    against the off-by-one ``F.conv2d(padding=1)`` that an even input
    would give."""
    rng = np.random.default_rng(size + 10 * stride + k)
    x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = np.asarray(jd._conv(jnp.asarray(x), jnp.asarray(w),
                               stride=stride))
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = td.conv_same(nchw(x), wt, stride).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if stride == 2 and size % 2 == 0:
        naive = torch.nn.functional.conv2d(nchw(x), wt, stride=2,
                                           padding=1)
        assert naive.shape == (1, 5, size // 2, size // 2)
        assert not np.allclose(naive.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-3)


def test_upsample_and_groupnorm_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)
    want = np.asarray(jd._upsample(jnp.asarray(x)))
    got = td.upsample2x(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    w = (1.0 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    want = np.asarray(jd._gn(jnp.asarray(x), jnp.asarray(w), 4))
    got = td._gn(nchw(x), torch.from_numpy(w), 4).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_prompt_embedding_matches_jax():
    jc, jp, tc, model = pair("tiny")
    ids = np.zeros((3, 8), np.int32)
    ids[0, :3] = [10, 20, 30]
    ids[2, :8] = np.arange(40, 48)
    back = td.DiffusionImageBackend(cfg=tc, params=model, device="cpu")
    assert (back._prompt_ids("héllo") == jd.DiffusionImageBackend(
        cfg=jc, params=jp)._prompt_ids("héllo")).all()
    emb = jp["text_embed"][jnp.asarray(ids)]
    nz = (jnp.asarray(ids) > 0).astype(jnp.float32)[..., None]
    want = np.asarray((emb * nz).sum(1) / jnp.maximum(nz.sum(1), 1.0))
    got = td.prompt_embedding(model, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
