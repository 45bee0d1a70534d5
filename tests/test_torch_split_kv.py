"""The split-K decode core's share rule and combine (``csrc/split_kv.cuh``,
run on the card by ``paged_fwd``, ``ragged_fwd`` and ``ragged_q8_fwd``),
emulated in plain PyTorch on the CPU and held against the port's twins and
the JAX Pallas kernels in interpret mode.

The emulation splits each block's visible keys [lo, hi) as the kernel
does: whole 64-key tiles from floor(lo / 64) * 64, share s of S taking
tiles [s * tiles // S, (s + 1) * tiles // S); it takes each share's
partial (acc, m, l) with the twin's own arithmetic over that share's keys
alone, then merges the S partials in order, a partial with l == 0 masked
out. Tolerance 1e-5 absolute and relative: fp32 on every side, only the
order of the sums differs. Rows that see no key are (0, NEG_INF, 0)
exactly (paged partials) or 0 (ragged output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quoracle_tpu.models import quant as jq
from quoracle_tpu.ops import paged_attention as jpa
from quoracle_tpu_torch.models.quant import gather_scales
from quoracle_tpu_torch.ops import paged_attention as tpa
from quoracle_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TILE = tpa.KEY_TILE


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def share_bounds(lo: int, hi: int, S: int) -> list:
    """The kernel's shares of [lo, hi): S (start, end) key ranges."""
    tlo = lo // TILE * TILE
    tiles = -(-(hi - tlo) // TILE) if hi > lo else 0
    out = []
    for s in range(S):
        a = tlo + s * tiles // S * TILE
        b = min(tlo + (s + 1) * tiles // S * TILE, hi)
        out.append((a, max(a, b)) if tiles else (0, 0))
    return out


def combine(parts, masked: bool = True):
    """Merge partials [(acc [..., hd], m [...], l [...]), ...] in order;
    ``masked``: a partial with l == 0 takes no part (the kernel's rule)."""
    acc = torch.stack([p[0] for p in parts])
    m = torch.stack([p[1] for p in parts])
    l = torch.stack([p[2] for p in parts])
    seen = l > 0 if masked else torch.ones_like(l, dtype=torch.bool)
    mm = torch.where(seen, m, torch.full_like(m, NEG_INF)).amax(dim=0)
    c = torch.exp(m - mm)
    ll = torch.where(seen, l * c, torch.zeros_like(l)).sum(dim=0)
    aa = torch.where(seen[..., None], acc * c[..., None],
                     torch.zeros_like(acc)).sum(dim=0)
    if masked:          # what the kernel writes for a row that saw no key
        empty = ll == 0
        aa = torch.where(empty[..., None], torch.zeros_like(aa), aa)
        mm = torch.where(empty, torch.full_like(mm, NEG_INF), mm)
    return aa, mm, ll


def _masked_partials(scores, mask, v):
    """The twin's arithmetic: scores [..., S] and mask -> (acc, m, l)."""
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    return torch.einsum("...s,...sd->...d", p, v), m, p.sum(dim=-1)


# ---------------------------------------------------------------------------
# paged_fwd: direct-tier decode partials
# ---------------------------------------------------------------------------

def paged_range(kv_len, kv_off, q_pos, window, maxp, page):
    """The kernel's [lo, hi) of one row (paged_fwd.cu)."""
    hi = max(min(kv_len, maxp * page, q_pos - kv_off + 1), 0)
    qlo = tpa.INT32_MIN if window is None else q_pos - window
    lo = min(max(qlo - kv_off + 1, 0), hi)
    return lo, hi


def paged_split(q, kp, vp, tables, kv_lens, kv_off, q_pos, window, S,
                masked=True, empty_acc=None):
    """paged_fwd's S shares and combine, emulated: (acc, m, l) [B, H, ..].
    ``empty_acc`` overwrites the acc of every share that saw no key (a
    slot the combine must never read)."""
    B, H, hd = q.shape
    _, page, KV, _ = kp.shape
    maxp = tables.shape[1]
    t = tables.long()
    k = kp[t].reshape(B, maxp * page, KV, hd).float().permute(0, 2, 1, 3)
    v = vp[t].reshape(B, maxp * page, KV, hd).float().permute(0, 2, 1, 3)
    qg = (q.float() * hd ** -0.5).reshape(B, KV, H // KV, hd)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k)
    idx = torch.arange(maxp * page)
    parts = []
    bounds = [share_bounds(*paged_range(int(kv_lens[b]), int(kv_off[b]),
                                        int(q_pos[b]), window, maxp, page),
                           S) for b in range(B)]
    for s in range(S):
        rows = []
        for b in range(B):
            a, e = bounds[b][s]
            pos = idx + int(kv_off[b])
            mask = (idx < int(kv_lens[b])) & (pos <= int(q_pos[b])) & \
                (idx >= a) & (idx < e)
            if window is not None:
                mask &= int(q_pos[b]) - pos < window
            rows.append(_masked_partials(
                scores[b], mask.expand(KV, H // KV, -1), v[b][:, None]))
        acc, m, l = (torch.stack(x) for x in zip(*rows))
        if empty_acc is not None:
            acc = torch.where((l == 0)[..., None],
                              torch.full_like(acc, empty_acc), acc)
        parts.append((acc.reshape(B, H, hd), m.reshape(B, H),
                      l.reshape(B, H)))
    return combine(parts, masked)


PAGED_CASES = {
    # rows of many shares; kv_len on a tile boundary and one past it; an
    # empty row; a nonzero offset with the query ahead of the pool
    "long": dict(H=8, KV=2, kv_lens=[700, 256, 257, 0], kv_off=[0, 5, 64, 3],
                 window=None),
    # a window that leaves the range a few tiles: most shares empty
    "window": dict(H=8, KV=2, kv_lens=[700, 256, 257, 0],
                   kv_off=[0, 5, 64, 3], window=90),
    # MHA, a one-key row
    "mha": dict(H=4, KV=4, kv_lens=[1, 640, 65, 300], kv_off=[0, 0, 9, 0],
                window=None),
}


def _paged_inputs(c, seed=21, hd=32, page=64, maxp=12):
    rng = np.random.default_rng(seed)
    B = len(c["kv_lens"])
    n_pages = B * maxp + 1
    q = rng.standard_normal((B, c["H"], hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_pages, page, c["KV"], hd))
              .astype(np.float32) for _ in range(2))
    tables = (rng.permutation(np.arange(1, n_pages))[:B * maxp]
              .reshape(B, maxp).astype(np.int32))
    kv_lens = np.asarray(c["kv_lens"], np.int32)
    kv_off = np.asarray(c["kv_off"], np.int32)
    q_pos = (kv_off + kv_lens + np.array([0, 3, 7, 1])).astype(np.int32)
    return q, kp, vp, tables, kv_lens, kv_off, q_pos


@pytest.mark.parametrize("S", [1, 2, 3, 7, "max"])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_split_combine_matches_twin_and_jax(name, S):
    c = PAGED_CASES[name]
    args = _paged_inputs(c)
    w = c["window"]
    S = tpa.max_splits(args[3].shape[1], args[1].shape[1]) if S == "max" \
        else S
    got = paged_split(*[_t(a) for a in args], w, S)
    ref = tpa.paged_attend_ref(*[_t(a) for a in args], w)
    jkrn = jpa.paged_attend(*[jnp.asarray(a) for a in args], w,
                            interpret=True)
    for g, r, j in zip(got, ref, jkrn):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)
    empty = ref[2] == 0
    assert bool(empty.any()) == (name != "mha")
    assert torch.all(got[0][empty] == 0) and torch.all(got[2][empty] == 0)
    assert torch.all(got[1][empty] == NEG_INF)


def test_share_rule_covers_every_key_once():
    for lo, hi in ((0, 0), (0, 1), (0, 64), (0, 65), (130, 700), (5, 4100)):
        tiles = -(-(hi - lo // TILE * TILE) // TILE) if hi > lo else 0
        for S in (1, 2, 3, 7, max(1, tiles), tiles + 5):
            b = share_bounds(lo, hi, S)
            keys = [k for a, e in b for k in range(a, e)]
            assert sorted(keys) == keys
            assert set(keys) >= set(range(lo, hi))
            assert all(lo // TILE * TILE <= a and e <= hi for a, e in b)
            sizes = [e - a for a, e in b if e > a]
            assert all(n <= -(-tiles // S) * TILE for n in sizes)


def test_combine_without_the_mask_breaks_an_empty_row():
    """A row that sees no key has every share empty, so its max stays
    NEG_INF and exp(NEG_INF - NEG_INF) = 1 weighs every empty share in:
    without the l == 0 mask the row's result is whatever the empty
    shares' acc slots hold. With it, (0, NEG_INF, 0) whatever they
    hold."""
    c = PAGED_CASES["window"]
    args = [_t(a) for a in _paged_inputs(c)]
    ref = tpa.paged_attend_ref(*args, c["window"])
    empty = ref[2] == 0
    ok = paged_split(*args, c["window"], 7, empty_acc=float("nan"))
    assert torch.all(ok[0][empty] == 0) and torch.all(ok[1][empty] == NEG_INF)
    for g, r in zip(ok, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)
    bad = paged_split(*args, c["window"], 7, masked=False,
                      empty_acc=float("nan"))
    assert not torch.all(bad[0][empty] == 0)


# ---------------------------------------------------------------------------
# ragged_fwd and ragged_q8_fwd: unified ragged attention over float pages
# and over int8 pages
# ---------------------------------------------------------------------------

def ragged_range(kv_len, qpos0, nq, window, maxp, page):
    """The kernels' [lo, hi) of one block (split_kv.cuh, ragged_block):
    the first query's window start to the last query's end; inert blocks
    empty."""
    if nq == 0:
        return 0, 0
    hi = max(min(kv_len, qpos0 + nq, maxp * page), 0)
    lo = 0 if window is None else max(qpos0 + 1 - window, 0)
    return min(lo, hi), hi


def ragged_split(q, kq, vq, btab, bmeta, ks, vs, tq, window, S):
    """The ragged kernels' S shares, combine and normalization, emulated:
    [NB * tq, H, hd] fp32; float pages (ragged_fwd) when ``ks`` and ``vs``
    are None, else int8 pages with their scales (ragged_q8_fwd)."""
    nb, maxp = btab.shape
    _, H, hd = q.shape
    _, page, KV, _ = kq.shape
    G = H // KV
    t = btab.long()
    k = kq[t].reshape(nb, maxp * page, KV, hd).float()
    v = vq[t].reshape(nb, maxp * page, KV, hd).float()
    if ks is not None:
        k = k * gather_scales(ks, btab)[..., None]
        v = v * gather_scales(vs, btab)[..., None]
    qb = (q.float() * hd ** -0.5).reshape(nb, tq, KV, G, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qb, k)     # [NB,KV,G,tq,S]
    s_idx = torch.arange(maxp * page)
    t_idx = torch.arange(tq)[:, None]
    parts = []
    bounds = [share_bounds(*ragged_range(*map(int, bmeta[i]), window, maxp,
                                         page), S) for i in range(nb)]
    for s in range(S):
        rows = []
        for i in range(nb):
            kv_len, qpos0, nq = map(int, bmeta[i])
            a, e = bounds[i][s]
            qpos = qpos0 + t_idx
            mask = (s_idx < kv_len) & (s_idx <= qpos) & (t_idx < nq) & \
                (s_idx >= a) & (s_idx < e)
            if window is not None:
                mask &= qpos - s_idx < window
            rows.append(_masked_partials(
                scores[i], mask.expand(KV, G, tq, -1),
                v[i].permute(1, 0, 2)[:, None, None]))
        parts.append(tuple(torch.stack(x) for x in zip(*rows)))
    acc, _, l = combine(parts)
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(nb * tq, H, hd)


RAGGED_CASES = {
    # long chunk rows, tile-boundary lengths, an inert block, a one-token
    # row
    "chunks_tq8": dict(rows=[(600, 37), (248, 8), (0, 0), (249, 8), (0, 1)],
                       tq=8, H=8, KV=2, window=None),
    "decode_tq1": dict(rows=[(699, 1), (255, 1), (0, 0), (256, 1), (0, 1)],
                       tq=1, H=8, KV=2, window=None),
    # windows that leave the long rows a few tiles (empty shares)
    "decode_window": dict(rows=[(699, 1), (255, 1), (0, 0), (256, 1)],
                          tq=1, H=8, KV=2, window=70),
    "chunks_window": dict(rows=[(600, 37), (0, 0), (249, 8)], tq=8, H=4,
                          KV=4, window=100),
}


def _ragged_inputs(c, quantized, seed=22, hd=32, page=64, maxp=12):
    """(q, k pages, v pages, tables, meta, k_scale, v_scale) of a case:
    float pages and no scales, or the same pages quantized to int8 with
    the engine's rule."""
    rng = np.random.default_rng(seed)
    rows, tq = c["rows"], c["tq"]
    nb = sum(-(-n // tq) if n else 1 for _, n in rows)
    n_pages = len(rows) * maxp + 1
    q = rng.standard_normal((nb * tq, c["H"], hd)).astype(np.float32)
    kv = [rng.standard_normal((n_pages, page, c["KV"], hd))
          .astype(np.float32) for _ in range(2)]
    kv[0][3, :, 0] = 0.0                        # zero vectors: scale 1.0
    pools = []
    for x in kv:
        if quantized:
            qv, s = jq.kv_quant(jnp.asarray(x))
            pools += [np.asarray(qv),
                      np.asarray(s).transpose(0, 2, 1).copy()]
        else:
            pools += [x, None]
    perm = rng.permutation(np.arange(1, n_pages))
    btab = np.zeros((nb, maxp), np.int32)
    bmeta = np.zeros((nb, 3), np.int32)
    blk = 0
    for r, (pre, n) in enumerate(rows):
        for b in range(-(-n // tq) if n else 1):
            btab[blk] = perm[r * maxp:(r + 1) * maxp]
            bmeta[blk] = (pre + n, pre + b * tq, max(0, min(tq, n - b * tq)))
            blk += 1
    kq, ks, vq, vs = pools
    return q, kq, vq, btab, bmeta, ks, vs


def _check_ragged_split(name, S, quantized):
    """The emulated split of a case against ``ragged_attend_ref`` and the
    JAX ``ragged_attend(interpret=True)`` (with the scales when
    ``quantized``) at 1e-5; inert blocks and rows t >= nq exactly 0."""
    c = RAGGED_CASES[name]
    q, kq, vq, btab, bmeta, ks, vs = _ragged_inputs(c, quantized)
    tq, w = c["tq"], c["window"]
    S = tpa.max_splits(btab.shape[1], kq.shape[1]) if S == "max" else S
    ta = [_t(a) for a in (q, kq, vq, btab, bmeta)]
    sc = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    got = ragged_split(*ta, sc.get("k_scale"), sc.get("v_scale"), tq, w, S)
    ref = tpa.ragged_attend_ref(*ta, tq, w, **sc)
    jkrn = np.asarray(jpa.ragged_attend(
        *[jnp.asarray(a) for a in (q, kq, vq, btab, bmeta)], tq=tq,
        sliding_window=w, interpret=True,
        **{k: jnp.asarray(v.numpy()) for k, v in sc.items()}))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), jkrn, **TOL)
    for i, (_, _, nq) in enumerate(bmeta):   # inert blocks, rows t >= nq
        assert torch.all(got[i * tq + nq:(i + 1) * tq] == 0)


@pytest.mark.parametrize("S", [1, 2, 3, 7, "max"])
@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_q8_split_combine_matches_twin_and_jax(name, S):
    _check_ragged_split(name, S, quantized=True)


@pytest.mark.parametrize("S", [1, 2, 3, 7, "max"])
@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_split_combine_matches_twin_and_jax(name, S):
    """ragged_fwd: the same cases over float pages, no scales."""
    _check_ragged_split(name, S, quantized=False)


# ---------------------------------------------------------------------------
# The host's share count
# ---------------------------------------------------------------------------

H100_SMS = 132
MAIN_PATH_GRIDS = {
    # (blocks, KV, maxp) of llama-3-8b's consensus round at page 128: the
    # direct tier's decode (4 row slots, 9 pages a row), the unified
    # tier's decode tick (8 one-token blocks, a pow2 table of 16 pages)
    # and its resumed chunk tick (8 blocks of 8 tokens, 6 of them live)
    "paged_decode": (4, 8, 9),
    "ragged_decode": (8, 8, 16),
    "ragged_chunk": (8, 8, 16),
}


@pytest.mark.parametrize("name", sorted(MAIN_PATH_GRIDS))
def test_split_count_fills_the_card_at_the_main_path(name):
    blocks, kv, maxp = MAIN_PATH_GRIDS[name]
    S = tpa.split_count(blocks, kv, maxp, 128, H100_SMS)
    assert 1 < S <= tpa.max_splits(maxp, 128)
    assert blocks * kv * S >= H100_SMS


@pytest.mark.parametrize("blocks,kv,maxp,page", [
    (1, 1, 1, 64), (1, 8, 1, 128), (4, 8, 40, 128), (64, 8, 16, 128),
    (512, 8, 64, 128), (3, 2, 12, 64)])
def test_split_count_bounds(blocks, kv, maxp, page):
    tiles = -(-maxp * page // TILE)
    assert tpa.max_splits(maxp, page) == tiles
    for sms in (1, 8, 132):
        S = tpa.split_count(blocks, kv, maxp, page, sms)
        assert 1 <= S <= tiles
        # never more shares than the target needs
        assert S == 1 or (S - 1) * blocks * kv < \
            tpa.SHARE_BLOCKS_PER_SM * sms


def test_cpu_tensors_take_the_twin_whatever_the_splits():
    c = PAGED_CASES["long"]
    args = [_t(a) for a in _paged_inputs(c)]
    # CPU tensors take the twin whatever the share count
    for S in (1, 5):
        got = tpa.paged_attend(*args, c["window"], splits=S)
        for g, r in zip(got, tpa.paged_attend_ref(*args, c["window"])):
            assert torch.equal(g, r)


def test_cpu_float_ragged_takes_the_twin_whatever_the_splits():
    """ragged_attend(splits=) over float pages on CPU tensors returns the
    twin's result bit for bit (splits applies to every ragged kernel)."""
    c = RAGGED_CASES["chunks_tq8"]
    q, kp, vp, btab, bmeta, _, _ = _ragged_inputs(c, quantized=False)
    args = [_t(a) for a in (q, kp, vp, btab, bmeta)]
    ref = tpa.ragged_attend_ref(*args, c["tq"], c["window"])
    for S in (1, 5):
        got = tpa.ragged_attend(*args, c["tq"], c["window"], splits=S)
        assert torch.equal(got, ref)
