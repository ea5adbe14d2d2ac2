"""Kernel 1's bf16 forward without a card: the host-side plan
(``_bf16_plan`` in ``worldforge_tpu_torch/ops/flash_attention.py``) that
picks the route (the long-row loop or the short-key kernel) and lays out
the persistent walk, with the key tiles and shared memory that the kernels'
own layout gives it (``csrc/attention_bf16_plan.cuh``, built here by the
host's C++ compiler through ``csrc/flash_plan.cpp``), and a
model of the short kernel's tiled arithmetic written out in plain PyTorch
here. The CUDA kernel itself is held against ``flash_attention_plain`` only
by ``chip_smoke.py`` on the H100."""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.ops.attention import sdpa_reference
from worldforge_tpu_torch.ops import flash_attention as tfa

SMEM_LIMIT = 232448          # the H100's 227 KB a block

# key counts: the short runs the DiTs give kernel 1 (the avatar's 32 and
# multitalk's 64 audio tokens, CLIP's 257, the text's 512, FLF2V's 514),
# the tile edges around them and the long rows
KEYS = (1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 257, 272, 273,
        320, 321, 384, 512, 513, 514, 1000, 1024, 1560, 2048, 2049, 20280)

# (B, Sq, Sk, H) of the main paths and ragged rows
SHAPES = [
    (1, 20280, 512, 40),       # Wan-14B text cross-attention
    (1, 20280, 257, 40),       # Wan-14B CLIP cross-attention
    (1, 7800, 514, 40),        # FLF2V-14B image cross-attention
    (23, 1560, 32, 32),        # avatar audio cross-attention
    (23, 1560, 64, 32),        # multitalk
    (1, 56320, 512, 32),       # LongCat refine text cross-attention
    (3, 200, 17, 2),
    (2, 333, 129, 3),
    (1, 1, 1, 1),
    (1, 100, 32, 1),           # fewer items than SMs
]


def block_items(plan, block, b, sq, h):
    """The (b, h, query tile) items that persistent block ``block`` of a
    route-1 plan for q [b, sq, h, d] runs, in order, as the kernel's
    ``Walk`` and ``Item`` (``csrc/attention_short_sm90.cuh``) compute them:
    walk 0, a contiguous run of the items numbered (b * h, query tile);
    walk 1, every grid-th item numbered (b, query tile, h) from ``block``.
    This replays the kernel's formulas; the kernel itself is held against
    the plain version only on the card."""
    qt = -(-sq // 128)
    if plan.walk == 1:
        return [(i // (qt * h), i % h, i // h % qt)
                for i in range(block, plan.items, plan.grid)]
    return [(i // qt // h, i // qt % h, i % qt) for i in range(
        block * plan.items // plan.grid,
        (block + 1) * plan.items // plan.grid)]


def _tiles(plan, sk):
    """(first key, width) of each key tile."""
    return [(128 * t, w) for t, w in enumerate(plan.key_tiles)]


@pytest.mark.parametrize("sk", KEYS)
def test_key_tiles_cover_every_key_once(sk):
    for d in (64, 128):
        plan = tfa._bf16_plan(2, 300, sk, 3, d)
        seen = np.zeros(sk + 256, dtype=np.int64)
        for start, w in _tiles(plan, sk):
            assert w in (16, 32, 64, 128)
            seen[start:start + w] += 1
        # every key of the row in exactly one tile; padding only past Sk,
        # and less than one tile of it
        assert (seen[:sk] == 1).all()
        assert (seen[sk:] <= 1).all() and seen[sk:].sum() < 128
        widths = plan.key_tiles
        assert all(w == 128 for w in widths[:-1])
        rem = sk - 128 * (len(widths) - 1)
        if plan.route == 1:
            # the last tile: a multiple of 16 at or above what is left, the
            # narrowest of the kernel's widths
            assert widths[-1] % 16 == 0 and widths[-1] >= rem
            assert widths[-1] == min(w for w in (16, 32, 64, 128) if w >= rem)
            assert plan.tail == (0 if sk % 128 == 0 else widths[-1])
        else:
            assert plan.tail == 0 and widths == (128,) * -(-sk // 128)


@pytest.mark.parametrize("walk", [None, 0, 1])
@pytest.mark.parametrize("b,sq,sk,h", SHAPES)
def test_persistent_walk_visits_every_item_once(b, sq, sk, h, walk):
    plan = tfa._bf16_plan(b, sq, sk, h, 128)
    q_tiles = -(-sq // 128)
    assert plan.items == b * h * q_tiles
    if plan.route == 0:
        assert plan.grid == plan.items
        return
    plan = tfa._bf16_plan(b, sq, sk, h, 128, walk=walk)
    assert plan.grid == min(plan.items, 132)
    seen = {}
    for block in range(plan.grid):
        items = block_items(plan, block, b, sq, h)
        # an equal share of the items: the counts differ by one at most
        assert abs(len(items) - plan.items / plan.grid) < 1
        for it in items:
            seen[it] = seen.get(it, 0) + 1
        heads = [bb * h + hh for bb, hh, _ in items]
        if plan.walk == 0:
            # head by head: a contiguous run, so a block meets at most
            # ceil(len / q_tiles) + 1 heads, each once
            assert heads == sorted(heads)
            assert len(set(heads)) <= -(-len(items) // q_tiles) + 1
        else:
            # heads fastest: block x takes every grid-th item numbered (b,
            # query tile, h) from x, so the blocks in flight at a step take
            # consecutive items, every head of the same tokens
            idx = [(bb * q_tiles + t) * h + hh for bb, hh, t in items]
            assert idx == list(range(block, plan.items, plan.grid))
    assert len(seen) == plan.items and set(seen.values()) == {1}
    assert all(0 <= bb < b and 0 <= hh < h and 0 <= t < q_tiles
               for bb, hh, t in seen)


def test_variant_choice():
    """Walk 1 (heads fastest) where K / V sit in two resident buffers; walk
    0 (head by head) where one resident buffer would be reloaded at every
    change of head and where K / V stream; a walk the kernel does not have
    raises."""
    audio = tfa._bf16_plan(23, 1560, 32, 32, 128)
    clip = tfa._bf16_plan(1, 20280, 257, 40, 128)
    text = tfa._bf16_plan(1, 20280, 512, 40, 128)
    assert (audio.walk, clip.walk, text.walk) == (1, 0, 0)
    with pytest.raises(ValueError, match="no walk 2"):
        tfa._bf16_plan(1, 20280, 257, 40, 128, walk=2)
    with pytest.raises(ValueError, match="route 0 has walk 0"):
        tfa._bf16_plan(1, 20280, 20280, 40, 128, walk=1)


Q_BYTES = 128 * 256          # one Q buffer: 128 rows of 128 bf16
BARS = 16                    # the two mbarriers of a Q or K / V buffer


@pytest.mark.parametrize("sk", KEYS)
def test_kv_resident_only_where_it_fits(sk):
    plan = tfa._bf16_plan(1, 20280, sk, 40, 128, route=1)
    padded = sum(plan.key_tiles)
    buffers = plan.q_bufs * Q_BYTES + plan.kv_bufs * plan.kv_unit_bytes
    # the buffers (and mbarriers and alignment) within 227 KB
    assert buffers < plan.smem_bytes <= SMEM_LIMIT
    assert 2 <= plan.q_bufs <= 4
    if plan.resident:
        # K and V of every tile of a head, 256 bytes a key row each
        assert plan.kv_unit_bytes == 2 * padded * 256
        assert plan.kv_bufs in (1, 2)
        # no more Q buffers, then no second K / V buffer, would fit
        if plan.q_bufs < 4:
            assert plan.smem_bytes + Q_BYTES + BARS > SMEM_LIMIT
        if plan.kv_bufs == 1:
            assert plan.smem_bytes + plan.kv_unit_bytes + BARS > SMEM_LIMIT
    else:
        # a head's K / V do not fit beside two Q buffers: a ring of two
        # 128-key stages
        assert 2 * Q_BYTES + 2 * padded * 256 > SMEM_LIMIT - 1024
        assert (plan.kv_bufs, plan.kv_unit_bytes) == (2, 2 * 128 * 256)
    assert plan.resident == (padded <= 320)
    assert plan.walk == int(plan.resident and plan.kv_bufs == 2)


def test_route_by_key_count():
    """The short route takes the cross-attention runs at head dim 128 (at
    least 32, 64, 257, 512 and 514 keys); 20,280 keys (the self-attention)
    and head dim 64 take the long-row loop, whose shared memory is the
    loop's Layout: Q and two stages of K and V, 40 bytes of mbarriers and 1
    KB of alignment."""
    for sk in (1, 32, 64, 257, 512, 514, 1560, tfa._SHORT_BF16_KEYS):
        assert tfa._bf16_plan(1, 20280, sk, 40, 128).route == 1, sk
    for sk in (tfa._SHORT_BF16_KEYS + 1, 20280):
        plan = tfa._bf16_plan(1, 20280, sk, 40, 128)
        assert plan.route == 0 and not plan.resident
        assert plan.smem_bytes == 5 * 128 * 256 + 40 + 1024 == 164904
    assert tfa._bf16_plan(1, 20280, 512, 40, 64).route == 0
    assert tfa._bf16_plan(1, 64, 64, 1, 64).smem_bytes == 82984
    # pinned: CLIP resident in one buffer beside two Q buffers, the text
    # streamed beside three, the avatar's 32 keys in two buffers beside four
    clip = tfa._bf16_plan(1, 20280, 257, 40, 128)
    assert (clip.key_tiles, clip.resident, clip.kv_bufs, clip.q_bufs,
            clip.smem_bytes, clip.grid) == ((128, 128, 16), True, 1, 2,
                                            205872, 132)
    text = tfa._bf16_plan(1, 20280, 512, 40, 128)
    assert (text.key_tiles, text.resident, text.kv_bufs, text.q_bufs,
            text.smem_bytes) == ((128,) * 4, False, 2, 3, 230480)
    audio = tfa._bf16_plan(23, 1560, 32, 32, 128)
    assert (audio.key_tiles, audio.resident, audio.kv_bufs, audio.q_bufs,
            audio.items) == ((32,), True, 2, 4, 9568)


def test_bad_plans_raise():
    with pytest.raises(ValueError, match="no route 1 at head dim 64"):
        tfa._bf16_plan(1, 64, 64, 1, 64, route=1)
    with pytest.raises(ValueError, match="no route 2"):
        tfa._bf16_plan(1, 64, 64, 1, 128, route=2)
    with pytest.raises(ValueError, match="no route 1 at head dim 128 and 0"):
        tfa._bf16_plan(1, 64, 0, 1, 128, route=1)
    with pytest.raises(ValueError, match="head dim 80"):
        tfa._bf16_plan(1, 64, 64, 1, 80)


# ------------------------------------------------------------ the arithmetic


def tiled_attention(q, k, v, plan, *, kv_lens=None, scale=None):
    """The short kernel's arithmetic in plain PyTorch: an online softmax
    over ``plan``'s key tiles (tiles wholly past a row's kv_len skipped,
    keys past it masked), fp32 m / l / accumulator, P rounded to bf16
    before each tile's P.V, one division by l at the end; returns o (bf16)
    and m, l [B, H, Sq]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale or 1.0 / math.sqrt(d)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 3, 1)
    vf = v.float().permute(0, 2, 1, 3)
    lens = (torch.full((b,), sk) if kv_lens is None else
            kv_lens.clamp(0, sk)).long()
    o = torch.zeros((b, h, sq, d))
    m = torch.full((b, h, sq, 1), tfa.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    for start, w in _tiles(plan, sk):
        keys = torch.arange(start, start + w)
        live = start < lens                                    # [B]
        valid = (keys[None, :] < lens[:, None]) & (keys[None, :] < sk)
        kt = torch.zeros((b, h, d, w))
        vt = torch.zeros((b, h, w, d))
        n = min(w, sk - start)
        kt[..., :n] = kf[..., start:start + n]
        vt[:, :, :n] = vf[:, :, start:start + n]
        s = qf @ kt
        s = torch.where(valid[:, None, None, :], s, torch.full_like(
            s, tfa.NEG_INF))
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * scale)
        p = torch.exp(s * scale - mn)
        p = torch.where(valid[:, None, None, :], p, torch.zeros_like(p))
        alpha = torch.exp(m - mn)
        keep = live[:, None, None, None]
        l = torch.where(keep, alpha * l + p.sum(-1, keepdim=True), l)
        o = torch.where(keep, alpha * o + p.bfloat16().float() @ vt, o)
        m = torch.where(keep, mn, m)
    o = o * torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    return (o.permute(0, 2, 1, 3).bfloat16(), m[..., 0], l[..., 0])


@pytest.mark.parametrize("sk,kv_lens", [
    (17, (17, 9, 0)), (129, (129, 100, 0)), (257, (257, 1, 0)),
    (32, (32, 17, 0)), (514, (514, 300, 0))])
def test_tiled_model_matches_plain_and_jax(sk, kv_lens):
    """The tiled arithmetic on the plan's tiles gives the plain version's
    function (bf16 rounding of P apart) and JAX's reference for the rows
    with keys; a kv_len = 0 row is zeros with m = -1e30 and l = 0."""
    rng = np.random.default_rng(sk)
    b, sq, h, d = 3, 70, 2, 128
    qn, kn, vn = (rng.standard_normal(s).astype(np.float32) for s in
                  ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
    q, k, v = (torch.from_numpy(x).bfloat16() for x in (qn, kn, vn))
    lens = torch.tensor(kv_lens, dtype=torch.int32)
    plan = tfa._bf16_plan(b, sq, sk, h, d)
    assert plan.route == 1
    o, m, l = tiled_attention(q, k, v, plan, kv_lens=lens)
    ro, rm, rl = tfa.flash_attention_plain(q, k, v, kv_lens=lens,
                                           return_lse=True)
    live = lens > 0
    assert (o[~live] == 0).all() and (m[~live] == tfa.NEG_INF).all()
    assert (l[~live] == 0).all()
    err = (o[live].float() - ro[live].float()).abs().max()
    assert err <= 2e-2 * ro[live].float().abs().max()
    assert torch.allclose(m[live], rm[live], rtol=1e-5, atol=1e-5)
    assert torch.allclose(l[live], rl[live], rtol=1e-4)
    ref = np.asarray(sdpa_reference(
        jnp.asarray(q.float().numpy()), jnp.asarray(k.float().numpy()),
        jnp.asarray(v.float().numpy()),
        kv_lens=jnp.asarray(np.asarray(kv_lens, dtype=np.int32))))
    want = ref[live.numpy()]
    got = o[live].float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
