"""Kernel 1's fp32 path without a card: the host-side plan of the forward
kernel (``_fwd_plan`` in ``worldforge_tpu_torch/ops/flash_attention.py``),
and models of the kernel written out in plain PyTorch here: the 3xTF32
arithmetic (``tf32_split``, ``attention_3xtf32``), the two passes of head
dims 384 and 512 with their chunk loop (``attention_two_pass``) and the key
order of its V^T planes (``vt_key_order``). These models check the design,
not the kernel: the CUDA kernels, and with them the key order the splitter
writes, are held against ``flash_attention_plain`` only by
``chip_smoke.py`` on the H100."""

from __future__ import annotations

import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.ops.attention import sdpa_reference
from worldforge_tpu_torch.ops import flash_attention as tfa

HEAD_DIMS = (64, 80, 128, 384, 512)

# (B, Sq, Sk, H): the rows kernel 1 runs in fp32 on the main paths, ragged
# rows, and more than 65,535 B*H rows (gridDim.y's limit)
SHAPES = [
    (110, 6656, 6656, 5),      # SVD UNet spatial, level 1
    (110, 1664, 1664, 10),     # level 2
    (110, 416, 416, 20),       # level 3
    (6656, 110, 110, 5),       # SVD UNet temporal
    (110, 6656, 1, 5),         # SVD UNet cross-attention to 1 token
    (1, 10992, 10992, 16),     # VGGT-1B global attention, 8 x 518^2
    (8, 1374, 1374, 16),       # VGGT-1B frame attention
    (8, 6656, 6656, 1),        # SVD VAE mid
    (5, 6240, 6240, 1),        # Wan2.1 VAE mid, 480 x 832
    (1, 14080, 14080, 1),      # Wan2.1 VAE mid, 704 x 1280
    (24, 6240, 6240, 1),       # Wan2.1 VAE mid, the avatar's 93-frame decode
    (1, 257, 257, 16),         # CLIP-H
    (1, 1, 1, 16),             # VGGT camera trunk, S = 1
    (2, 333, 333, 2),          # ragged query and key tiles
    (3, 200, 300, 2),
    (2, 130, 200, 3),
    (70000, 16, 16, 1),        # B*H > 65,535
    (81920, 8, 8, 1),          # the 1024 x 1024 temporal attention
]


def _variants(d):
    return (0, 1) if d == 64 else (0,)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("b,sq,sk,h", SHAPES)
def test_fwd_plan_fits_and_covers(b, sq, sk, h, d):
    if d in (384, 512):
        _two_pass_plan_fits_and_covers(b, sq, sk, h, d)
        return
    for variant in (None, *_variants(d)):
        plan = tfa._fwd_plan(b, sq, sk, h, d, variant)
        assert plan.smem_bytes <= 232448        # the H100's 227 KB a block
        assert (plan.chunk_tiles, plan.chunks, plan.scratch_bytes,
                plan.passes) == (0, 1, 0, 1)
        # every query in exactly one block of its (batch, head) row: the
        # blocks' tiles cover the rows with less than one tile to spare
        q_tiles, rest = divmod(plan.blocks, b * h)
        assert rest == 0 and plan.blocks < 2 ** 31
        assert (q_tiles - 1) * plan.rows < sq <= q_tiles * plan.rows
        assert plan.threads % 128 == 0 and plan.stages >= 1
        if d in (64, 80, 128):
            # one producer / splitter warpgroup and a consumer warpgroup a
            # 64-row slice; a ring of two stages; whole 32-key panels of the
            # 128-byte swizzled V^T planes
            assert plan.threads == 128 + 2 * plan.rows
            assert plan.rows % 64 == 0 and plan.stages >= 2
            assert plan.key_tile % 32 == 0
            assert d * plan.key_tile * 4 % 1024 == 0


def _two_pass_plan_fits_and_covers(b, sq, sk, h, d):
    """The two-pass route (d 384 / 512): both kernels fit 227 KB; every
    query row falls in exactly one 128-row tile and every tile in exactly
    one chunk (the chunks cover the b * h * tiles with less than a chunk to
    spare, the last one possibly shorter); the scratch holds a chunk's
    scores and partials and stays within 256 MiB; two launches a chunk."""
    plan = tfa._fwd_plan(b, sq, sk, h, d)
    assert plan.smem_bytes <= 232448 and plan.score_smem_bytes <= 232448
    assert plan.threads == 384 and plan.rows == 128
    q_tiles = -(-sq // plan.rows)
    assert (q_tiles - 1) * plan.rows < sq <= q_tiles * plan.rows
    n_tiles = q_tiles * b * h
    assert 1 <= plan.chunk_tiles <= n_tiles
    assert (plan.chunks - 1) * plan.chunk_tiles < n_tiles
    assert n_tiles <= plan.chunks * plan.chunk_tiles
    key_tiles = -(-sk // plan.score_tile)
    assert plan.scratch_bytes == plan.chunk_tiles * plan.rows * key_tiles * (
        plan.score_tile * 4 + 8)
    assert plan.scratch_bytes <= 256 << 20
    assert plan.passes == 2 * plan.chunks
    assert plan.blocks == plan.chunk_tiles * max(key_tiles, d // 128)
    assert plan.blocks < 2 ** 31
    # a chunk and the 32-key stages of pass 2 fall on whole pass-1 tiles
    assert plan.score_tile % plan.key_tile == 0


def test_fwd_plan_layouts():
    """The numbers ``csrc/attention_f32_plan.cuh`` gives the host through
    ``csrc/flash_plan.cpp``: those ``csrc/attention_f32_wide_sm90.cuh``
    lays its passes out by, and those ``csrc/flash_attention.cu`` holds the
    one-pass kernels of ``csrc/attention_f32_sm90.cuh`` to."""
    want = {(64, 0): (128, 64, 2, 384, 197712, 0, 0, 0),
            (64, 1): (64, 32, 2, 256, 99408, 0, 0, 0),
            (80, 0): (128, 32, 2, 384, 144464, 0, 0, 0),
            (128, 0): (64, 32, 2, 256, 197712, 0, 0, 0),
            # pass 2: 3 stages of S, V raw, V^T hi / lo (4 x 16 KB); pass
            # 1: 4 stages of Q raw, K hi / lo (3 x 16 KB); 3 mbarriers a
            # stage; 1 KB of alignment
            (384, 0): (128, 32, 3, 384, 197704, 128, 4, 197728),
            (512, 0): (128, 32, 3, 384, 197704, 128, 4, 197728)}
    for (d, variant), plan in want.items():
        got = tfa._fwd_plan(4, 1000, 1000, 2, d, variant)
        assert (got.rows, got.key_tile, got.stages, got.threads,
                got.smem_bytes, got.score_tile, got.score_stages,
                got.score_smem_bytes) == plan
    # the main shapes' chunks on the H100's 132 SMs: the fewest waves of
    # both passes within the 256 MiB cap (pass 2's 1,664 blocks at d 512
    # in 13 waves, the fewest there can be: 6 chunks of 66 tiles x 4
    # column blocks, then 20 tiles; d 384's 735 in 6)
    d512 = tfa._fwd_plan(8, 6656, 6656, 1, 512)
    assert (d512.chunk_tiles, d512.chunks, d512.passes) == (66, 7, 14)
    d384 = tfa._fwd_plan(5, 6240, 6240, 1, 384)
    assert (d384.chunk_tiles, d384.chunks) == (43, 6)
    refine = tfa._fwd_plan(1, 14080, 14080, 1, 384)
    assert refine.chunks == 4 and refine.scratch_bytes <= 256 << 20
    # two short-variant blocks share an SM at d 64 (228 KB an SM, 1 KB of
    # it reserved a block)
    assert 2 * (tfa._fwd_plan(1, 1, 1, 1, 64, 1).smem_bytes + 1024) <= 233472


def test_fwd_variant_choice():
    long_rows = [(110, 6656, 6656, 5, 64), (1, 10992, 10992, 16, 64),
                 (8, 1374, 1374, 16, 64), (110, 1664, 1664, 10, 64),
                 (110, 416, 416, 20, 64), (6656, 110, 110, 5, 64),
                 (1, 257, 257, 16, 80)]
    short_rows = [(110, 6656, 1, 5, 64), (70000, 16, 16, 1, 64),
                  (81920, 8, 8, 1, 64)]
    for s in long_rows:
        assert tfa._fwd_plan(*s).variant == 0, s
    for s in short_rows:
        assert tfa._fwd_plan(*s).variant == 1, s
    assert tfa._fwd_plan(1, 1, 1, 16, 128).variant == 0
    for d, variant in ((80, 1), (128, 1), (384, 1), (512, 1), (64, 2)):
        with pytest.raises(ValueError, match="no variant"):
            tfa._fwd_plan(1, 64, 64, 1, d, variant)
    # a chunk is a two-pass notion, of at least one query tile
    with pytest.raises(ValueError, match="no chunks"):
        tfa._fwd_plan(1, 64, 64, 1, 64, chunk_tiles=1)
    with pytest.raises(ValueError, match="at least one query tile"):
        tfa._fwd_plan(1, 64, 64, 1, 512, chunk_tiles=0)
    with pytest.raises(ValueError, match="head dim 96"):
        tfa._fwd_plan(1, 64, 64, 1, 96)


def test_wrapper_refuses_before_any_launch():
    q = torch.zeros((1, 8, 1, 96))
    with pytest.raises(ValueError, match="no instantiation"):
        tfa._launch(q, q, q, None, 0.1, False)
    q = torch.zeros((1, 8, 1, 64))
    with pytest.raises(ValueError, match="share a dtype"):
        tfa._launch(q, q.double(), q, None, 0.1, False)


# ------------------------------------------------------------ 3xTF32


def tf32_split(x: torch.Tensor):
    """fp32 ``x`` as ``hi + lo``, both TF32 (10 mantissa bits), each rounded
    to nearest with ties away from zero as ``cvt.rna.tf32.f32`` rounds: add
    half of the dropped 13 bits' range to the magnitude, then clear them.
    ``lo`` is the rest ``x - hi`` (exact in fp32) rounded again, so ``hi +
    lo`` is within 2^-22 of ``x`` relative."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF        # the sign bit is untouched
        out = bits.view(torch.float32)
        return torch.where(torch.isfinite(t), out, t)
    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def _matmul_3xtf32(a, b, products=3):
    """``a @ b`` from TF32 halves: hi.hi + hi.lo + lo.hi (``products`` 3),
    lo.lo dropped as the kernel drops it; ``products`` 1 is one TF32 pass,
    hi.hi alone. Each product of two TF32 values is exact in fp32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if products == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def attention_3xtf32(q, k, v, *, kv_lens=None, scale=None, products=3):
    """fp32 attention with both products computed as the fp32 kernel
    computes them (``products`` 3: three TF32 products of the split
    operands; 1: one TF32 pass), the softmax in fp32. q [B, Sq, H, D], k/v
    [B, Sk, H, D] fp32; masking and ``kv_len = 0`` rows as
    ``flash_attention_plain``. The sums run in another order than on the
    tensor cores, which also truncate as they add: this models the split,
    not the hardware's additions."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qt = q.float().permute(0, 2, 1, 3)                    # [B, H, Sq, D]
    kt = k.float().permute(0, 2, 3, 1)                    # [B, H, D, Sk]
    vt = v.float().permute(0, 2, 1, 3)                    # [B, H, Sk, D]
    s = _matmul_3xtf32(qt, kt, products) * scale
    valid = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    if kv_lens is not None:
        kl = kv_lens.to(device=q.device, dtype=torch.int64)
        valid = torch.arange(sk, device=q.device)[None, :] < kl[:, None]
    mask = valid[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, tfa.NEG_INF))
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = _matmul_3xtf32(p, vt, products)
    o = o * torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    return o.permute(0, 2, 1, 3)



def _rna_reference(x: np.ndarray) -> np.ndarray:
    """TF32 rounding of fp32 ``x`` (normal numbers), to nearest with ties
    away from zero, in float64 arithmetic: a multiple of 2^(e - 10) for
    2^e <= |x| < 2^(e + 1)."""
    x64 = x.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ulp = np.exp2(np.floor(np.log2(np.abs(x64))) - 10)
        mag = np.floor(np.abs(x64) / ulp + 0.5) * ulp
    return np.where(x64 == 0, 0.0, np.sign(x64) * mag).astype(np.float32)


def test_tf32_split_rounds_to_nearest_ties_away(rng):
    x = rng.standard_normal(20000).astype(np.float32) * np.float32(1e3)
    # exact ties (the dropped 13 bits are 0x1000) and their neighbours
    bits = rng.integers(0x3F800000, 0x4F000000, 3000, dtype=np.uint32)
    ties = ((bits & ~np.uint32(0x1FFF)) | np.uint32(0x1000)).view(np.float32)
    near = ((bits & ~np.uint32(0x1FFF)) | np.uint32(0x0FFF)).view(np.float32)
    x = np.concatenate([x, ties, -ties, near, -near])
    hi, lo = tf32_split(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    np.testing.assert_array_equal(hi, _rna_reference(x))
    np.testing.assert_array_equal(lo[lo != 0],
                                  _rna_reference(x - hi)[lo != 0])
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()   # 10 mantissa bits
    # ties go away from zero
    np.testing.assert_array_equal(np.abs(hi[20000:23000]) > np.abs(ties),
                                  True)
    rest = np.abs(x.astype(np.float64) - hi - lo)
    assert (rest <= 2.0 ** -21 * np.abs(x)).all()


def _qkv(rng, b, sq, sk, h, d, scale=1.0):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                             * np.float32(scale))
            for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))]


def _max_rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


def _exact(q, k, v, kv_lens):
    """The attention in float64: the yardstick of both fp32 versions."""
    q, k, v = (x.double().permute(0, 2, 1, 3) for x in (q, k, v))
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if kv_lens is not None:
        mask = torch.arange(s.shape[-1])[None, :] < kv_lens[:, None]
        s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    p = torch.nan_to_num(torch.softmax(s, -1))
    return (p @ v).permute(0, 2, 1, 3)


def _rel_l2(out, ref):
    return float((out.double() - ref.double()).norm() / ref.double().norm())


@pytest.mark.parametrize("d,kv_lens", [(64, (160, 77)), (80, None),
                                       (128, (160, 0))])
def test_3xtf32_attention_matches_fp32(rng, d, kv_lens):
    """Three TF32 products keep fp32 accuracy. On unit inputs the 3xTF32
    version is within 1e-6 of ``flash_attention_plain`` in relative L2 and
    within 4e-6 of the largest output: the plain version, an fp32
    computation in another order, is itself up to ~1.1e-6 of the largest
    output from the float64 result at these shapes, so the two meet at
    fp32's noise; against float64 the 3xTF32 error is at most twice the
    plain version's plus 1e-7. On inputs x8 (scores 64x larger) it stays
    within the card's 1e-4 gate, where one TF32 pass misses it."""
    kl = None if kv_lens is None else torch.tensor(kv_lens)
    q, k, v = _qkv(rng, 2, 96, 160, 2, d)
    ref = tfa.flash_attention_plain(q, k, v, kv_lens=kl)
    got = attention_3xtf32(q, k, v, kv_lens=kl)
    exact = _exact(q, k, v, kl)
    top = float(exact.abs().max())
    err = float((got.double() - exact).abs().max()) / top
    plain_err = float((ref.double() - exact).abs().max()) / top
    # which side moved, should either fail: both errors from float64
    seen = f"3xTF32 {err:.3g}, plain {plain_err:.3g} of the largest output"
    assert _rel_l2(got, ref) <= 1e-6, seen
    assert _max_rel(got, ref) <= 4e-6, seen
    assert err <= 2 * plain_err + 1e-7
    if kv_lens is not None and 0 in kv_lens:
        assert not got[kv_lens.index(0)].any()
    q, k, v = (x * 8 for x in (q, k, v))
    ref = tfa.flash_attention_plain(q, k, v, kv_lens=kl)
    assert _max_rel(attention_3xtf32(q, k, v, kv_lens=kl), ref) <= 1e-4
    one_pass = attention_3xtf32(q, k, v, kv_lens=kl, products=1)
    assert _max_rel(one_pass, ref) > 1e-4


def test_3xtf32_attention_matches_jax_reference(rng):
    """The same arithmetic against the JAX package's fp32 reference
    (``ops/attention.py::sdpa_reference``) on the same inputs."""
    q, k, v = _qkv(rng, 2, 70, 90, 2, 64)
    kl = np.array([90, 41], np.int32)
    want = sdpa_reference(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                          kv_lens=jnp.asarray(kl))
    got = attention_3xtf32(q, k, v, kv_lens=torch.from_numpy(kl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=1e-5)


# ------------------------------------------------------------ two passes


def attention_two_pass(q, k, v, *, kv_lens=None, scale=None, chunk_tiles=None,
                       products=3):
    """Head dims 384 / 512 as ``csrc/attention_f32_wide_sm90.cuh`` computes
    them, in plain PyTorch: the call cut into chunks of ``chunk_tiles``
    128-row query tiles, numbered flat over (b * h, tile) (default: one
    chunk); per chunk, pass 1 writes each (tile, 128-key tile)'s scores S =
    scale Q.K^T (summed one 32-float depth stage at a time, the stages added
    in fp32; keys at or past kv_len -1e30, key tiles wholly past it
    skipped) and each row's max and sum of exp over the tile; pass 2 merges
    a row's (max, sum) pairs into m and l, then adds each 32-key tile's
    exp(S - m).V (masked keys 0) into O in fp32 and divides by l (0 where l
    is 0). Every product is ``_matmul_3xtf32``'s (``products`` 1: one TF32
    pass). Ragged tiles are zero-padded, as TMA fills them. Returns o [B,
    Sq, H, D] and m, l [B, H, Sq]. The sums run in another order than on the
    tensor cores: this models the passes, the chunks and the split, not the
    hardware's additions."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rows, score_keys, keys, depth = 128, 128, 32, 32
    q_tiles = -(-sq // rows)
    nkt = max(1, -(-sk // score_keys))
    n_tiles = q_tiles * b * h

    def pad(x, n):
        out = torch.zeros((b * h, n, d), dtype=torch.float32)
        out[:, :x.shape[1]] = x.float().permute(0, 2, 1, 3).reshape(
            b * h, x.shape[1], d)
        return out

    qp, kp, vp = pad(q, q_tiles * rows), pad(k, nkt * score_keys), pad(
        v, nkt * score_keys)
    kl = (torch.full((b,), sk) if kv_lens is None
          else kv_lens.to(torch.int64).clamp(0, sk))
    o = torch.zeros((b * h, q_tiles * rows, d))
    m = torch.full((b * h, q_tiles * rows), tfa.NEG_INF)
    l = torch.zeros((b * h, q_tiles * rows))
    chunk_tiles = chunk_tiles or n_tiles
    for t0 in range(0, n_tiles, chunk_tiles):
        tiles = range(t0, min(t0 + chunk_tiles, n_tiles))
        s_all = torch.full((len(tiles), rows, nkt * score_keys), math.nan)
        parts = torch.full((len(tiles), rows, nkt, 2), math.nan)
        for i, tile in enumerate(tiles):            # pass 1
            bh, qi = divmod(tile, q_tiles)
            kv_len = int(kl[bh // h])
            qt = qp[bh, qi * rows:(qi + 1) * rows]
            for kt in range(nkt):
                k0 = kt * score_keys
                if k0 >= kv_len:
                    continue
                kt_ = kp[bh, k0:k0 + score_keys]
                s = torch.zeros((rows, score_keys))
                for c in range(0, d, depth):
                    s = s + _matmul_3xtf32(qt[:, c:c + depth],
                                           kt_[:, c:c + depth].T, products)
                s = s * scale
                s[:, torch.arange(score_keys) >= kv_len - k0] = tfa.NEG_INF
                mj = s.amax(dim=-1)
                s_all[i, :, k0:k0 + score_keys] = s
                parts[i, :, kt, 0] = mj
                parts[i, :, kt, 1] = torch.exp(s - mj[:, None]).sum(dim=-1)
        for i, tile in enumerate(tiles):            # pass 2
            bh, qi = divmod(tile, q_tiles)
            kv_len = int(kl[bh // h])
            mm = torch.full((rows,), tfa.NEG_INF)
            ll = torch.zeros(rows)
            for kt in range(-(-kv_len // score_keys)):
                mj, lj = parts[i, :, kt, 0], parts[i, :, kt, 1]
                mn = torch.maximum(mm, mj)
                ll = ll * torch.exp(mm - mn) + lj * torch.exp(mj - mn)
                mm = mn
            acc = torch.zeros((rows, d))
            for k0 in range(0, kv_len, keys):
                st = s_all[i, :, k0:k0 + keys]
                valid = (torch.arange(keys) < kv_len - k0)[None, :]
                p = torch.where(valid, torch.exp(st - mm[:, None]),
                                torch.zeros_like(st))
                acc = acc + _matmul_3xtf32(p, vp[bh, k0:k0 + keys], products)
            inv = torch.where(ll == 0, torch.zeros_like(ll), 1.0 / ll)
            o[bh, qi * rows:(qi + 1) * rows] = acc * inv[:, None]
            m[bh, qi * rows:(qi + 1) * rows] = mm
            l[bh, qi * rows:(qi + 1) * rows] = ll
    o = o[:, :sq].reshape(b, h, sq, d).permute(0, 2, 1, 3)
    return o, m[:, :sq].reshape(b, h, sq), l[:, :sq].reshape(b, h, sq)


# B 3 x two 128-row tiles (200 rows: a ragged last tile), 300 keys (three
# pass-1 tiles, the last ragged), kv_lens full, ragged and 0; chunks of 4
# tiles: the first spans two batch rows, the last holds two (ragged)
TWO_PASS = dict(b=3, sq=200, sk=300, h=1, kv_lens=(300, 77, 0),
                chunk_tiles=4)


@pytest.fixture(scope="module", params=(384, 512))
def two_pass_case(request):
    """Inputs, kv_lens and the model's outputs on them, at unit scale and
    x8, for head dim 384 and 512 (seeded apart from the ``rng``
    fixture)."""
    d, c = request.param, TWO_PASS
    gen = np.random.default_rng(d)
    q, k, v = _qkv(gen, c["b"], c["sq"], c["sk"], c["h"], d)
    kl = torch.tensor(c["kv_lens"])
    out = {"d": d, "kl": kl, "qkv": (q, k, v)}
    out["model"] = attention_two_pass(q, k, v, kv_lens=kl,
                                      chunk_tiles=c["chunk_tiles"])
    q8, k8, v8 = (x * 8 for x in (q, k, v))
    out["qkv8"] = (q8, k8, v8)
    out["model8"] = attention_two_pass(q8, k8, v8, kv_lens=kl,
                                       chunk_tiles=c["chunk_tiles"])
    out["one_pass8"] = attention_two_pass(q8, k8, v8, kv_lens=kl,
                                          chunk_tiles=c["chunk_tiles"],
                                          products=1)
    return out


def test_two_pass_matches_plain_and_float64(two_pass_case):
    """The two passes keep fp32 accuracy, with the gates of
    ``test_3xtf32_attention_matches_fp32``: within 1e-6 of
    ``flash_attention_plain`` in relative L2 and 4e-6 of the largest output,
    and against float64 at most twice the plain version's error plus 1e-7;
    m and l as the plain version gives them; the kv_len = 0 row exactly
    zero with m = -1e30 and l = 0."""
    c = two_pass_case
    q, k, v = c["qkv"]
    kl = c["kl"]
    o, m, l = c["model"]
    ro, rm, rl = tfa.flash_attention_plain(q, k, v, kv_lens=kl,
                                           return_lse=True)
    live = kl > 0
    exact = _exact(q, k, v, kl)[live]
    top = float(exact.abs().max())
    err = float((o[live].double() - exact).abs().max()) / top
    plain_err = float((ro[live].double() - exact).abs().max()) / top
    seen = f"two-pass {err:.3g}, plain {plain_err:.3g} of the largest output"
    assert _rel_l2(o[live], ro[live]) <= 1e-6, seen
    assert _max_rel(o[live], ro[live]) <= 4e-6, seen
    assert err <= 2 * plain_err + 1e-7, seen
    assert float(((m[live] - rm[live]).abs() / (1 + rm[live].abs())).max()) \
        <= 1e-6
    assert float(((l[live] - rl[live]).abs() / rl[live]).max()) <= 1e-5
    assert not o[~live].any()
    assert (m[~live] == tfa.NEG_INF).all() and not l[~live].any()


def test_two_pass_matches_jax_reference(two_pass_case):
    """The same arithmetic against the JAX package's fp32 reference
    (``ops/attention.py::sdpa_reference``) on the same inputs, on the rows
    with keys (a kv_len = 0 row gives the mean of V there, zeros here)."""
    c = two_pass_case
    q, k, v = c["qkv"]
    kl = c["kl"].numpy().astype(np.int32)
    want = np.asarray(sdpa_reference(*(jnp.asarray(x.numpy())
                                       for x in (q, k, v)),
                                     kv_lens=jnp.asarray(kl)))
    live = kl > 0
    np.testing.assert_allclose(c["model"][0].numpy()[live], want[live],
                               atol=2e-6, rtol=1e-5)


def test_two_pass_inputs_x8(two_pass_case):
    """On inputs x8 (scores 64x larger) the two passes stay within the
    card's 1e-4 gate against float64 (``chip_smoke.py``'s precision
    check), where one TF32 pass misses it."""
    c = two_pass_case
    q, k, v = c["qkv8"]
    kl = c["kl"]
    live = kl > 0
    exact = _exact(q, k, v, kl)[live]
    top = float(exact.abs().max())

    def err(x):
        return float((x[live].double() - exact).abs().max()) / top

    assert err(c["model8"][0]) <= 1e-4
    assert err(c["one_pass8"][0]) > 1e-4


def test_two_pass_chunks_change_nothing(rng):
    """Each tile's arithmetic does not depend on the chunk it falls in: one
    tile a chunk, a ragged cut and the whole call in one chunk give the same
    bits, m and l too."""
    q, k, v = _qkv(rng, 2, 300, 140, 1, 384)
    kl = torch.tensor([140, 33])
    whole = attention_two_pass(q, k, v, kv_lens=kl)
    for tiles in (1, 4):
        cut = attention_two_pass(q, k, v, kv_lens=kl, chunk_tiles=tiles)
        for a, b in zip(cut, whole):
            assert torch.equal(a, b)


# ------------------------------------------------------------ V^T key order


def vt_key_order(keys: int) -> torch.Tensor:
    """The order in which the fp32 kernel's V^T planes hold a tile's keys:
    within each 8-key step 0 2 4 6 1 3 5 7 (``write_vt`` in
    ``csrc/attention_f32_sm90.cuh`` writes it). The S accumulator gives a
    thread keys 2t and 2t + 1 of a step where wgmma's A fragment reads
    k-columns t and t + 4, so P enters O += P.V from its registers as it
    is, and V^T's k-column c holds key ``vt_key_order(keys)[c]``."""
    step = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    return (torch.arange(0, keys, 8)[:, None] + step[None, :]).reshape(-1)



def test_vt_key_order_leaves_pv_unchanged(rng):
    order = vt_key_order(64)
    assert sorted(order.tolist()) == list(range(64))
    p = torch.from_numpy(rng.random((3, 16, 64)))
    v = torch.from_numpy(rng.standard_normal((3, 64, 24)))
    torch.testing.assert_close(p[..., order] @ v[:, order], p @ v,
                               rtol=1e-12, atol=1e-12)


def test_vt_key_order_matches_the_fragments():
    """Where the kernel's registers put each score: S's wgmma accumulator
    gives thread (warp w, lane) of a warpgroup rows 16w + lane/4 (+ 8) at
    keys 8j + 2(lane%4) (+ 1) in registers 4j + e; the TF32 A fragment of
    k-step j reads rows 16w + lane/4 (+ 8) at k-columns 8j + lane%4 (+ 4)
    from registers 0..3. The kernel passes S's registers (4j, 4j+2, 4j+1,
    4j+3) as the fragment, so every k-column c must be V^T's key
    ``vt_key_order[c]``; the splitter writes 16-byte chunks of keys 8j +
    (0, 2, 4, 6) and 8j + (1, 3, 5, 7) at k-columns 8j .. 8j + 7. This
    replays the fragment layouts in Python; that the kernel writes this
    order is shown only on the card, by ``chip_smoke.py``'s checks against
    the plain version."""
    keys = 64
    order = vt_key_order(keys).tolist()
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            acc = {4 * j + e: (16 * w + g + 8 * (e >> 1), 8 * j + 2 * t
                               + (e & 1))
                   for j in range(keys // 8) for e in range(4)}
            for j in range(keys // 8):
                regs = (4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3)
                for i, reg in enumerate(regs):
                    row, key = acc[reg]
                    assert row == 16 * w + g + 8 * (i & 1)
                    col = 8 * j + t + 4 * (i >> 1)
                    assert order[col] == key
    for j in range(keys // 8):
        assert order[8 * j:8 * j + 4] == [8 * j + k for k in (0, 2, 4, 6)]
        assert order[8 * j + 4:8 * j + 8] == [8 * j + k for k in (1, 3, 5, 7)]


def test_f32_plan_export_refuses_what_the_kernel_lacks():
    """``wf_flash_f32_plan`` gives no plan where the entry point refuses:
    a head dim or variant with no instantiation, a chunk at a one-pass head
    dim, a two-pass chunk of no tiles; the scratch of a two-pass chunk
    grows with its tiles, in 64 bits past 2 GiB."""
    lib = tfa._plan_lib()
    out = (ctypes.c_longlong * 11)()
    for d, variant, chunk in ((96, 0, 0), (80, 1, 0), (128, 1, 0),
                              (512, 1, 1), (64, 2, 0), (64, 0, 1),
                              (384, 0, 0), (512, 0, -1)):
        assert lib.wf_flash_f32_plan(d, variant, 1000, chunk, out) == 0, (
            d, variant, chunk)
    one = tfa._f32_layout(512, 0, 6656, 1)
    big = tfa._f32_layout(512, 0, 6656, 40000)
    assert big.scratch_bytes == 40000 * one.scratch_bytes > 2 ** 31
    assert tfa._f32_layout(384, 0, 0, 1).score_key_tiles == 1
