"""The host-side plan of kernel 1's backward (``_bwd_plan``, ``_bwd_scratch``
in ``worldforge_tpu_torch/ops/flash_attention.py``) and the wrapper's
refusals, which need no card: the CUDA kernel itself is held against
autograd of ``flash_attention_plain`` by ``chip_smoke.py`` on the H100."""

from __future__ import annotations

import math
from fractions import Fraction

import pytest
import torch

from worldforge_tpu_torch.ops import flash_attention as tfa

WAN = 20280          # Wan2.1-14B 480p x 49 frames: 13 x 30 x 52 tokens

SHAPES = [
    (1, WAN, WAN, 40, 128),      # 14B self-attention
    (1, WAN, 512, 40, 128),      # text cross-attention
    (1, WAN, 257, 40, 128),      # CLIP cross-attention
    (1, 32760, 32760, 12, 128),  # 1.3B at 81 frames
    (1, WAN, WAN, 32, 128),      # LongCat-13.6B
    (1, 32760, 512, 12, 128),    # 1.3B text cross-attention
    (1, WAN, 512, 32, 128),      # LongCat-13.6B text cross-attention
    (1, 4096, 4096, 16, 64),
    (3, 4096, 257, 8, 128),
    (3, 200, 300, 2, 64),
    (2, 1560, 512, 4, 128),
    (1, 63, 5, 1, 64),
    (1, 64, 128, 1, 128),
    (2, 1, 1, 1, 64),
]


def _split_ranges(plan, sq):
    """The query tiles [first, end) each split walks, as the kernel reads
    the plan (split s from s * q_tiles_per_split)."""
    q_tiles = -(-sq // plan.q_tile)
    per = plan.q_tiles_per_split
    return [(s * per, min(q_tiles, (s + 1) * per))
            for s in range(plan.splits)]


def _scratch_bytes(plan, b, sq, sk, h, d):
    return sum(4 * math.prod(s)
               for s in tfa._bwd_scratch(plan, b, sq, sk, h, d).values())


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES)
def test_every_query_tile_in_exactly_one_split(b, sq, sk, h, d):
    plan = tfa._bwd_plan(b, sq, sk, h, d)
    assert (plan.key_tile, plan.q_tile) == (128, 64)
    q_tiles = -(-sq // plan.q_tile)
    ranges = _split_ranges(plan, sq)
    assert len(ranges) == plan.splits >= 1
    owner = [None] * q_tiles
    for s, (first, end) in enumerate(ranges):
        assert first < end, "an empty split"
        for t in range(first, end):
            assert owner[t] is None
            owner[t] = s
    assert None not in owner
    # the kernel's own reading of the plan: split s walks [s per, ...)
    per = plan.q_tiles_per_split
    assert plan.splits * per >= q_tiles > (plan.splits - 1) * per


def _waves_per_walk(blocks, splits, sms=132):
    """The waves of 1 / splits of the walk that blocks x splits take when
    one block runs on each SM at a time, as a fraction of one walk."""
    return Fraction(-(-blocks * splits // sms), splits)


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES[:7])
def test_split_only_at_short_kv(b, sq, sk, h, d):
    """No split where (key tiles x B*H) fills the card four times over (159
    x 40 blocks at the 14B self-attention); below that, the fewest splits
    that take the fewest waves per walk, at most about four blocks per SM
    (132 SMs): the text cross-attention's 4 x 40 blocks split, the CLIP
    cross-attention's 3 x 40 fit one wave and do not."""
    plan = tfa._bwd_plan(b, sq, sk, h, d)
    blocks = -(-sk // 128) * b * h
    if blocks >= 4 * 132:
        assert plan.splits == 1
        return
    cap = -(-4 * 132 // blocks)
    best = min(_waves_per_walk(blocks, n) for n in range(1, cap + 1))
    assert plan.splits <= cap
    assert _waves_per_walk(blocks, plan.splits) == best
    assert all(_waves_per_walk(blocks, n) > best
               for n in range(1, plan.splits))


def test_plan_at_the_dit_shapes():
    assert tfa._bwd_plan(1, WAN, WAN, 40, 128) == (128, 64, 1, 317)
    # 160 blocks: 2 waves unsplit, 5 waves of a quarter walk split 4
    assert tfa._bwd_plan(1, WAN, 512, 40, 128) == (128, 64, 4, 80)
    # 120 blocks fit one wave: no split
    assert tfa._bwd_plan(1, WAN, 257, 40, 128) == (128, 64, 1, 317)
    assert tfa._bwd_plan(1, 32760, 512, 12, 128).splits == 11
    assert tfa._bwd_plan(1, WAN, 512, 32, 128).splits == 1
    # the chip check's ragged split shape: 3 key tiles x 24 = 72 blocks
    plan = tfa._bwd_plan(3, 4096, 257, 8, 128)
    assert plan.splits > 1 and -(-257 // 128) * 3 * 8 == 72
    # fewer SMs, fewer splits; one query tile cannot split
    assert tfa._bwd_plan(1, WAN, 512, 40, 128, num_sms=16).splits == 1
    assert tfa._bwd_plan(1, 64, 512, 1, 128).splits == 1


@pytest.mark.parametrize("b,sq,sk,h,d", SHAPES)
def test_scratch_shapes_and_bytes(b, sq, sk, h, d):
    plan = tfa._bwd_plan(b, sq, sk, h, d)
    shapes = tfa._bwd_scratch(plan, b, sq, sk, h, d)
    sqp = -(-sq // 64) * 64
    want = {"delta": (b, h, sqp), "lse2": (b, h, sqp),
            "dq_acc": (b, sq, h, d)}
    if plan.splits > 1:
        want["dk_part"] = want["dv_part"] = (plan.splits, b, sk, h, d)
    assert shapes == want
    nbytes = 4 * (2 * b * h * sqp + b * sq * h * d
                  + (2 * plan.splits * b * sk * h * d
                     if plan.splits > 1 else 0))
    assert _scratch_bytes(plan, b, sq, sk, h, d) == nbytes


def test_scratch_bytes_at_the_14b_shapes():
    """The fp32 dQ accumulator is 415 MB at the 14B self-attention; the
    cross-attentions add their dK / dV partials."""
    self_attn = tfa._bwd_plan(1, WAN, WAN, 40, 128)
    acc = 4 * WAN * 40 * 128
    assert acc == 415334400
    assert _scratch_bytes(self_attn, 1, WAN, WAN, 40, 128) == \
        acc + 2 * 4 * 40 * 20288
    text = tfa._bwd_plan(1, WAN, 512, 40, 128)
    assert _scratch_bytes(text, 1, WAN, 512, 40, 128) == \
        acc + 2 * 4 * 40 * 20288 + 2 * 4 * 4 * 512 * 40 * 128


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 80),
                                     (torch.float16, 64)])
def test_backward_raises_without_an_instantiation(dtype, d):
    q = torch.zeros((1, 8, 2, d), dtype=dtype)
    m = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="no instantiation"):
        tfa.flash_attention_backward(q, q, q, q, q, m, m, None, 0.1)


def test_backward_raises_on_misaligned_tensors():
    """A view that starts 2 bytes into its storage cannot feed TMA: the
    wrapper raises before it looks at the device."""
    q = _bf16(1, 8, 2, 64)
    flat = _bf16(1 + q.numel())
    bad = flat[1:].view(q.shape)
    assert bad.data_ptr() % 16
    m = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_attention_backward(bad, q, q, q, q, m, m, None, 0.1)


def test_backward_raises_on_shapes_and_cpu():
    q = _bf16(1, 8, 2, 64)
    m = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention_backward(q, q, q, q, q, m[:, :1], m, None, 0.1)
    with pytest.raises(ValueError, match="device cpu"):
        tfa.flash_attention_backward(q, q, q, q, q, m, m, None, 0.1)
