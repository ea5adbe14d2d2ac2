"""The port's block-sparse attention (kernel 5's plain version and the
selection) against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode (``_bsa_bhsd(...,
interpret=True)``). Both accumulate in fp32; in bf16 the two round the
probabilities to bf16 before P.V and the JAX kernel keeps its accumulator
normalised at every step while the port divides once at the end, so bf16
outputs agree to a few bf16 ulps (held at 2e-2 of the largest output) and
fp32 outputs to fp32 rounding (held at 1e-4 of the largest output: a fresh
process measures 4e-7, but one run of the whole suite measured 2e-5 and
could not be repeated, so the order of the fp32 sums is not taken as
fixed). Selection sets and counts must be exactly equal.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.ops import bsa as jbsa
from worldforge_tpu.ops.attention import sdpa_reference
from worldforge_tpu_torch.ops import bsa as tbsa
from worldforge_tpu_torch.ops.flash_attention import flash_attention_plain

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of the largest |output|


def _qkv(rng, bh, nq, nk, d, dtype):
    f = lambda n: rng.standard_normal((bh, n * 128, d)).astype(np.float32)
    q, k, v = f(nq), f(nk), f(nk)
    if dtype == "bfloat16":
        # round once so both sides see the same bf16 values
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    return q, k, v


def _to(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(rng, dtype):
    """Variable counts (1, 3 and a count of 0) and m/l from return_lse."""
    bh, nq, nk, d = 2, 3, 4, 32
    q, k, v = _qkv(rng, bh, nq, nk, d, dtype)
    idx = np.array([[[2, 0, 1], [0, 3, 1], [1, 2, 3]],
                    [[3, 1, 0], [2, 2, 2], [0, 1, 2]]], np.int32)
    cnt = np.array([[1, 3, 0], [3, 1, 2]], np.int32)
    jd = getattr(jnp, dtype)
    want, wm, wl = jbsa._bsa_bhsd(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(idx.reshape(bh, -1)), jnp.asarray(cnt),
        scale=d ** -0.5, kmax=3, interpret=True, return_lse=True)
    got, gm, gl = tbsa.bsa_plain(_to(q, dtype), _to(k, dtype), _to(v, dtype),
                                 torch.from_numpy(idx), torch.from_numpy(cnt),
                                 return_lse=True)
    got = got.float().numpy()
    assert got.shape == (bh, nq * 128, d)
    assert np.all(got[0, 256:] == 0.0)                  # the count-0 chunk
    assert np.all(gm.numpy()[0, 256:] == tbsa.NEG_INF)
    assert np.all(gl.numpy()[0, 256:] == 0.0)
    assert _rel(got, want) < TOL[dtype]
    live = np.asarray(wl) > 0
    np.testing.assert_allclose(gm.numpy()[live], np.asarray(wm)[live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gl.numpy()[live], np.asarray(wl)[live],
                               rtol=1e-4)


def test_plain_matches_masked_oracle_fp32(rng):
    """The gathered plain form equals the JAX dense-masked oracle."""
    bh, nq, nk, d = 2, 2, 4, 16
    q, k, v = _qkv(rng, bh, nq, nk, d, "float32")
    idx, cnt = jbsa.select_blocks(jnp.asarray(q), jnp.asarray(k),
                                  sparsity=0.5)
    want = jbsa._bsa_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), idx, cnt, 0.25)
    got = tbsa.bsa_plain(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), torch.from_numpy(np.array(idx)),
                         torch.from_numpy(np.array(cnt)), scale=0.25)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("sparsity,cdf", [(0.5, None), (0.25, None),
                                          (None, 0.7), (0.5, 0.3),
                                          (None, 1.01)])
def test_selection_matches_jax(rng, sparsity, cdf):
    """Top-k and CDF selection: the selected index sets and the counts are
    exactly the JAX package's."""
    q = rng.standard_normal((3, 8 * 128, 32)).astype(np.float32)
    k = rng.standard_normal((3, 8 * 128, 32)).astype(np.float32)
    wi, wc = jbsa.select_blocks(jnp.asarray(q), jnp.asarray(k),
                                sparsity=sparsity, cdf_threshold=cdf)
    gi, gc = tbsa.select_blocks(torch.from_numpy(q), torch.from_numpy(k),
                                sparsity=sparsity, cdf_threshold=cdf)
    wi, wc, gi, gc = (np.asarray(a) for a in (wi, wc, gi, gc))
    assert gi.dtype == gc.dtype == np.int32 and gi.shape == wi.shape
    np.testing.assert_array_equal(gc, wc)
    for b in range(3):
        for n in range(8):
            c = int(wc[b, n])
            assert set(gi[b, n, :c].tolist()) == set(wi[b, n, :c].tolist())


def test_topk_ties_keep_the_lower_index():
    """Equal pooled scores: jax.lax.top_k keeps the lower index first."""
    qc = np.ones((1, 2, 4), np.float32)
    kc = np.zeros((1, 6, 4), np.float32)
    kc[0, 4] = 1.0
    wi, _ = jbsa.select_blocks_from_pooled(jnp.asarray(qc), jnp.asarray(kc),
                                           sparsity=0.5, head_dim=4)
    gi, _ = tbsa.select_blocks_from_pooled(torch.from_numpy(qc),
                                           torch.from_numpy(kc),
                                           sparsity=0.5, head_dim=4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gi[0, 0].tolist() == [4, 0, 1]


def test_mean_pool_and_rearrange_roundtrip(rng):
    x = rng.standard_normal((1, 8 * 8 * 16, 2, 8)).astype(np.float32)
    grid, chunk = (8, 8, 16), (4, 4, 8)
    jb = np.asarray(jbsa.rearrange_thw_to_blocks(jnp.asarray(x), grid, chunk))
    tb = tbsa.rearrange_thw_to_blocks(torch.from_numpy(x), grid, chunk)
    np.testing.assert_array_equal(tb.numpy(), jb)
    back = tbsa.rearrange_blocks_to_thw(tb, grid, chunk)
    np.testing.assert_array_equal(back.numpy(), x)
    flat = rng.standard_normal((2, 256, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tbsa.mean_pool_chunks(torch.from_numpy(flat), 128).numpy(),
        np.asarray(jbsa.mean_pool_chunks(jnp.asarray(flat), 128)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsa_attention_3d_matches_pallas_interpret(rng, dtype):
    """The whole 3D path on a (4, 8, 16) grid of 4 chunks, sparsity 0.5."""
    grid = (4, 8, 16)
    b, s, h, d = 1, 4 * 8 * 16, 2, 32
    x = [rng.standard_normal((b, s, h, d)).astype(np.float32)
         for _ in range(3)]
    if dtype == "bfloat16":
        x = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in x]
    jd = getattr(jnp, dtype)
    want = jbsa.bsa_attention_3d(*(jnp.asarray(a, jd) for a in x), grid, grid,
                                 sparsity=0.5, impl="pallas_interpret")
    got = tbsa.bsa_attention_3d(*(_to(a, dtype) for a in x), grid, grid,
                                sparsity=0.5)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, d)
    assert _rel(got.float().numpy(), want) < TOL[dtype]


def test_sparsity_zero_is_dense(rng):
    """Every chunk selected: BSA equals dense attention (the port's flash
    plain version and the JAX fp32 reference)."""
    grid = (4, 4, 16)
    b, s, h, d = 1, 256, 2, 32
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    got = tbsa.bsa_attention_3d(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), grid, grid,
                                sparsity=0.0).numpy()
    dense = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v)).numpy()
    want = np.asarray(sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v)))
    assert _rel(got, dense) < 1e-5 and _rel(got, want) < 1e-5


def test_wrapper_takes_plain_on_cpu_and_counts_nothing(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 2, 2, 64,
                                                 "float32"))
    idx, cnt = tbsa.select_blocks(q, k, sparsity=0.5)
    before = tbsa.bsa_bhsd.launches
    out = tbsa.bsa_bhsd(q, k, v, idx, cnt)
    torch.testing.assert_close(out, tbsa.bsa_plain(q, k, v, idx, cnt,
                                                   scale=1 / math.sqrt(64)))
    assert tbsa.bsa_bhsd.launches == before
