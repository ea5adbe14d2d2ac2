"""The port's FLF channel selection against the JAX package's, on the CPU:
``ops/flow.py``, ``sampling/channel_select.py`` and the FLF half of
``sampling/guidance.py``.

Same seeded numpy latents through both sides. Tolerances: Farneback flows
1e-4 px; Lucas-Kanade flows 1e-4 of the largest |flow| (no quantization,
fp32 in another order through three clamped iterations per level; measured
2e-5); channel scores 1e-5; selected channel sets,
device masks and the channel replacement exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.ops import flow as jflow
from worldforge_tpu.sampling import channel_select as jcs
from worldforge_tpu.sampling import guidance as jgd
from worldforge_tpu_torch.ops import flow as tflow
from worldforge_tpu_torch.sampling import channel_select as tcs
from worldforge_tpu_torch.sampling import guidance as tgd

torch.set_num_threads(2)

SCORE_TOL = 1e-5


def _latents(seed, shape=(1, 16, 4, 24, 40)):
    """A reference latent video with temporal drift and a prediction that
    drifts away from it by a channel-dependent amount."""
    rng = np.random.default_rng(seed)
    b, c, t, h, w = shape
    base = np.cumsum(rng.standard_normal((b, 1, t, h, w)), axis=2)
    ref = base + 0.3 * rng.standard_normal(shape)
    amount = np.linspace(0.0, 0.8, c)[None, :, None, None, None]
    pred = (ref + amount * np.roll(ref, 1, axis=-1)
            + 0.2 * rng.standard_normal(shape))
    return pred.astype(np.float32), ref.astype(np.float32)


@pytest.mark.parametrize("method", ["farneback", "lk"])
def test_video_channel_flows_pair_matches_jax(method):
    pred, ref = _latents(0)
    want = jflow.video_channel_flows_pair(jnp.asarray(pred), jnp.asarray(ref),
                                          method=method)
    got = tflow.video_channel_flows_pair(torch.from_numpy(pred),
                                         torch.from_numpy(ref), method=method)
    assert len(got) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (1, 16, 3, 2, 24, 40)
        tol = 1e-4 if method == "farneback" else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0)
    one = tflow.video_channel_flows(torch.from_numpy(pred), method=method)
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def test_norm_frame_pairs_quantization():
    """One global min and range per video, then floor((v - min) / range *
    255): the pairs are exactly the JAX package's, quantized or not."""
    pred, _ = _latents(1)
    pred[0, 3] *= 40.0                   # one channel sets the range
    for quant in (True, False):
        want = jflow._norm_frame_pairs(jnp.asarray(pred), quant)
        got = tflow._norm_frame_pairs(torch.from_numpy(pred), quant)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("variant", ["wan", "longcat"])
@pytest.mark.parametrize("use_optical_flow", [True, False])
def test_channel_similarities_match_jax(variant, use_optical_flow):
    pred, ref = _latents(2)
    want = jcs.channel_similarities(jnp.asarray(pred), jnp.asarray(ref),
                                    use_optical_flow, variant)
    got = tcs.channel_similarities(torch.from_numpy(pred),
                                   torch.from_numpy(ref), use_optical_flow,
                                   variant)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == (16,)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)
    assert np.ptp(got) > 1e-3            # the channels are told apart


def _score_vectors(n=200):
    rng = np.random.default_rng(3)
    out = [rng.uniform(0.2, 1.0, 16).astype(np.float32) for _ in range(n)]
    # a few clustered vectors, so every clamp of the schedules is taken
    out += [np.clip(0.9 + 0.01 * rng.standard_normal(16), 0, 1)
            .astype(np.float32) for _ in range(20)]
    low = rng.uniform(0.9, 1.0, 16).astype(np.float32)
    low[:9] = rng.uniform(0.0, 0.1, 9)
    one = rng.uniform(0.95, 1.0, 16).astype(np.float32)
    one[5] = 0.0
    return [low, one] + out


def test_host_schedules_match_jax():
    for scores in _score_vectors():
        for step in range(0, 21):
            assert (tcs.select_channels_wan(scores, step)
                    == jcs.select_channels_wan(scores, step))
            for distill in (True, False):
                for mr in (None, 1, 2, 4):
                    assert (tcs.select_channels_longcat(scores, step,
                                                        distill, mr)
                            == jcs.select_channels_longcat(scores, step,
                                                           distill, mr))


def _mask_list(mask):
    return [int(i) for i in np.flatnonzero(np.asarray(mask) > 0.5)]


def test_device_masks_match_host_lists():
    # JAX's device mask jitted once: one dispatch per call, not its ops'
    jmask = jax.jit(jcs.select_mask_wan_device)
    sizes = set()
    for scores in _score_vectors(60):
        ts = torch.from_numpy(scores)
        for step in range(0, 21):
            host = tcs.select_channels_wan(scores, step)
            sizes.add(len(host))
            assert _mask_list(tcs.select_mask_wan_device(ts, step)) == host
            assert _mask_list(tcs.select_mask_wan_device(
                ts, torch.tensor(step))) == host
            assert _mask_list(jmask(jnp.asarray(scores),
                                    jnp.asarray(step))) == host
            for distill in (True, False):
                for mr in (None, 2):
                    host = tcs.select_channels_longcat(scores, step,
                                                       distill, mr)
                    assert _mask_list(tcs.select_mask_longcat_device(
                        ts, step, distill, mr)) == host
    assert {0, 1, 2, 6} <= sizes         # none, worst 1, min 2, max 6


def test_apply_channel_replacement_matches_jax():
    pred, ref = _latents(4)
    for channels in ([], [0], [3, 7, 15]):
        want = np.asarray(jcs.apply_channel_replacement(
            jnp.asarray(ref), jnp.asarray(pred), channels))
        got = tcs.apply_channel_replacement(torch.from_numpy(ref),
                                            torch.from_numpy(pred), channels)
        np.testing.assert_array_equal(got.numpy(), want)


def _toy_vae(xp, up, pool, cat):
    """A decode (z -> 3 pixel channels, 2x up in space) and encode (2x
    average pool, back to 16 channels) pair: the fuse's arithmetic without a
    VAE, written once for both array modules."""
    def decode(z):
        return up(up(xp.tanh(z[:, :3] - 0.5 * z[:, 3:6]), 3), 4)

    def encode(v):
        b, c, t, h, w = v.shape
        p = pool(v.reshape(b, c, t, h // 2, 2, w // 2, 2))
        return cat([p] * 6)[:, :16]
    return decode, encode


JAX_TOY = _toy_vae(jnp, lambda x, ax: jnp.repeat(x, 2, axis=ax),
                   lambda x: x.mean(axis=(4, 6)),
                   lambda xs: jnp.concatenate(xs, axis=1))
TORCH_TOY = _toy_vae(torch, lambda x, ax: x.repeat_interleave(2, dim=ax),
                     lambda x: x.mean(dim=(4, 6)),
                     lambda xs: torch.cat(xs, dim=1))


@pytest.mark.parametrize("channels", [None, [2, 9]])
def test_fuse_latents_flf_channels_match_jax(channels):
    pred, _ = _latents(5, shape=(1, 16, 3, 12, 20))
    rng = np.random.default_rng(6)
    video_ref = rng.uniform(0, 1, (1, 3, 3, 24, 40)).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, 1, 3, 24, 40)) > 0.5).astype(np.float32)
    jd, je = JAX_TOY
    td, te = TORCH_TOY
    want = np.asarray(jgd.fuse_latents(
        jnp.asarray(pred), jnp.asarray(video_ref), jnp.asarray(mask), jd, je,
        flf_channels=channels))
    got = tgd.fuse_latents(torch.from_numpy(pred),
                           torch.from_numpy(video_ref),
                           torch.from_numpy(mask), td, te,
                           flf_channels=channels)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if channels:
        np.testing.assert_array_equal(got.numpy()[:, channels],
                                      pred[:, channels])


@pytest.mark.parametrize("cfg", [
    dict(flf_backend="wan"),
    dict(flf_backend="longcat", distill=True),
    dict(flf_backend="longcat", distill=False, max_replace=2),
    dict(flf_backend="wan", use_optical_flow=False)],
    ids=["wan", "longcat-distill", "longcat-standard-max2", "wan-no-flow"])
def test_flf_select_matches_jax_every_step(cfg):
    pred, ref = _latents(7, shape=(1, 16, 3, 16, 24))
    jc = jgd.GuidanceConfig(**cfg)
    tc = tgd.GuidanceConfig(**cfg)
    picked = 0
    for step in range(0, 21):
        want = jgd.flf_select(jnp.asarray(pred), jnp.asarray(ref), step, jc)
        got = tgd.flf_select(torch.from_numpy(pred), torch.from_numpy(ref),
                             step, tc)
        assert got == want, (step, got, want)
        picked += len(got)
    assert picked > 0
    off = dataclasses.replace(tc, use_flf=False)
    assert tgd.flf_select(None, None, 12, off) == []
