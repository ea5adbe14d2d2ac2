"""The port's fused Wan generate (``WanI2VPipeline.generate(fused=True)``
and ``exec_chunk``) against the JAX package's fused and chunked runners, on
the CPU.

The tiny pipelines of ``tests/test_torch_pipeline.py`` (2 layers, width 64,
the tiny VAE, fp32 policy, fp32 convs on both sides). JAX's fused runner
draws its noise from the key inside its program (the initial latents from
``split(key)[1]``, then one split of ``split(key)[0]`` for each IRR
re-noise); the port gets the same draws through ``noise_fn``. Gates: the
latents at ``TOL["fp32"]`` of ``tests/test_torch_pipeline.py`` (1e-4
relative); chunked runs bit-equal to the one-program run; FLF's device
sets equal to the JAX loop's host sets at every step, with at least one
channel handed back. On the CPU the fused runner is the eager loop over the
step tables (``sampling/engine.py::run_plan_eager``): the CUDA graphs are
held to it on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pipeline import (DIT_KW, TOL, _inputs, _to_jax,
                                       fp32_conv3d)
from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.models.wan import dit as jdit
from worldforge_tpu.models.wan import vae as jvae
from worldforge_tpu.pipelines import wan_i2v as jwan
from worldforge_tpu.sampling.guidance import GuidanceConfig as JGuide
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.models.wan import dit as tdit
from worldforge_tpu_torch.models.wan import vae as tvae
from worldforge_tpu_torch.pipelines.wan_i2v import WanI2VPipeline as TPipe
from worldforge_tpu_torch.sampling.guidance import GuidanceConfig as TGuide

torch.set_num_threads(2)

# FLF on through 8 guided steps: the Wan schedule hands a channel back at
# steps 6 and 7
GUIDE = dict(guided=True, guide_steps=8, resample_steps=2, resample_round=8,
             omega=4.0, use_flf=True)
KW = dict(height=64, width=64, num_frames=9, num_inference_steps=8,
          guidance_scale=4.0, output_type="latent")


def jax_key_stream(seed):
    """The draws JAX's fused runners make from ``key(seed)``, in order."""
    key, first = jax.random.split(jax.random.key(seed))
    state = {"k": key, "first": first}

    def draw(shape):
        if state["first"] is not None:
            k, state["first"] = state["first"], None
        else:
            state["k"], k = jax.random.split(state["k"])
        return np.asarray(jax.random.normal(k, tuple(shape), jnp.float32))
    return draw


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def pipes():
    tdp = tdit.init_wan_dit(torch.Generator().manual_seed(0),
                            tdit.WanDiTConfig(**DIT_KW), dtype=torch.float32)
    head = tdp["head"]["head"]
    head["w"] = 0.02 * torch.randn(head["w"].shape,
                                   generator=torch.Generator().manual_seed(9))
    tvp = tvae.init_wan_vae(torch.Generator().manual_seed(1),
                            tvae.WanVAEConfig.tiny())
    jdp = {k: _to_jax(v) for k, v in tdp.items() if k != "blocks"}
    jdp["blocks"] = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[_to_jax(b) for b in tdp["blocks"]])
    tp = TPipe(dit_params=tdp, dit_cfg=tdit.WanDiTConfig(**DIT_KW),
               vae_params=tvp, vae_cfg=tvae.WanVAEConfig.tiny(),
               policy=T_FP32)
    jp = jwan.WanI2VPipeline(dit_params=jdp,
                             dit_cfg=jdit.WanDiTConfig(**DIT_KW),
                             vae_params=_to_jax(tvp),
                             vae_cfg=jvae.WanVAEConfig.tiny(), policy=J_FP32)
    return jp, tp


@pytest.fixture
def fp32_convs(monkeypatch):
    old = jvae._CONV3D_MODE
    jvae._CONV3D_MODE = "3d"
    monkeypatch.setattr(tvae, "conv3d_causal", fp32_conv3d)
    try:
        yield
    finally:
        jvae._CONV3D_MODE = old


def _jax_args(x):
    return tuple(jnp.asarray(x[k]) for k in ("image", "pe", "ne", "ie"))


def test_fused_generate_matches_jax(pipes, fp32_convs, monkeypatch):
    """CFG, IRR 2, the VAE fuse, FLF selected on the device, DSG: the
    latents against JAX's ``generate(fused=True)``; FLF's device sets
    against the JAX loop's host selection on the same draws."""
    jp, tp = pipes
    x = _inputs(frames=9, hw=64)
    ref, mask = jnp.asarray(x["ref"]), jnp.asarray(x["mask"])
    want = np.asarray(jp.generate(
        jax.random.key(0), *_jax_args(x), video_ref=ref, mask=mask,
        guidance=JGuide(**GUIDE), fused=True, **KW))
    got = tp.generate(None, x["image"], x["pe"], x["ne"], x["ie"],
                      video_ref=x["ref"], mask=x["mask"],
                      guidance=TGuide(**GUIDE), fused=True,
                      noise_fn=jax_key_stream(0), **KW)
    assert got.shape == (1, 4, 3, 8, 8)
    assert _rel(got, want) < TOL["fp32"][0], _rel(got, want)
    device = {i: sorted(np.nonzero(m)[0].tolist())
              for i, m in tp.last_flf_masks.items()}
    host = []
    orig = jwan.flf_select

    def record(pred, ref_, step, cfg):
        out = orig(pred, ref_, step, cfg)
        host.append((step, sorted(out)))
        return out
    monkeypatch.setattr(jwan, "flf_select", record)
    jp.generate(jax.random.key(0), *_jax_args(x), video_ref=ref, mask=mask,
                guidance=JGuide(**GUIDE), **KW)
    assert [s for s, _ in host] == list(range(8))
    assert dict(host) == device
    assert sum(len(c) for c in device.values()) >= 1


def test_chunked_generate_matches_jax(pipes, fp32_convs):
    """``exec_chunk`` 1, 2 and 3 bit-equal to ``fused=True``; ``exec_chunk``
    2 against JAX's ``run_fused_chunked`` (FLF off: the chunk programs are
    JAX's costliest compile here)."""
    jp, tp = pipes
    x = _inputs(frames=5, hw=32)
    g = dict(GUIDE, guide_steps=2, resample_round=3, use_flf=False)
    kw = dict(KW, height=32, width=32, num_frames=5, num_inference_steps=4)

    def port(**k):
        return tp.generate(None, x["image"], x["pe"], x["ne"], x["ie"],
                           video_ref=x["ref"], mask=x["mask"],
                           guidance=TGuide(**g), noise_fn=jax_key_stream(4),
                           **kw, **k)

    fused = port(fused=True)
    chunks = []
    orig = tp.run_fused_chunked

    def counting(*a, **k):
        k["on_chunk"] = lambda i, n, sf, si, lat: chunks.append((n, sf, si))
        return orig(*a, **k)

    tp.run_fused_chunked = counting
    try:
        for k in (1, 2, 3):
            chunks.clear()
            assert torch.equal(port(fused=True, exec_chunk=k), fused), k
            assert sum(n for n, _, _ in chunks) == 4 and len(chunks) > 1
    finally:
        del tp.run_fused_chunked
    want = np.asarray(jp.generate(
        jax.random.key(4), *_jax_args(x), video_ref=jnp.asarray(x["ref"]),
        mask=jnp.asarray(x["mask"]), guidance=JGuide(**g), fused=True,
        exec_chunk=2, **kw))
    assert _rel(fused, want) < TOL["fp32"][0], _rel(fused, want)


@pytest.mark.parametrize("cfg", [True, False], ids=["cfg", "no-cfg"])
def test_fused_unguided_matches_jax(pipes, fp32_convs, cfg):
    """No reference (no fuse, IRR from resample_round only), with and
    without CFG (DSG then needs the r > 0 history alone)."""
    jp, tp = pipes
    x = _inputs(frames=5, hw=32)
    g = dict(guided=False, guide_steps=2, resample_steps=3,
             resample_round=2, omega=4.0)
    kw = dict(KW, height=32, width=32, num_frames=5, num_inference_steps=3)
    ne = x["ne"] if cfg else None
    want = np.asarray(jp.generate(
        jax.random.key(6), jnp.asarray(x["image"]), jnp.asarray(x["pe"]),
        None if ne is None else jnp.asarray(ne), jnp.asarray(x["ie"]),
        guidance=JGuide(**g), fused=True, **kw))
    got = tp.generate(None, x["image"], x["pe"], ne, x["ie"],
                      guidance=TGuide(**g), fused=True,
                      noise_fn=jax_key_stream(6), **kw)
    assert _rel(got, want) < TOL["fp32"][0], _rel(got, want)


def test_auto_layout_is_the_fused_runner(pipes, fp32_convs):
    """``auto_layout=True`` (XLA entry layouts in JAX; none in torch) runs
    the fused runner on the weights as they are: the same latents bit for
    bit, and no weight tensor copied. The field is read by no code in the
    port, so this holds the JAX API, not a behaviour."""
    import dataclasses

    from worldforge_tpu_torch.runtime import layouts
    _, tp = pipes
    assert not layouts.auto_layouts_supported()
    x = _inputs(frames=5, hw=32)
    g = dict(GUIDE, guide_steps=2, resample_round=2, use_flf=False)
    kw = dict(KW, height=32, width=32, num_frames=5, num_inference_steps=3)
    ptrs = lambda p: [t.data_ptr() for t in _leaves(p)]
    before = (ptrs(tp.dit_params), ptrs(tp.vae_params))
    outs = {}
    for auto in (False, True):
        pipe = dataclasses.replace(tp, auto_layout=auto)
        outs[auto] = pipe.generate(
            None, x["image"], x["pe"], x["ne"], x["ie"], video_ref=x["ref"],
            mask=x["mask"], guidance=TGuide(**g), fused=True,
            noise_fn=jax_key_stream(8), **kw)
        assert (ptrs(pipe.dit_params), ptrs(pipe.vae_params)) == before
    assert torch.equal(outs[True], outs[False])


def _leaves(tree):
    out = []
    from worldforge_tpu_torch.core.params import tree_map
    tree_map(out.append, tree)
    return out
