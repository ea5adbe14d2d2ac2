"""The port's runtime layer (``worldforge_tpu_torch/runtime``) and the dry
run's fused phases against the JAX package's, on the CPU.

- ``streaming.py``: ``stream_layers`` / ``StreamingExecutor`` equal to the
  resident layers and to JAX's ``stream_layers`` on dense layers (1e-6) and
  on Wan DiT blocks (JAX's gate, 2e-5), for several prefetch depths;
  ``StreamedBlocks`` in a DiT forward's block list equal to the resident
  forward bit for bit.
- ``subproc.py``: ``decode_in_subprocess`` (a fresh Python process on the
  CPU) equal to the in-process streaming decode bit for bit, from the init
  seed and from ``save_params_host``'s file, and to JAX's streaming decode
  (the Pallas conv in interpret mode) at ``tests/test_torch_vae_stream.py``'s
  gate for that mode; a failing child raises with its stderr.
- ``layouts.py``: torch has no entry layouts: every function hands its
  arguments back as they are.
- ``step_graph.py``: the launch-count bookkeeping of the graph replays.
- The dry run's two phases (``parallel/dryrun.py``: the fused guided
  generate and the chunked one) at world sizes 2 and 4 on gloo
  (``tests/torch_parallel_workers.py``), on (dp, fsdp, sp) as the dry run
  picks it, fed the draws JAX's fused runner makes from its key: every rank
  within 1e-4 relative of JAX's ``generate(fused=True)`` /
  ``exec_chunk=2`` under the same mesh, and equal on every rank.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vae_stream import TOL as VAE_TOL
from tests.torch_parallel_workers import run_spawn
from worldforge_tpu.core import params as JP
from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.models.wan import dit as jdit
from worldforge_tpu.models.wan import vae as jvae
from worldforge_tpu.pipelines.vae_dispatch import jit_vae_fns
from worldforge_tpu.runtime import streaming as jstream
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io.from_jax import tree_from_numpy
from worldforge_tpu_torch.models.wan import dit as tdit
from worldforge_tpu_torch.models.wan import vae as tvae
from worldforge_tpu_torch.runtime import layouts, step_graph
from worldforge_tpu_torch.runtime.streaming import (StreamedBlocks,
                                                    StreamingExecutor,
                                                    stream_layers,
                                                    to_host_blocks)
from worldforge_tpu_torch.runtime.subproc import (decode_clip,
                                                  decode_in_subprocess,
                                                  save_params_host)

torch.set_num_threads(2)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------- streaming


def test_streaming_matches_resident_and_jax(rng):
    n, dim = 5, 16
    layers = [JP.dense_init(k, dim, dim)
              for k in JP.split_keys(jax.random.key(0), n)]
    jblocks = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *layers)
    x = rng.standard_normal((2, dim)).astype(np.float32)
    want = jstream.stream_layers(
        jstream.to_host_blocks(jblocks), n,
        lambda p, h: jax.nn.tanh(JP.dense(p, h)), jnp.asarray(x),
        prefetch=1)
    layer = lambda p, h: torch.tanh(TP.dense(p, h))
    tlayers = [tree_from_numpy(jax.tree_util.tree_map(np.asarray, p))
               for p in layers]
    resident = torch.from_numpy(x)
    for p in tlayers:
        resident = layer(p, resident)
    stacked = {k: torch.stack([p[k] for p in tlayers]) for k in tlayers[0]}
    for host in (to_host_blocks(tlayers), to_host_blocks(stacked)):
        for prefetch in (0, 1, 2, 7):
            ex = StreamingExecutor(host, n, layer, prefetch=prefetch)
            got = ex(torch.from_numpy(x))
            assert torch.equal(got, resident), prefetch
            assert ex.max_resident == min(prefetch + 2, n)
            assert _rel(stream_layers(host, n, layer, torch.from_numpy(x),
                                      prefetch=prefetch), want) < 1e-6


def test_streaming_wan_layers_match_jax(rng):
    """Streamed Wan DiT blocks against JAX's streamed blocks (its test's
    config and gate), and ``StreamedBlocks`` as a forward's block list
    against the resident forward, bit for bit."""
    from worldforge_tpu.ops.rope import rope_cos_sin as j_rope
    from worldforge_tpu_torch.io.from_jax import dit_params_from_jax
    from worldforge_tpu_torch.ops.rope import rope_cos_sin as t_rope
    kw = dict(model_type="t2v", in_dim=4, out_dim=4, dim=64, ffn_dim=128,
              num_heads=2, num_layers=3, text_len=8, text_dim=32,
              freq_dim=16)
    jcfg, tcfg = jdit.WanDiTConfig(**kw), tdit.WanDiTConfig(**kw)
    jparams = jax.tree_util.tree_map(np.asarray, jdit.init_wan_dit(
        jax.random.key(0), jcfg, dtype=jnp.float32))
    tparams = dit_params_from_jax(jparams)
    f, gh, gw = 3, 4, 4
    x = rng.standard_normal((1, f * gh * gw, 64)).astype(np.float32)
    e = rng.standard_normal((1, 6, 64)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 64)).astype(np.float32)
    jcs, jsn = j_rope(f, gh, gw, 32)
    want = jstream.StreamingExecutor(
        jstream.to_host_blocks(jax.tree_util.tree_map(jnp.asarray,
                                                      jparams["blocks"])), 3,
        lambda p, h: jdit.wan_dit_layer_forward(
            p, jcfg, h, jnp.asarray(e), jnp.asarray(ctx), jcs, jsn,
            policy=J_FP32), prefetch=1)(jnp.asarray(x))
    tcs, tsn = t_rope(f, gh, gw, 32)
    got = StreamingExecutor(
        to_host_blocks(tparams["blocks"]), 3,
        lambda p, h: tdit.wan_dit_layer_forward(
            p, tcfg, h, torch.from_numpy(e), torch.from_numpy(ctx), tcs, tsn,
            policy=T_FP32), prefetch=1)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)

    lat = torch.from_numpy(rng.standard_normal((1, 4, 3, 8, 8)).astype(
        np.float32))
    t = torch.tensor([500.0])
    tx = torch.from_numpy(rng.standard_normal((1, 8, 32)).astype(np.float32))
    resident = tdit.wan_dit_forward(tparams, tcfg, lat, t, tx,
                                    policy=T_FP32)
    streamed = dict(tparams, blocks=StreamedBlocks(
        to_host_blocks(tparams["blocks"]), 3, prefetch=1))
    for _ in range(2):                  # each loop streams the blocks again
        assert torch.equal(tdit.wan_dit_forward(streamed, tcfg, lat, t, tx,
                                                policy=T_FP32), resident)
    assert len(streamed["blocks"]) == 3


# ----------------------------------------------------------------- subproc

CHILD_ENV = {"CUDA_VISIBLE_DEVICES": ""}


@pytest.fixture(scope="module")
def decode_setup():
    cfg = tvae.WanVAEConfig.tiny()
    params = tvae.init_wan_vae(torch.Generator().manual_seed(1), cfg)
    lat = np.random.default_rng(7).standard_normal(
        (1, cfg.z_dim, 3, 8, 8)).astype(np.float32)
    want = decode_clip(params, cfg, torch.from_numpy(lat)).numpy()
    return cfg, params, lat, want


def test_subprocess_matches_inprocess_init_seed(decode_setup, tmp_path):
    cfg, _, lat, want = decode_setup
    video, times = decode_in_subprocess(
        lat, cfg, params_seed=1, dtype="float32", reps=2, device="cpu",
        out_dtype="float32", env=CHILD_ENV, workdir=str(tmp_path / "w"),
        verbose=False)
    assert len(times) == 2 and all(t > 0 for t in times)
    np.testing.assert_array_equal(video, want)
    # the JAX package's streaming decode at its own test's gate
    jparams = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()),
        tvae.init_wan_vae(torch.Generator().manual_seed(1), cfg))
    old = jvae._CONV3D_MODE
    jvae._CONV3D_MODE = "pallas_interpret"
    try:
        dec, _ = jit_vae_fns(jparams, jvae.WanVAEConfig.tiny(),
                             streaming=True, chunk=1)
        ref = np.clip((np.asarray(dec(jnp.asarray(lat)), np.float32) + 1.0)
                      / 2.0, 0.0, 1.0)
    finally:
        jvae._CONV3D_MODE = old
    # the conv kernel's bf16 input rounding flips on last-bit differences:
    # tests/test_torch_vae_stream.py's gate for this mode
    tol_max, tol_l2 = VAE_TOL["kernel"]
    assert _rel(video, ref) < tol_max
    assert np.linalg.norm(video - ref) / np.linalg.norm(ref) < tol_l2


def test_subprocess_matches_inprocess_pickled_params(decode_setup, tmp_path):
    cfg, params, lat, want = decode_setup
    ppath = str(tmp_path / "vae_params.pt")
    save_params_host(params, ppath)
    video, times = decode_in_subprocess(
        lat, cfg, params_path=ppath, reps=1, device="cpu",
        out_dtype="float32", env=CHILD_ENV, workdir=str(tmp_path),
        verbose=False)
    assert len(times) == 1
    np.testing.assert_array_equal(video, want)
    half, _ = decode_in_subprocess(
        lat, cfg, params_path=ppath, device="cpu", env=CHILD_ENV,
        workdir=str(tmp_path), verbose=False)
    assert half.dtype == np.float16
    np.testing.assert_array_equal(half, want.astype(np.float16))


def test_subprocess_without_workdir_leaves_nothing(decode_setup, tmp_path,
                                                   monkeypatch):
    """With no ``workdir`` the spec, latents and clip go in a temporary
    folder that is gone when the call returns."""
    cfg, params, lat, want = decode_setup
    ppath = str(tmp_path / "vae_params.pt")
    save_params_host(params, ppath)
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    video, _ = decode_in_subprocess(
        lat, cfg, params_path=ppath, device="cpu", out_dtype="float32",
        env=CHILD_ENV, verbose=False)
    np.testing.assert_array_equal(video, want)
    assert list(scratch.iterdir()) == []


def test_subprocess_failure_raises_with_stderr(decode_setup, tmp_path):
    cfg, _, lat, _ = decode_setup
    with pytest.raises(RuntimeError, match="subprocess decode failed"
                       r"(.|\n)*missing\.pt"):
        decode_in_subprocess(
            lat, cfg, params_path=str(tmp_path / "missing.pt"),
            device="cpu", env=CHILD_ENV, workdir=str(tmp_path),
            verbose=False)


# ------------------------------------------------------- layouts, counters


def test_layouts_hand_back_their_arguments():
    w = {"w": torch.ones(3)}
    fn = lambda p, x: p["w"] * x
    assert not layouts.auto_layouts_supported()
    assert layouts.jit_matching_layouts(fn, (w, 1.0)) is fn
    assert layouts.relayout_arg(w, None) is w
    got_fn, args = layouts.compile_auto_layouts(fn, (w, 2.0))
    assert got_fn is fn and args[0] is w and args[1] == 2.0


def test_replay_launch_counts(monkeypatch):
    """A capture's counts are taken back and each replay adds them: the
    delta of two snapshots, applied to the wrappers' counters (plain ints
    and the by-shape dicts)."""
    from worldforge_tpu_torch.ops import conv3d, flash_attention
    fa, cv = flash_attention.flash_attention, conv3d.conv3d_causal
    monkeypatch.setattr(fa, "launches", 5)
    monkeypatch.setattr(fa, "launches_by_shape", {("bf16 d128", 1, 2, 3): 1})
    monkeypatch.setattr(cv, "launches_by_shape", {})
    before = step_graph._snapshot()
    fa.launches += 2
    fa.launches_by_shape[("bf16 d128", 1, 2, 3)] += 2
    cv.launches_by_shape[(1, 2, 3, 4, 5, 6)] = 1
    after = step_graph._snapshot()
    step_graph._restore(before)
    assert fa.launches == 5 and cv.launches_by_shape == {}
    delta = step_graph._delta(before, after)
    for _ in range(3):
        step_graph.add_launches(delta)
    assert fa.launches == 11
    assert fa.launches_by_shape == {("bf16 d128", 1, 2, 3): 7}
    assert cv.launches_by_shape == {(1, 2, 3, 4, 5, 6): 3}
    assert set(step_graph.counted_wrappers()) >= {fa, cv}


# ------------------------------------------------------------ the dry run

WAN_KW = dict(model_type="i2v", in_dim=12, out_dim=4, dim=64, ffn_dim=128,
              num_heads=4, num_layers=2, text_len=8, text_dim=32,
              freq_dim=16, clip_dim=64)
DRY_GUIDE = dict(guided=True, guide_steps=2, resample_steps=2,
                 resample_round=2, omega=4.0, use_flf=True)
DRY_KW = dict(height=64, width=64, num_frames=9, num_inference_steps=4,
              guidance_scale=4.0, output_type="latent")
RUNS = {"fused": dict(fused=True), "chunked": dict(fused=True, exec_chunk=2)}


def _jax_draws(seed, shape, n):
    """The ``n`` draws JAX's fused runner makes from ``key(seed)``."""
    key, first = jax.random.split(jax.random.key(seed))
    out = [first]
    for _ in range(n - 1):
        key, k = jax.random.split(key)
        out.append(k)
    return [np.asarray(jax.random.normal(k, shape, jnp.float32))
            for k in out]


def _dry_inputs():
    rng = np.random.default_rng(60)
    f32 = lambda a: a.astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jdit.init_wan_dit(
        jax.random.key(0), jdit.WanDiTConfig(**WAN_KW)))
    head = params["head"]["head"]
    head["w"] = f32(0.05 * rng.standard_normal(head["w"].shape))
    vae = jax.tree_util.tree_map(lambda t: t.numpy(), tvae.init_wan_vae(
        torch.Generator().manual_seed(1), tvae.WanVAEConfig.tiny()))
    hw, nf = 64, 9
    return dict(
        cfg=WAN_KW, params=params, vae=vae, guide=DRY_GUIDE, kw=DRY_KW,
        draws=_jax_draws(7, (1, 4, 3, 8, 8), 1 + 2),
        inputs=dict(image=f32(rng.uniform(-1, 1, (1, 3, hw, hw))),
                    pe=f32(rng.standard_normal((1, 8, 32))),
                    ne=f32(rng.standard_normal((1, 8, 32))),
                    ie=f32(rng.standard_normal((1, 257, 64))),
                    ref=f32(rng.uniform(0, 1, (1, 3, nf, hw, hw))),
                    mask=np.ones((1, 1, nf, hw, hw), np.float32)))


@pytest.fixture(scope="module")
def dry_runs():
    """One spawn a world size: both phases on the dry run's mesh."""
    from worldforge_tpu_torch.parallel.dryrun import _pick_mesh_dims
    base = _dry_inputs()
    out = {}
    for world in (2, 4):
        mesh = _pick_mesh_dims(world)
        checks = [(name, "wan_generate", dict(base, mesh=mesh, run=run))
                  for name, run in RUNS.items()]
        out[world] = (mesh, run_spawn(world, checks, timeout=600.0))
    return base, out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(RUNS))
def test_dryrun_fused_phases_match_jax(dry_runs, world, name):
    from worldforge_tpu.core.mesh import make_mesh as jmake_mesh
    from worldforge_tpu.parallel.sharding import shard_params_fsdp
    from worldforge_tpu.pipelines.wan_i2v import WanI2VPipeline as JPipe
    from worldforge_tpu.sampling.guidance import GuidanceConfig as JGuide
    base, runs = dry_runs
    mesh_dims, ranks = runs[world]
    mesh = jmake_mesh(*mesh_dims, devices=jax.devices()[:world])
    old = jvae._CONV3D_MODE
    jvae._CONV3D_MODE = "3d"
    try:
        pipe = JPipe(
            dit_params=shard_params_fsdp(jax.tree_util.tree_map(
                jnp.asarray, base["params"]), mesh),
            dit_cfg=jdit.WanDiTConfig(**WAN_KW),
            vae_params=jax.tree_util.tree_map(jnp.asarray, base["vae"]),
            vae_cfg=jvae.WanVAEConfig.tiny(), policy=J_FP32, mesh=mesh)
        x = {k: jnp.asarray(v) for k, v in base["inputs"].items()}
        with mesh:
            want = np.asarray(pipe.generate(
                jax.random.key(7), x["image"], x["pe"], x["ne"], x["ie"],
                video_ref=x["ref"], mask=x["mask"],
                guidance=JGuide(**DRY_GUIDE), **DRY_KW, **RUNS[name]))
    finally:
        jvae._CONV3D_MODE = old
    outs = [r[name]["out"] for r in ranks]
    for r, o in zip(ranks, outs):
        assert r[name]["counts"]["all_to_all"] > 0, r[name]["counts"]
        assert _rel(o, want) < 1e-4, (world, name, _rel(o, want))
        np.testing.assert_array_equal(o, outs[0])
        if name == "chunked":
            assert len(r[name]["chunks"]) >= 2 and \
                sum(r[name]["chunks"]) == DRY_KW["num_inference_steps"]
    assert _rel(outs[0], ranks[0][name]["single"]) < 1e-4
