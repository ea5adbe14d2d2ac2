"""The port's whole-loop runners (``sampling/engine.py``: the per-step
tables, the chunk plans and their sizing, the step bodies and the scans)
against the JAX package's, on the CPU.

- Tables and chunk plans: equal to JAX's, element for element.
- ``auto_exec_chunk``: equal to JAX's on ``tests/test_exec_chunk_auto.py``'s
  cases once the port's cost tables are replaced by the JAX module's (read
  from it here: no TPU number is written in the port); with the port's own
  tables and no limit, one chunk.
- ``wan_denoise_scan`` / ``longcat_denoise_scan`` with a small model
  function, a pixel-free fuse and FLF's device masks on made-up scores:
  equal to JAX's scans to 1e-6 relative. JAX draws the IRR re-noise inside
  its scan from the carried key (one split a draw); the port gets the same
  draws through ``noise_fn``. Chunked runs (``exec_chunk`` 1, 2, 3) equal
  the one-chunk run bit for bit, and the Wan scan matches the port's host
  loop to 1e-5 (``tests/test_engine_scan.py``'s gate).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.sampling import channel_select as jcs
from worldforge_tpu.sampling import engine as jeng
from worldforge_tpu.sampling.flow_match import \
    make_flow_match_schedule as j_fm
from worldforge_tpu.sampling.guidance import GuidanceConfig as JGuide
from worldforge_tpu.sampling.unipc import make_flow_unipc_schedule as j_unipc
from worldforge_tpu_torch.sampling import channel_select as tcs
from worldforge_tpu_torch.sampling import engine as teng
from worldforge_tpu_torch.sampling.flow_match import \
    make_flow_match_schedule as t_fm
from worldforge_tpu_torch.sampling.guidance import GuidanceConfig as TGuide
from worldforge_tpu_torch.sampling.unipc import \
    make_flow_unipc_schedule as t_unipc

SHAPE = (1, 4, 2, 4, 4)
LC_SHAPE = (1, 4, 3, 4, 4)
# (resample_steps, guide_steps, resample_round): tests/test_engine_scan.py's
CASES = [(2, 4, 5), (1, 3, 0), (3, 8, 8), (2, 8, 4)]
TOL = 1e-6


def _guides(**kw):
    return JGuide(**kw), TGuide(**kw)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_tables_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _assert_plans_equal(got, want):
    assert [(sf, si) for sf, si, _ in got] == [(sf, si) for sf, si, _ in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        _assert_tables_equal(g, w)


# ------------------------------------------------------------ tables, plans


@pytest.mark.parametrize("fuse_on", [True, False])
@pytest.mark.parametrize("rs,guide,rround", CASES)
def test_wan_tables_match_jax(rs, guide, rround, fuse_on):
    jg, tg = _guides(guided=True, resample_steps=rs, guide_steps=guide,
                     resample_round=rround, omega=4.0, omega_resample=1.0)
    js, jt, jgs, jrr = jeng._wan_tables(j_unipc(8, 5.0), jg, fuse_on)
    ts, tt, tgs, trr = teng._wan_tables(t_unipc(8, 5.0), tg, fuse_on)
    assert (ts, tgs, trr) == (js, jgs, jrr)
    _assert_tables_equal(tt, jt)
    _assert_tables_equal(teng._order_coeffs(t_unipc(8, 5.0)),
                         jeng._order_coeffs(j_unipc(8, 5.0)))


@pytest.mark.parametrize("guided", [True, False])
@pytest.mark.parametrize("distill", [True, False])
def test_longcat_tables_match_jax(guided, distill):
    jg, tg = _guides(guided=guided, resample_steps=2, guide_steps=3,
                     resample_round=5, omega=1.8)
    for fuse_on in (True, False):
        js, jt, jgs, jrr = jeng._longcat_tables(
            j_fm(16 if distill else 7, shift=1.0, use_distill=distill), jg,
            fuse_on)
        ts, tt, tgs, trr = teng._longcat_tables(
            t_fm(16 if distill else 7, shift=1.0, use_distill=distill), tg,
            fuse_on)
        assert (ts, tgs, trr) == (js, jgs, jrr)
        _assert_tables_equal(tt, jt)


@pytest.mark.parametrize("exec_chunk", [1, 2, 4, 6, 10 ** 9])
@pytest.mark.parametrize("fuse_cost", [0.5, 3.0])
def test_chunk_plans_match_jax(exec_chunk, fuse_cost):
    """The production shapes of ``tests/test_engine_scan.py``: Wan 50 steps
    (guide 15, resample_round 20), LongCat's 16-step distill table."""
    jg, tg = _guides(guided=True, guide_steps=15, resample_steps=2,
                     resample_round=20)
    for fuse_on in (True, False):
        _assert_plans_equal(
            teng.wan_scan_chunks(t_unipc(50, 5.0), tg, fuse_on, exec_chunk,
                                 fuse_cost=fuse_cost),
            jeng.wan_scan_chunks(j_unipc(50, 5.0), jg, fuse_on, exec_chunk,
                                 fuse_cost=fuse_cost))
        lj, lt = (dataclasses.replace(g, flf_backend="longcat")
                  for g in (jg, tg))
        _assert_plans_equal(
            teng.longcat_scan_chunks(t_fm(16, shift=1.0, use_distill=True),
                                     lt, fuse_on, exec_chunk,
                                     fuse_cost=fuse_cost),
            jeng.longcat_scan_chunks(j_fm(16, shift=1.0, use_distill=True),
                                     lj, fuse_on, exec_chunk,
                                     fuse_cost=fuse_cost))


def test_chunk_plan_cost_weighting():
    """``tests/test_engine_scan.py``'s pins on the port: guided chunks of 1,
    IRR-only chunks of 2, plain chunks of 4, every step once in order."""
    tg = TGuide(guided=True, guide_steps=15, resample_steps=2,
                resample_round=20)
    plan = teng.wan_scan_chunks(t_unipc(50, 5.0), tg, fuse_on=True,
                                exec_chunk=4)
    sizes = [(sf, si, len(xs[0])) for sf, si, xs in plan]
    assert sizes[:15] == [(True, True, 1)] * 15
    assert sizes[15:18] == [(False, True, 2), (False, True, 2),
                            (False, True, 1)]
    assert sizes[18:] == [(False, False, 4)] * 7 + [(False, False, 2)]
    steps = np.concatenate([xs[-1] for _, _, xs in plan])
    np.testing.assert_array_equal(steps, np.arange(50, dtype=np.float32))


AUTO_CASES = [
    ("wan", 20280, 480 * 832, None),
    ("wan", 46800, 720 * 1280, None),
    ("wan", 46800, 0, None),
    ("longcat", 20280, 480 * 832, dict(distill=True)),
    ("longcat-bsa", 56320, 0, None),
    ("wan", 7800, 480 * 832, dict(resample_steps=3)),
    ("wan", 20280, 0, None),
]


@pytest.mark.parametrize("model,tokens,pixels,gkw", AUTO_CASES)
def test_auto_exec_chunk_matches_jax(monkeypatch, model, tokens, pixels,
                                     gkw):
    """With the JAX module's cost tables and watchdog the port's plan is
    JAX's; the tables are read from the JAX module, not written here."""
    monkeypatch.setattr(teng, "STEP_COST_ANCHORS", jeng.STEP_COST_ANCHORS)
    monkeypatch.setattr(teng, "FUSE_COST_ANCHORS", jeng.FUSE_COST_ANCHORS)
    kw = dict(fuse_pixels=pixels, watchdog_s=jeng.WATCHDOG_SECONDS)
    jg, tg = (None, None) if gkw is None else _guides(**gkw)
    want = jeng.auto_exec_chunk(model, tokens, guidance=jg, **kw)
    got = teng.auto_exec_chunk(model, tokens, guidance=tg, **kw)
    assert got.exec_chunk == want.exec_chunk
    assert got.fits_watchdog == want.fits_watchdog
    for f in ("fuse_cost", "plain_step_s", "fuse_s", "max_chunk_s"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)


def test_auto_exec_chunk_defaults_to_one_chunk():
    """The card has no execution watchdog: by default every plan is one
    chunk, JAX's "watchdog-free runtime" branch; a limit still sizes it."""
    assert math.isinf(teng.WATCHDOG_SECONDS)
    for model in teng.STEP_COST_ANCHORS:
        plan = teng.auto_exec_chunk(model, 20280, fuse_pixels=480 * 832)
        assert plan.exec_chunk == 10 ** 9 and plan.fits_watchdog
        assert isinstance(plan, teng.ExecChunkPlan)
    limited = teng.auto_exec_chunk("wan", 20280, watchdog_s=20.0)
    assert limited.exec_chunk == max(1, int(16.0 / limited.plain_step_s))
    for model, anchors in teng.STEP_COST_ANCHORS.items():
        for tokens, cost in anchors:
            assert teng.auto_exec_chunk(model, tokens).plain_step_s == \
                pytest.approx(cost, rel=1e-9)


# ------------------------------------------------------------------- scans


def _jax_key_draws(seed):
    """The draws JAX's scans make from ``key``: one split a draw."""
    state = {"k": jax.random.key(seed)}

    def draw(shape):
        state["k"], kn = jax.random.split(state["k"])
        return np.asarray(jax.random.normal(kn, tuple(shape), jnp.float32))
    return draw


def _wan_fns(which):
    """A small model, a fuse and FLF on made-up scores (minus the mean
    |pre - fused| of each channel), for JAX's scan or the port's."""
    if which == "jax":
        model = lambda lat, t: jnp.tanh(0.3 * lat) * (0.5 + t / 1000.0)
        fuse = lambda x, step: 0.9 * x + 0.1 * jnp.sin(x)

        def flf(pre, fused, step):
            s = -jnp.mean(jnp.abs(pre - fused), axis=(0, 2, 3, 4))
            m = jcs.select_mask_wan_device(s, step)[None, :, None, None, None]
            return fused * (1.0 - m) + pre * m
        return model, fuse, flf
    model = lambda lat, t: torch.tanh(0.3 * lat) * (0.5 + t / 1000.0)
    fuse = lambda x, step: 0.9 * x + 0.1 * torch.sin(x)

    def flf(pre, fused, step):
        s = -torch.mean(torch.abs(pre - fused), dim=(0, 2, 3, 4))
        m = tcs.select_mask_wan_device(s, step)
        mb = m[None, :, None, None, None]
        return fused * (1.0 - mb) + pre * mb, m
    return model, fuse, flf


@pytest.mark.parametrize("record_r0", [True, False])
@pytest.mark.parametrize("rs,guide,rround", CASES)
def test_wan_scan_matches_jax(rs, guide, rround, record_r0):
    n = 8
    jg, tg = _guides(guided=True, resample_steps=rs, guide_steps=guide,
                     resample_round=rround, omega=4.0, omega_resample=1.0)
    x0 = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    jm, jf, jflf = _wan_fns("jax")
    want = np.asarray(jeng.wan_denoise_scan(
        jm, jnp.asarray(x0), j_unipc(n, 5.0), jg, key=jax.random.key(7),
        fuse_fn=jf, flf_fn=jflf, record_r0=record_r0))
    tm, tf, tflf = _wan_fns("torch")
    masks = {}
    run = lambda **kw: teng.wan_denoise_scan(
        tm, torch.from_numpy(x0), t_unipc(n, 5.0), tg, fuse_fn=tf,
        flf_fn=tflf, record_r0=record_r0, noise_fn=_jax_key_draws(7), **kw)
    got = run(on_step=lambda i, c, m: masks.__setitem__(i, m))
    assert _rel(got, want) < TOL, _rel(got, want)
    # FLF ran at the guided steps, and handed channels back from step 6
    assert sorted(masks) == list(range(n))
    assert all((masks[i] is not None) == (i < min(guide, n))
               for i in range(n))
    if guide >= 7:
        assert masks[6].sum() >= 1
    for k in (1, 2, 3):
        assert torch.equal(run(exec_chunk=k), got), k


@pytest.mark.parametrize("rs,guide,rround", CASES)
def test_wan_scan_matches_loop(rs, guide, rround):
    """The port's scan against its own host loop (FLF off), as
    ``tests/test_engine_scan.py`` holds JAX's."""
    n = 8
    tg = TGuide(guided=True, resample_steps=rs, guide_steps=guide,
                resample_round=rround, omega=4.0, omega_resample=1.0,
                use_flf=False)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        SHAPE).astype(np.float32))
    tm, tf, _ = _wan_fns("torch")
    loop = teng.wan_denoise_loop(
        lambda lat, t, i, r: tm(lat, torch.tensor(t, dtype=torch.float32)),
        x0, t_unipc(n, 5.0), tg, fuse_fn=lambda x, i, r: tf(x, i),
        noise_fn=_jax_key_draws(3))
    scan = teng.wan_denoise_scan(tm, x0, t_unipc(n, 5.0), tg, fuse_fn=tf,
                                 noise_fn=_jax_key_draws(3))
    np.testing.assert_allclose(scan.numpy(), loop.numpy(), atol=1e-5,
                               rtol=1e-5)


def _lc_fns(which, distill):
    """A small negated-velocity model and a fuse with FLF inside."""
    if which == "jax":
        model = lambda lat, t: -jnp.tanh(0.2 * lat) * (0.4 + t / 1000.0)

        def fuse(x, step):
            fused = 0.8 * x + 0.2 * jnp.cos(x)
            s = -jnp.mean(jnp.abs(x - fused), axis=(0, 2, 3, 4))
            m = jcs.select_mask_longcat_device(s, step, distill, 2)
            m = m[None, :, None, None, None]
            return fused * (1.0 - m) + x * m
        return model, fuse
    model = lambda lat, t: -torch.tanh(0.2 * lat) * (0.4 + t / 1000.0)

    def fuse(x, step):
        fused = 0.8 * x + 0.2 * torch.cos(x)
        s = -torch.mean(torch.abs(x - fused), dim=(0, 2, 3, 4))
        m = tcs.select_mask_longcat_device(s, step, distill, 2)
        m = m[None, :, None, None, None]
        return fused * (1.0 - m) + x * m
    return model, fuse


@pytest.mark.parametrize("guided", [True, False])
@pytest.mark.parametrize("distill", [True, False])
def test_longcat_scan_matches_jax(guided, distill):
    n = 6
    jg, tg = _guides(guided=guided, resample_steps=2, guide_steps=4,
                     resample_round=5, omega=1.8, omega_resample=1.0,
                     flf_backend="longcat", distill=distill)
    x0 = np.random.default_rng(2).standard_normal(LC_SHAPE).astype(
        np.float32)
    jm, jf = _lc_fns("jax", distill)
    want = np.asarray(jeng.longcat_denoise_scan(
        jm, jnp.asarray(x0), j_fm(n, shift=1.0, use_distill=distill), jg,
        key=jax.random.key(5), fuse_fn=jf))
    tm, tf = _lc_fns("torch", distill)
    run = lambda **kw: teng.longcat_denoise_scan(
        tm, torch.from_numpy(x0), t_fm(n, shift=1.0, use_distill=distill),
        tg, fuse_fn=tf, noise_fn=_jax_key_draws(5), **kw)
    got = run()
    assert _rel(got, want) < TOL, _rel(got, want)
    np.testing.assert_array_equal(got[:, :, :1].numpy(), x0[:, :, :1])
    for k in (1, 2, 3):
        assert torch.equal(run(exec_chunk=k), got), k


def test_run_plan_graphs_needs_the_card():
    """The graph runner takes a carry on the card only; ``run_plan``
    chooses it there and runs the CPU eagerly."""
    from worldforge_tpu_torch.runtime.step_graph import run_plan_graphs
    plan = teng.wan_scan_chunks(t_unipc(2, 5.0), TGuide(guided=False),
                                False, 10 ** 9)
    carry = (torch.zeros(SHAPE),) * 3
    with pytest.raises(ValueError, match="carry is on cpu"):
        run_plan_graphs(plan, lambda sf, si: None, carry)
