"""The port's UniPC solver and denoise engine against the JAX package's.

The host tables are numpy float64 on both sides and must be equal; the
device updates run the same fp32 arithmetic (held at 1e-6). The engine runs
on both sides with the same stub model and fuse functions and the same
noise stream.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.sampling import engine as jeng
from worldforge_tpu.sampling import guidance as jgd
from worldforge_tpu.sampling import unipc as jun
from worldforge_tpu_torch.sampling import engine as teng
from worldforge_tpu_torch.sampling import guidance as tgd
from worldforge_tpu_torch.sampling import unipc as tun

torch.set_num_threads(2)


@pytest.mark.parametrize("steps,shift", [(4, 5.0), (50, 5.0), (7, 3.0)])
def test_unipc_tables_equal(steps, shift):
    a = jun.make_flow_unipc_schedule(steps, shift)
    b = tun.make_flow_unipc_schedule(steps, shift)
    for f in ("sigmas", "timesteps", "resample_timesteps", "c_x", "c_m0_o1",
              "c_m0_o2", "c_m1_o2"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert [b.order_for_step(i, min(i, 2)) for i in range(steps)] == \
        [a.order_for_step(i, min(i, 2)) for i in range(steps)]


def test_solver_updates_match(rng):
    s = jun.make_flow_unipc_schedule(6, 5.0)
    t = tun.make_flow_unipc_schedule(6, 5.0)
    x, v, m0, m1, n = (rng.standard_normal((2, 4, 3, 5, 5)).astype(
        np.float32) for _ in range(5))
    tt = [torch.from_numpy(a) for a in (x, v, m0, m1, n)]
    jj = [jnp.asarray(a) for a in (x, v, m0, m1, n)]
    for i in range(6):
        pairs = [
            (tun.flow_pred_x0(t, i, tt[1], tt[0]),
             jun.flow_pred_x0(s, i, jj[1], jj[0])),
            (tun.unip_update(t, i, 1, tt[0], tt[2]),
             jun.unip_update(s, i, 1, jj[0], jj[2])),
            (tun.unip_update(t, i, 2, tt[0], tt[2], tt[3]),
             jun.unip_update(s, i, 2, jj[0], jj[2], jj[3])),
            (tun.add_noise(t, i, tt[2], tt[4]),
             jun.add_noise(s, i, jj[2], jj[4])),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)
    for omega in (1.0, 4.0):
        np.testing.assert_allclose(
            tun.dsg_extrapolate(tt[1], tt[2], omega).numpy(),
            np.asarray(jun.dsg_extrapolate(jj[1], jj[2], omega)),
            atol=1e-6, rtol=1e-6)


def _noise(seed):
    r = np.random.default_rng(seed)
    return lambda shape: r.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("guided,cfg_on", [(True, True), (True, False),
                                           (False, True)])
def test_denoise_loop_matches_jax(guided, cfg_on):
    """Stub model (a fixed nonlinear map of the latents and the timestep)
    and stub fuse (a fixed blend), the same on both sides; the loops must
    agree to fp32 rounding (1e-5)."""
    shape = (1, 4, 3, 4, 4)
    base = np.random.default_rng(1).standard_normal(shape).astype(np.float32)

    def make(lib, asarr):
        b = asarr(base)

        def model_fn(lat, t_model, i, r):
            return lib.tanh(lat * 0.5 + b) * (t_model / 1000.0) + 0.1 * lat

        def fuse_fn(x0, i, r):
            return 0.7 * x0 + 0.3 * b

        return model_fn, (fuse_fn if guided else None)

    g = dict(guided=guided, guide_steps=3, resample_steps=3,
             resample_round=4, omega=4.0, omega_resample=1.5, use_flf=False)
    lat0 = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    s = jun.make_flow_unipc_schedule(5, 5.0)
    jm, jf = make(jnp, jnp.asarray)
    want = jeng.wan_denoise_loop(jm, jnp.asarray(lat0), s,
                                 jgd.GuidanceConfig(**g), noise_fn=_noise(3),
                                 fuse_fn=jf, record_r0=cfg_on)
    tm, tf = make(torch, torch.from_numpy)
    seen = []
    got = teng.wan_denoise_loop(tm, torch.from_numpy(lat0),
                                tun.make_flow_unipc_schedule(5, 5.0),
                                tgd.GuidanceConfig(**g), noise_fn=_noise(3),
                                fuse_fn=tf, record_r0=cfg_on,
                                callback=lambda i, lat: seen.append(i))
    assert seen == list(range(5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_denoise_loop_generator_noise_is_seeded():
    shape = (1, 2, 1, 2, 2)
    g = tgd.GuidanceConfig(guided=False, resample_steps=2, resample_round=3,
                           use_flf=False)
    s = tun.make_flow_unipc_schedule(3, 5.0)
    model = lambda lat, t, i, r: 0.5 * lat
    runs = [teng.wan_denoise_loop(model, torch.ones(shape), s, g,
                                  generator=torch.Generator().manual_seed(
                                      seed))
            for seed in (0, 0, 1)]
    torch.testing.assert_close(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_flf_is_a_later_slice():
    """FLF off selects nothing; on, before step 2 it selects nothing
    without computing flows, and from step 2 it runs the schedule (the
    selection against JAX is ``tests/test_torch_flf.py``)."""
    assert tgd.flf_select(None, None, 3, tgd.GuidanceConfig(
        use_flf=False)) == []
    on = tgd.GuidanceConfig(use_flf=True)
    assert tgd.flf_select(None, None, 1, on) == []
    rng = np.random.default_rng(0)
    ref = torch.from_numpy(rng.standard_normal((1, 4, 3, 8, 8)).astype(
        np.float32))
    pred = ref + 0.5 * torch.roll(ref, 1, dims=-1)
    assert tgd.flf_select(pred, ref, 5, on) == []       # Wan: none <= 5
    assert len(tgd.flf_select(pred, ref, 7, on)) == 1   # worst 1 <= 10
