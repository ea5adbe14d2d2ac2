"""The port's flow-matching scheduler and align-corners resize against the
JAX package's, on the CPU.

The schedule tables are the same host fp64 numpy code on both sides and
must be equal. The step functions are fp32 elementwise formulas (held at
1e-6 relative); the resize is a gather plus a lerp whose fp32 weights come
from two linspace implementations (held at 1e-5 of the range).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.ops import sampling as jsampling
from worldforge_tpu.sampling import flow_match as jfm
from worldforge_tpu_torch.ops import sampling as tsampling
from worldforge_tpu_torch.sampling import flow_match as tfm

torch.set_num_threads(2)


@pytest.mark.parametrize("steps,shift,distill", [
    (50, 1.0, False), (26, 1.0, False), (4, 1.0, False), (16, 1.0, True),
    (8, 1.0, True), (12, 3.0, False), (16, 5.0, True)])
def test_schedules_equal_jax(steps, shift, distill):
    want = jfm.make_flow_match_schedule(steps, shift=shift,
                                        use_distill=distill)
    got = tfm.make_flow_match_schedule(steps, shift=shift,
                                       use_distill=distill)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_array_equal(got.timesteps, want.timesteps)
    assert got.num_steps == want.num_steps and got.sigmas.dtype == np.float64
    np.testing.assert_array_equal(
        tfm.longcat_sigmas(steps, use_distill=distill),
        jfm.longcat_sigmas(steps, use_distill=distill))


def test_steps_and_cfg_zero_match_jax(rng):
    sched = tfm.make_flow_match_schedule(10, shift=2.0)
    jsched = jfm.make_flow_match_schedule(10, shift=2.0)
    x, v, x0, eps, vu = (rng.standard_normal((2, 4, 3, 6, 8)).astype(
        np.float32) for _ in range(5))
    t = torch.from_numpy
    j = jnp.asarray
    pairs = [
        (tfm.fm_pred_x0(sched, 3, t(v), t(x)), jfm.fm_pred_x0(
            jsched, 3, j(v), j(x))),
        (tfm.fm_euler_step(sched, 3, t(x), t(v)), jfm.fm_euler_step(
            jsched, 3, j(x), j(v))),
        (tfm.fm_stochastic_step(sched, 3, t(x0), t(eps)),
         jfm.fm_stochastic_step(jsched, 3, j(x0), j(eps))),
        (tfm.fm_add_noise(sched, 3, t(x0), t(eps)), jfm.fm_add_noise(
            jsched, 3, j(x0), j(eps))),
        (tfm.cfg_zero_combine(t(v), t(vu), 4.0), jfm.cfg_zero_combine(
            j(v), j(vu), 4.0)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert got.dtype == torch.float32 and rel < 1e-6, rel


@pytest.mark.parametrize("shape_in,shape_out", [
    ((5, 16, 16), (5, 32, 32)), ((4, 12, 20), (8, 30, 44)),
    ((6, 40, 48), (3, 17, 24)), ((1, 8, 8), (1, 8, 8))])
def test_resize3d_align_corners_matches_jax(rng, shape_in, shape_out):
    x = rng.uniform(-1, 1, (1, 3) + shape_in).astype(np.float32)
    want = np.asarray(jsampling.resize3d_align_corners(jnp.asarray(x),
                                                       *shape_out))
    got = tsampling.resize3d_align_corners(torch.from_numpy(x), *shape_out)
    assert got.shape == want.shape == (1, 3) + shape_out
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # align corners: the corner samples are copied exactly
    np.testing.assert_array_equal(got.numpy()[..., 0, 0, 0], x[..., 0, 0, 0])
    np.testing.assert_array_equal(got.numpy()[..., -1, -1, -1],
                                  x[..., -1, -1, -1])
