"""The port's Farneback flow (``ops/farneback.py``) against the JAX
package's and against OpenCV, on the CPU.

Same seeded uint8-scale frame pairs through both. Tolerances: 1e-4 px
against JAX (the same fp32 arithmetic in another order; measured about
5e-6), 1e-3 px against ``cv2.calcOpticalFlowFarneback``, the JAX
package's own gate (``tests/test_farneback.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.ops import farneback as jfb
from worldforge_tpu_torch.ops import farneback as tfb

torch.set_num_threads(2)


def _pairs(rng, n, h, w, shift=(2, 1)):
    """Smooth random frames and their shifted, partly re-lit copies."""
    a = rng.uniform(0, 255, (n, h, w)).astype(np.float32)
    k = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
    k /= k.sum()
    for ax in (1, 2):
        a = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax, a)
    a = np.floor(a).astype(np.float32)
    b = np.roll(a, shift, axis=(2, 1))
    b[1::2] = np.clip(np.floor(b[1::2] * 0.9 + 10), 0, 255)
    return a, b


@pytest.mark.parametrize("h,w", [(60, 104), (96, 128), (128, 128)],
                         ids=["latent-one-level", "pyramid-two-levels",
                              "pyramid-three-levels"])
def test_farneback_matches_jax(rng, h, w):
    a, b = _pairs(rng, 4, h, w)
    want = np.asarray(jfb.farneback_flow(jnp.asarray(a), jnp.asarray(b)))
    got = tfb.farneback_flow(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (4, h, w, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_farneback_nondefault_params_match_jax(rng):
    a, b = _pairs(rng, 2, 72, 96, shift=(3, -2))
    kw = dict(levels=2, winsize=9, iterations=2, poly_n=7, poly_sigma=1.5)
    want = np.asarray(jfb.farneback_flow(jnp.asarray(a), jnp.asarray(b),
                                         **kw))
    got = tfb.farneback_flow(torch.from_numpy(a), torch.from_numpy(b), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_host_tables_match_jax():
    for n, s in ((5, 1.2), (7, 1.5)):
        for x, y in zip(jfb._poly_exp_kernels(n, s),
                        tfb._poly_exp_kernels(n, s)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for k, s in ((3, 0.0), (3, 0.5), (9, 1.5), (19, 3.5)):
        np.testing.assert_array_equal(jfb._gaussian_kernel(k, s),
                                      tfb._gaussian_kernel(k, s))
    for h, w in ((60, 104), (7, 9)):
        np.testing.assert_array_equal(jfb._border_scale(h, w),
                                      tfb._border_scale(h, w))
        assert jfb._pyramid_plan(h, w, 0.5, 3) == tfb._pyramid_plan(
            h, w, 0.5, 3)
    assert len(tfb._pyramid_plan(60, 104, 0.5, 3)) == 1


@pytest.mark.parametrize("h,w", [(60, 104), (90, 160), (128, 128)])
def test_farneback_matches_cv2(rng, h, w):
    cv2 = pytest.importorskip("cv2")
    a, b = _pairs(rng, 4, h, w, shift=(-3, 2))
    want = np.stack([
        cv2.calcOpticalFlowFarneback(x.astype(np.uint8), y.astype(np.uint8),
                                     None, 0.5, 3, 15, 3, 5, 1.2, 0)
        for x, y in zip(a, b)])
    got = tfb.farneback_flow(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
