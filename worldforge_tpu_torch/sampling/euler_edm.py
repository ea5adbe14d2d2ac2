"""EDM-style Euler discrete scheduler (SVD / DepthCrafter denoising).

Counterpart of ``worldforge_tpu/sampling/euler_edm.py``: diffusers'
EulerDiscreteScheduler in its SVD configuration. The schedule is host fp64
numpy, as in the JAX package: karras sigmas (rho 7, sigma in [0.002,
700]), continuous timesteps t = 0.25 log(sigma), v-prediction with EDM
preconditioning:

  x_in   = x / sqrt(sigma^2 + 1)                  (scale_model_input)
  x0     = v * (-sigma / sqrt(sigma^2+1)) + x / (sigma^2 + 1)
  dx     = (x - x0) / sigma
  x_next = x + (sigma_next - sigma) * dx
  init_noise_sigma = sqrt(sigma_max^2 + 1)

The coefficients are fp64 host numbers; the tensor arithmetic is fp32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EDMEulerSchedule:
    sigmas: np.ndarray       # [N+1], terminal 0
    timesteps: np.ndarray    # [N] = 0.25*log(sigma)
    num_steps: int
    init_noise_sigma: float


def make_edm_euler_schedule(num_steps: int, sigma_min: float = 0.002,
                            sigma_max: float = 700.0, rho: float = 7.0
                            ) -> EDMEulerSchedule:
    ramp = np.linspace(0, 1, num_steps, dtype=np.float64)
    min_inv = sigma_min ** (1 / rho)
    max_inv = sigma_max ** (1 / rho)
    sigmas = (max_inv + ramp * (min_inv - max_inv)) ** rho
    timesteps = 0.25 * np.log(sigmas)
    sigmas = np.concatenate([sigmas, [0.0]])
    return EDMEulerSchedule(sigmas=sigmas, timesteps=timesteps,
                            num_steps=num_steps,
                            init_noise_sigma=float(np.sqrt(sigma_max ** 2 + 1)))


def edm_scale_model_input(sched: EDMEulerSchedule, i: int,
                          x: torch.Tensor) -> torch.Tensor:
    s = float(sched.sigmas[i])
    return x / float(np.sqrt(s ** 2 + 1.0))


def edm_euler_step(sched: EDMEulerSchedule, i: int, x: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """v-prediction EDM Euler update, in fp32."""
    s = float(sched.sigmas[i])
    s_next = float(sched.sigmas[i + 1])
    c_out = float(-s / np.sqrt(s ** 2 + 1.0))
    c_skip = float(1.0 / (s ** 2 + 1.0))
    xf = x.float()
    x0 = v.float() * c_out + xf * c_skip
    d = (xf - x0) / s
    return xf + (s_next - s) * d
