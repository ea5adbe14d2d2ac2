"""Flow DPM-Solver++ multistep with host-precomputed tables.

Counterpart of ``worldforge_tpu/sampling/dpm.py``, restricted like it to
the deterministic configuration of the Wan facades:
algorithm_type='dpmsolver++', prediction_type='flow_prediction',
solver_type='midpoint' (or 'heun'), solver_order <= 3,
lower_order_final=True, final_sigmas_type='zero'.

Every per-step coefficient, the sigma -> 0 final-step limit included (there
h -> inf and the update is x' = m0), is computed on the host in float64
numpy (``make_flow_dpm_schedule``); the device step is the axpy
``x' = c_x*x + c_m0*m0 + c_m1*m1 + c_m2*m2`` over the converted x0
predictions (newest first).

Math:
  x0 = x - sigma*v
  lambda = log(1-sigma) - log(sigma); h = lambda_t - lambda_s
  order 1:  x' = (s_t/s_s) x - a_t (e^-h - 1) m0
  order 2 midpoint: ... - 0.5 a_t (e^-h - 1) D1,
      D1 = (m0 - m1)/r0, r0 = (lambda_s0 - lambda_s1)/h
  order 2 heun: + a_t ((e^-h - 1)/h + 1) D1
  order 3: + a_t((e^-h-1)/h+1) D1 - a_t((e^-h-1+h)/h^2 - 0.5) D2
No pipeline calls it, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


def get_sampling_sigmas(sampling_steps: int, shift: float) -> np.ndarray:
    """The Wan facades' pre-shifted sigma grid: linspace(1, 0, N+1)[:N],
    then the time shift."""
    s = np.linspace(1.0, 0.0, sampling_steps + 1,
                    dtype=np.float64)[:sampling_steps]
    return shift * s / (1.0 + (shift - 1.0) * s)


@dataclasses.dataclass(frozen=True)
class FlowDPMSchedule:
    """Static per-run schedule + per-step DPM-Solver++ coefficients."""

    sigmas: np.ndarray       # [N+1] float64, sigmas[-1] = 0
    timesteps: np.ndarray    # [N] float64 == floor(sigma*T)
    num_steps: int
    order: np.ndarray        # [N] int: the order each step takes
    c_x: np.ndarray          # [N] float64: sigma_t / sigma_s0
    c_m0: np.ndarray         # [N]
    c_m1: np.ndarray         # [N] (zero where order < 2)
    c_m2: np.ndarray         # [N] (zero where order < 3)


def _lmbda(sigma: float) -> float:
    if sigma <= 0.0:
        return math.inf
    if sigma >= 1.0:      # the grid can start at exactly 1 (pure noise)
        return -math.inf
    return math.log(1.0 - sigma) - math.log(sigma)


def make_flow_dpm_schedule(num_inference_steps: int, shift: float = 5.0,
                           num_train_timesteps: int = 1000,
                           sigmas: Optional[np.ndarray] = None,
                           solver_order: int = 2,
                           solver_type: str = "midpoint") -> FlowDPMSchedule:
    """The flow-sigma grid and the coefficient tables.

    Default grid linspace(sigma_max, 0, N+1)[:-1] with the time shift
    (sigma_max itself shifted), or a caller's grid (e.g.
    ``get_sampling_sigmas``) shifted once more; a final sigma 0 appended;
    timesteps floored. The order at step i: warm-up min(order, i + 1),
    order 1 at the final step, at most 2 at N-2 when N < 15."""
    n = num_inference_steps
    if sigmas is None:
        s_max = 1.0 - 1.0 / num_train_timesteps
        s_max = shift * s_max / (1.0 + (shift - 1.0) * s_max)
        grid = np.linspace(s_max, 0.0, n + 1, dtype=np.float64)[:-1]
        grid = shift * grid / (1.0 + (shift - 1.0) * grid)
    else:
        grid = np.asarray(sigmas, np.float64)
        grid = shift * grid / (1.0 + (shift - 1.0) * grid)
        n = len(grid)
    sig = np.concatenate([grid, [0.0]])
    timesteps = np.floor(grid * num_train_timesteps)

    lam = np.array([_lmbda(s) for s in sig])
    alpha = 1.0 - sig

    order = np.zeros(n, np.int64)
    c_x = np.zeros(n)
    c_m0 = np.zeros(n)
    c_m1 = np.zeros(n)
    c_m2 = np.zeros(n)
    for i in range(n):
        o = min(solver_order, i + 1)
        if i == n - 1:
            o = 1
        elif i == n - 2 and n < 15:
            o = min(o, 2)
        order[i] = o

        s_t, s0 = sig[i + 1], sig[i]
        a_t = alpha[i + 1]
        if s_t == 0.0:
            # h -> inf: sigma_t/sigma_s0 -> 0, -a_t(e^-h - 1) -> a_t = 1
            c_x[i], c_m0[i] = 0.0, 1.0
            continue
        h = lam[i + 1] - lam[i]
        phi = math.exp(-h) - 1.0
        c_x[i] = s_t / s0
        c_m0[i] = -a_t * phi
        if o >= 2:
            r0 = (lam[i] - lam[i - 1]) / h
            if solver_type == "midpoint":
                d1c = -0.5 * a_t * phi          # coefficient of D1
            else:                                # heun
                d1c = a_t * (phi / h + 1.0)
            if o == 2:
                c_m0[i] += d1c / r0
                c_m1[i] = -d1c / r0
            else:
                r1 = (lam[i - 1] - lam[i - 2]) / h
                d1c = a_t * (phi / h + 1.0)      # order 3 always uses this
                d2c = -a_t * ((phi + h) / (h * h) - 0.5)
                w = r0 / (r0 + r1)
                # D1 = (1+w) D1_0 - w D1_1; D2 = (D1_0 - D1_1)/(r0+r1)
                k10, k11 = (1.0 + w) / r0, w / r1
                k20 = 1.0 / ((r0 + r1) * r0)
                k21 = 1.0 / ((r0 + r1) * r1)
                c_m0[i] += d1c * k10 + d2c * k20
                c_m1[i] = d1c * (-k10 - k11) + d2c * (-k20 - k21)
                c_m2[i] = d1c * k11 + d2c * k21
    return FlowDPMSchedule(sigmas=sig, timesteps=timesteps, num_steps=n,
                           order=order, c_x=c_x, c_m0=c_m0, c_m1=c_m1,
                           c_m2=c_m2)


def _f32(c: float) -> float:
    """A coefficient rounded to fp32, as the JAX package multiplies by
    ``jnp.float32(c)``."""
    return float(np.float32(c))


def dpm_pred_x0(sched: FlowDPMSchedule, i: int, v: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """x0 = x - sigma_i * v."""
    return x - _f32(sched.sigmas[i]) * v


def dpm_update(sched: FlowDPMSchedule, i: int, x: torch.Tensor,
               m0: torch.Tensor, m1: Optional[torch.Tensor] = None,
               m2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DPM-Solver++ step at the schedule's order. m1 / m2 are the
    previous converted outputs (newest first); None during warm-up (their
    coefficients are zero then)."""
    out = _f32(sched.c_x[i]) * x + _f32(sched.c_m0[i]) * m0
    if m1 is not None and sched.c_m1[i] != 0.0:
        out = out + _f32(sched.c_m1[i]) * m1
    if m2 is not None and sched.c_m2[i] != 0.0:
        out = out + _f32(sched.c_m2[i]) * m2
    return out


def dpm_add_noise(sched: FlowDPMSchedule, i: int, x0: torch.Tensor,
                  noise: torch.Tensor) -> torch.Tensor:
    """(1 - sigma) * x0 + sigma * noise."""
    s = _f32(sched.sigmas[i])
    return (1.0 - s) * x0 + s * noise
