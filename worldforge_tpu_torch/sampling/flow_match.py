"""Flow-matching Euler scheduler (the LongCat path), pure functions.

Counterpart of ``worldforge_tpu/sampling/flow_match.py``. The schedule
tables are host fp64 numpy, as in the JAX package:

  standard: sigmas = linspace(0.999, 0, steps)
  distill (16-step LoRA): indices round(arange(1..16) * T/16); inference
    picks floor(linspace(0, 16, steps, endpoint=False)); sigmas =
    flip(idx)/T, shifted to end at 0
  then static shift: s' = shift*s / (1 + (shift-1)*s); terminal 0 appended
  timesteps = sigmas * num_train_timesteps
  x0 = x - sigma_i * v
  euler: x_{i+1} = x + (sigma_{i+1} - sigma_i) * v
  stochastic: x_{i+1} = (1 - sigma_{i+1}) * x0 + sigma_{i+1} * eps
  add_noise: (1 - sigma_i) * x0 + sigma_i * eps
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    sigmas: np.ndarray     # [N+1], terminal 0
    timesteps: np.ndarray  # [N]
    num_steps: int
    stochastic: bool = False


def longcat_sigmas(num_steps: int, *, use_distill: bool = False,
                   num_train_timesteps: int = 1000,
                   num_distill_steps: int = 16) -> np.ndarray:
    if use_distill:
        idx = np.round(np.arange(1, num_distill_steps + 1, dtype=np.float64)
                       * (num_train_timesteps // num_distill_steps))
        inf_idx = np.floor(np.linspace(0, num_distill_steps, num=num_steps,
                                       endpoint=False)).astype(np.int64)
        sig = np.flip(idx)[inf_idx] / num_train_timesteps
        sig = sig - sig[-1]
        return sig.astype(np.float64)
    return np.linspace(0.999, 0.0, num_steps, dtype=np.float64)


def make_flow_match_schedule(num_steps: int, *, shift: float = 1.0,
                             use_distill: bool = False,
                             num_train_timesteps: int = 1000,
                             stochastic: bool = False) -> FlowMatchSchedule:
    sig = longcat_sigmas(num_steps, use_distill=use_distill,
                         num_train_timesteps=num_train_timesteps)
    if shift != 1.0:
        sig = shift * sig / (1.0 + (shift - 1.0) * sig)
    timesteps = sig * num_train_timesteps
    sigmas = np.concatenate([sig, [0.0]])
    return FlowMatchSchedule(sigmas=sigmas, timesteps=timesteps,
                             num_steps=num_steps, stochastic=stochastic)


def fm_pred_x0(sched: FlowMatchSchedule, i: int, v: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    return x - float(sched.sigmas[i]) * v


def fm_euler_step(sched: FlowMatchSchedule, i: int, x: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    dt = float(sched.sigmas[i + 1] - sched.sigmas[i])
    return x.float() + dt * v.float()


def fm_stochastic_step(sched: FlowMatchSchedule, i: int, x0: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
    s_next = float(sched.sigmas[i + 1])
    return (1.0 - s_next) * x0 + s_next * noise


def fm_add_noise(sched: FlowMatchSchedule, i: int, x0: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
    s = float(sched.sigmas[i])
    return (1.0 - s) * x0 + s * noise


def cfg_zero_combine(v_cond: torch.Tensor, v_uncond: torch.Tensor,
                     guidance_scale: float) -> torch.Tensor:
    """CFG-zero optimized scale: st* = <v_c, v_u> / ||v_u||^2 per batch;
    pred = v_u*st* + g*(v_c - v_u*st*)."""
    b = v_cond.shape[0]
    pf = v_cond.reshape(b, -1).float()
    nf = v_uncond.reshape(b, -1).float()
    st = ((pf * nf).sum(dim=1, keepdim=True)
          / ((nf * nf).sum(dim=1, keepdim=True) + 1e-8))
    st = st.reshape((b,) + (1,) * (v_cond.ndim - 1))
    vu = v_uncond.float() * st
    out = vu + guidance_scale * (v_cond.float() - vu)
    return out.to(v_cond.dtype)
