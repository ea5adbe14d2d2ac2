"""UniPC multistep solver with flow-matching sigmas.

Counterpart of ``worldforge_tpu/sampling/unipc.py``, restricted like it to
the configuration the WorldForge Wan pipeline uses: predict_x0=True,
prediction_type='flow_prediction', solver_order=2, solver_type='bh2',
lower_order_final=True, use_flow_sigmas=True, and only the UniP predictor
(the reference's step() never runs the corrector).

All solver coefficients are precomputed on the host in float64 numpy tables
(``make_flow_unipc_schedule``); each device update is the axpy
``x_t = c_x * x + c_m0 * m0 + c_m1 * m1`` on torch tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowUniPCSchedule:
    """Static per-run schedule + precomputed UniP coefficients."""

    sigmas: np.ndarray            # [N+1] float64, sigmas[-1] = 0
    timesteps: np.ndarray         # [N] float64 (floor(sigma * T))
    resample_timesteps: np.ndarray  # [N] int64
    num_steps: int
    c_x: np.ndarray               # [N] float64: sigma_t / sigma_s0
    c_m0_o1: np.ndarray           # [N]: order-1 m0 coefficient
    c_m0_o2: np.ndarray           # [N]: order-2 m0 coefficient
    c_m1_o2: np.ndarray           # [N]: order-2 m1 coefficient

    def order_for_step(self, i: int, lower_order_nums: int,
                       solver_order: int = 2) -> int:
        """this_order = min(min(solver_order, N-i), lower_order_nums+1)."""
        return min(min(solver_order, self.num_steps - i), lower_order_nums + 1)


def _lmbda(sigma: float) -> float:
    """lambda(sigma) for flow sigmas; +inf at sigma=0."""
    if sigma <= 0.0:
        return math.inf
    return math.log(1.0 - sigma) - math.log(sigma)


def make_flow_unipc_schedule(num_inference_steps: int, shift: float = 5.0,
                             num_train_timesteps: int = 1000,
                             solver_type: str = "bh2") -> FlowUniPCSchedule:
    """The flow-sigma schedule and UniP-bh coefficient tables (host fp64)."""
    n = num_inference_steps
    alphas = np.linspace(1.0, 1.0 / num_train_timesteps, n + 1,
                         dtype=np.float64)
    s = 1.0 - alphas
    sig = np.flip(shift * s / (1.0 + (shift - 1.0) * s))[:-1].copy()
    # the transformer sees floor(sigma*T); resample timesteps are the same
    timesteps = np.floor(sig * num_train_timesteps).astype(np.float64)
    sigmas = np.concatenate([sig, [0.0]])
    resample_ts = timesteps.astype(np.int64)

    c_x = np.zeros(n)
    c_m0_o1 = np.zeros(n)
    c_m0_o2 = np.zeros(n)
    c_m1_o2 = np.zeros(n)
    for i in range(n):
        s0, st = sigmas[i], sigmas[i + 1]
        a_t = 1.0 - st
        l_t, l_s0 = _lmbda(st), _lmbda(s0)
        h = l_t - l_s0
        hh = -h  # predict_x0
        phi1 = math.expm1(hh) if math.isfinite(hh) else -1.0
        b_h = phi1 if solver_type == "bh2" else hh
        c_x[i] = st / s0
        c_m0_o1[i] = -a_t * phi1
        if i >= 1 and math.isfinite(h) and h != 0.0:
            l_s1 = _lmbda(sigmas[i - 1])
            r1 = (l_s1 - l_s0) / h
            k = a_t * b_h * 0.5 / r1   # rhos_p = [0.5]; D1 = (m1 - m0) / r1
            c_m0_o2[i] = -a_t * phi1 + k
            c_m1_o2[i] = -k
        else:
            c_m0_o2[i] = c_m0_o1[i]
            c_m1_o2[i] = 0.0

    return FlowUniPCSchedule(
        sigmas=sigmas, timesteps=timesteps, resample_timesteps=resample_ts,
        num_steps=n, c_x=c_x, c_m0_o1=c_m0_o1, c_m0_o2=c_m0_o2,
        c_m1_o2=c_m1_o2)


def flow_pred_x0(sched: FlowUniPCSchedule, i: int, v: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """x0 = x - sigma_i * v (flow-prediction output conversion)."""
    return x - float(sched.sigmas[i]) * v


def unip_update(sched: FlowUniPCSchedule, i: int, order: int,
                x: torch.Tensor, m0: torch.Tensor,
                m1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The UniP-bh update as a static-coefficient axpy."""
    if order <= 1:
        return float(sched.c_x[i]) * x + float(sched.c_m0_o1[i]) * m0
    if m1 is None:
        raise ValueError("an order-2 update needs m1")
    return (float(sched.c_x[i]) * x + float(sched.c_m0_o2[i]) * m0
            + float(sched.c_m1_o2[i]) * m1)


def add_noise(sched: FlowUniPCSchedule, i: int, x0: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """(1 - sigma_i) * x0 + sigma_i * eps: IRR re-noises pred_x0 at the
    current step's sigma."""
    s = float(sched.sigmas[i])
    return (1.0 - s) * x0 + s * noise


def dsg_extrapolate(good: torch.Tensor, worse: torch.Tensor,
                    omega: float) -> torch.Tensor:
    """DSG directional extrapolation::

      better = good + omega*sin(theta)*(good - (|good|/|worse|)*cos(theta)*worse)

    with theta the angle between the flattened predictions (per batch)."""
    dims = tuple(range(1, good.ndim))
    gf = good.float()
    wf = worse.float()
    dot = torch.sum(gf * wf, dim=dims, keepdim=True)
    ng = torch.sqrt(torch.sum(gf * gf, dim=dims, keepdim=True))
    nw = torch.sqrt(torch.sum(wf * wf, dim=dims, keepdim=True))
    cos_t = torch.clamp(dot / (ng * nw + 1e-8), -1.0, 1.0)
    sin_t = torch.sin(torch.arccos(cos_t))
    ratio = ng / (nw + 1e-8)
    better = gf + omega * sin_t * (gf - (ratio * cos_t) * wf)
    return better.to(good.dtype)
