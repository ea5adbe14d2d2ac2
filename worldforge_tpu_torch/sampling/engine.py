"""The WorldForge denoise engines: UniPC (Wan) and flow-match Euler
(LongCat), each with IRR, DSG and the guided fuse.

Counterpart of ``worldforge_tpu/sampling/engine.py::wan_denoise_loop`` and
``longcat_denoise_loop`` (the host-loop engines). The fused and chunked scan
runners of the JAX package work around TPU runtime limits and are not
ported.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from worldforge_tpu_torch.sampling.flow_match import (fm_add_noise,
                                                      fm_euler_step,
                                                      fm_pred_x0)
from worldforge_tpu_torch.sampling.guidance import GuidanceConfig
from worldforge_tpu_torch.sampling.unipc import (FlowUniPCSchedule, add_noise,
                                                 dsg_extrapolate,
                                                 flow_pred_x0, unip_update)


def wan_denoise_loop(
    model_fn: Callable[[torch.Tensor, float, int, int], torch.Tensor],
    latents: torch.Tensor,
    sched: FlowUniPCSchedule,
    guidance: GuidanceConfig,
    *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[Callable] = None,
    fuse_fn: Optional[Callable] = None,
    callback: Optional[Callable] = None,
    record_r0: bool = True,
) -> torch.Tensor:
    """Run the full denoise loop.

    model_fn(latents, t_model, i, r) -> velocity (CFG already applied).
    fuse_fn(x0, i, r) -> fused x0 (guided pixel fusion, FLF at r = 0);
    None = off.
    noise_fn(shape) -> IRR re-noise override (array-like); otherwise the
    noise is drawn from ``generator`` on the latents' device.
    record_r0: whether the r=0 prediction joins the DSG history (the
    reference records it only under CFG).
    """
    m0 = m1 = None
    guided_on = fuse_fn is not None

    for i in range(sched.num_steps):
        order = sched.order_for_step(i, min(i, 2))
        t_main = float(sched.timesteps[i])
        t_res = float(sched.resample_timesteps[i])

        deriv_history: List[torch.Tensor] = []
        prev_sample = None
        n_resample = (guidance.resample_steps
                      if i < guidance.resample_round else 1)

        for r in range(n_resample):
            t_model = t_main if r == 0 else t_res
            v = model_fn(latents, t_model, i, r)
            if r > 0 or record_r0:
                deriv_history.append(v)

            x0 = flow_pred_x0(sched, i, v, latents)
            if guided_on and i < guidance.guide_steps:
                x0 = fuse_fn(x0, i, r)

            if r == 0:
                m1 = m0
            m0 = x0
            # in resample mode the next-sigma index clamps to the resample
            # table, so at the FINAL step the update is the identity
            is_final = i == sched.num_steps - 1
            if r > 0 and is_final:
                prev_sample = latents
            else:
                prev_sample = unip_update(sched, i, order, latents, m0,
                                          m1 if order >= 2 else None)

            if i < guidance.resample_round and r < n_resample - 1:
                noise = _draw_noise(x0.shape, x0, generator, noise_fn)
                latents = add_noise(sched, i, x0, noise)

        if len(deriv_history) > 1:
            omega = (guidance.omega if i < guidance.guide_steps
                     else guidance.omega_resample)
            better = dsg_extrapolate(deriv_history[-1], deriv_history[0],
                                     omega)
            m0 = flow_pred_x0(sched, i, better, latents)
            if not (n_resample > 1 and i == sched.num_steps - 1):
                latents = unip_update(sched, i, order, latents, m0,
                                      m1 if order >= 2 else None)
        else:
            latents = prev_sample

        if callback is not None:
            callback(i, latents)
    return latents


def _draw_noise(shape, like: torch.Tensor, generator, noise_fn):
    if noise_fn is not None:
        return torch.as_tensor(noise_fn(tuple(shape)),
                               dtype=like.dtype).to(like.device)
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def longcat_denoise_loop(
    model_fn: Callable,
    latents: torch.Tensor,
    sched,
    guidance: GuidanceConfig,
    *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[Callable] = None,
    fuse_fn: Optional[Callable] = None,
    callback: Optional[Callable] = None,
) -> torch.Tensor:
    """LongCat i2v denoise loop: flow-match Euler with IRR and DSG on the
    noise frames, the cond latent in frame 0.

    model_fn(latents_full, t, i, r) -> the NEGATED velocity of the full
    latents (CFG-zero applied). fuse_fn(x0_full, i, r) -> fused full-latent
    x0; it runs only at r == 0 while i < guide_steps, on the full latents
    with a zeroed frame-0 velocity, and feeds the IRR re-noise (the fused x0
    at r = 0, the unfused one after). The Euler update integrates the raw
    velocity. The DSG history holds the sliced noise-frame velocity
    ``v[:, :, 1:]``. ``guided`` implies a reference: without a fuse_fn the
    call is one plain pass per step (no IRR, no DSG). The re-noise comes
    from ``noise_fn(shape)`` when given, else from ``generator`` on the
    latents' device. ``callback(i, latents)`` runs after each step."""
    guided_on = guidance.guided and fuse_fn is not None

    for i in range(sched.num_steps):
        t_val = float(sched.timesteps[i])
        deriv_history: List[torch.Tensor] = []
        prev_noise = None
        n_resample = (guidance.resample_steps
                      if (guided_on and i < guidance.resample_round) else 1)

        for r in range(n_resample):
            v = model_fn(latents, t_val, i, r)
            v_noise = v[:, :, 1:]
            deriv_history.append(v_noise)
            x_noise = latents[:, :, 1:]
            x0 = fm_pred_x0(sched, i, v_noise, x_noise)
            if guided_on and i < guidance.guide_steps and r == 0:
                v_full = torch.cat([torch.zeros_like(v[:, :, :1]), v_noise],
                                   dim=2)
                x0_full = fm_pred_x0(sched, i, v_full, latents)
                x0 = fuse_fn(x0_full, i, r)[:, :, 1:]

            prev_noise = fm_euler_step(sched, i, x_noise, v_noise)

            if i < guidance.resample_round and r < n_resample - 1:
                noise = _draw_noise(x0.shape, x0, generator, noise_fn)
                latents = torch.cat([latents[:, :, :1],
                                     fm_add_noise(sched, i, x0, noise)],
                                    dim=2)

        if (guided_on and i < guidance.resample_round
                and len(deriv_history) > 1):
            omega = (guidance.omega if i < guidance.guide_steps
                     else guidance.omega_resample)
            better = dsg_extrapolate(deriv_history[-1], deriv_history[0],
                                     omega)
            nxt = fm_euler_step(sched, i, latents[:, :, 1:], better)
        else:
            nxt = prev_noise
        latents = torch.cat([latents[:, :, :1], nxt], dim=2)
        if callback is not None:
            callback(i, latents)
    return latents
