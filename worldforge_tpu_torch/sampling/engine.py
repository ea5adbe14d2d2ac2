"""The WorldForge denoise engine: UniPC + IRR + DSG, with the guided fuse.

Counterpart of ``worldforge_tpu/sampling/engine.py::wan_denoise_loop`` (the
host-loop engine). The fused and chunked scan runners of the JAX package work
around TPU runtime limits and are not ported.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

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
    fuse_fn(x0, i, r) -> fused x0 (guided pixel fusion); None = off.
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
                if noise_fn is not None:
                    noise = torch.as_tensor(noise_fn(tuple(x0.shape)),
                                            dtype=x0.dtype).to(x0.device)
                else:
                    noise = torch.randn(x0.shape, generator=generator,
                                        dtype=x0.dtype, device=x0.device)
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
