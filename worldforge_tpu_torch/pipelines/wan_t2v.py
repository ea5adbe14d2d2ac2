"""Wan2.1 text-to-video and first-last-frame-to-video pipelines.

Counterpart of ``worldforge_tpu/pipelines/wan_t2v.py``: the plain CFG
denoise loop (``uncond + g * (cond - uncond)``) on the flow-UniPC schedule.
FLF2V (``dit_cfg.model_type == "flf2v"``) conditions on both the first and
the last frame: the [first, zeros..., last] video VAE-encoded, the mask's
frames 0 and -1 set (``pipelines/wan_i2v.py::frame_condition``, shared with
i2v), and the CLIP tokens of both frames (2 x 257) as the image context.

Noise comes from a ``torch.Generator`` on the pipeline's device, or from
``noise_fn(shape)`` (tests feed the JAX draw through it). ``streaming_vae``
decodes with ``models/wan/vae_stream.py``; the FLF2V condition is encoded
single-pass, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from worldforge_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from worldforge_tpu_torch.models.wan.dit import WanDiTConfig, wan_dit_forward
from worldforge_tpu_torch.models.wan.vae import (WanVAEConfig, vae_decode,
                                                 vae_encode)
from worldforge_tpu_torch.models.wan.vae_stream import vae_decode_streaming
from worldforge_tpu_torch.pipelines.wan_i2v import _as_tensor, frame_condition
from worldforge_tpu_torch.sampling.unipc import (flow_pred_x0,
                                                 make_flow_unipc_schedule,
                                                 unip_update)


def unipc_cfg_loop(dit: Callable, latents: torch.Tensor, sched,
                   guidance_scale: float, do_cfg: bool) -> torch.Tensor:
    """The Wan facades' denoise loop: ``dit(x, t, cond)`` with cond True /
    False for the prompt / the negative prompt, the facades' CFG
    ``uncond + g * (cond - uncond)``, UniP updates of order
    ``min(i, 2) + 1`` (order 1 at the last step)."""
    m0 = None
    for i in range(sched.num_steps):
        order = sched.order_for_step(i, min(i, 2))
        t = float(np.float32(sched.timesteps[i]))
        v = dit(latents, t, True)
        if do_cfg:
            vu = dit(latents, t, False)
            v = vu + guidance_scale * (v - vu)
        m1 = m0
        m0 = flow_pred_x0(sched, i, v, latents)
        latents = unip_update(sched, i, order, latents, m0,
                              m1 if order >= 2 else None)
    return latents


def decode_to_numpy(vae_params, vae_cfg, latents, streaming: bool
                    ) -> np.ndarray:
    """Latents -> numpy [B, 3, T, H, W] in [0, 1]."""
    if streaming:
        video = vae_decode_streaming(vae_params, vae_cfg, latents)
    else:
        video = vae_decode(vae_params, vae_cfg, latents)
    out = (video.float().cpu().numpy() + 1.0) / 2.0
    return np.clip(out, 0.0, 1.0)


@dataclasses.dataclass(eq=False)
class WanT2VPipeline:
    """Also serves flf2v when ``dit_cfg.model_type == 'flf2v'``. The device
    is the one the DiT params live on."""

    dit_params: dict
    dit_cfg: WanDiTConfig
    vae_params: dict
    vae_cfg: WanVAEConfig
    policy: Policy = DEFAULT_POLICY
    vae_scale_t: int = 4
    vae_scale_s: int = 8
    streaming_vae: bool = False

    @property
    def device(self) -> torch.device:
        return self.dit_params["patch_embedding"]["w"].device

    @torch.inference_mode()
    def generate(
        self,
        generator: Optional[torch.Generator],
        prompt_embeds,
        negative_prompt_embeds,
        *,
        height: int = 480,
        width: int = 832,
        num_frames: int = 81,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        flow_shift: float = 5.0,
        first_frame=None,                      # [B,3,H,W] in [-1,1]
        last_frame=None,
        image_embeds=None,                     # [B, 514, 1280] flf2v
        output_type: str = "np",
        noise_fn: Optional[Callable] = None,
    ):
        """Generate a video; numpy [B,3,T,H,W] in [0,1] (or the latents for
        ``output_type="latent"``). ``noise_fn(shape) -> array`` replaces the
        generator's draw of the initial latents."""
        if num_frames % self.vae_scale_t != 1:
            num_frames = num_frames // self.vae_scale_t * self.vae_scale_t + 1
        dev = self.device
        prompt_embeds = _as_tensor(prompt_embeds, dev)
        negative_prompt_embeds = _as_tensor(negative_prompt_embeds, dev)
        image_embeds = _as_tensor(image_embeds, dev)
        b = prompt_embeds.shape[0]
        do_cfg = guidance_scale > 1 and negative_prompt_embeds is not None

        sched = make_flow_unipc_schedule(num_inference_steps, flow_shift)
        t_lat = (num_frames - 1) // self.vae_scale_t + 1
        h_lat, w_lat = height // self.vae_scale_s, width // self.vae_scale_s
        shape = (b, self.dit_cfg.out_dim, t_lat, h_lat, w_lat)
        if noise_fn is not None:
            latents = _as_tensor(noise_fn(shape), dev)
        else:
            latents = torch.randn(shape, generator=generator,
                                  dtype=torch.float32, device=dev)

        cond = None
        if self.dit_cfg.model_type == "flf2v":
            if first_frame is None or last_frame is None:
                raise ValueError("flf2v needs first_frame and last_frame")
            cond = frame_condition(
                lambda v: vae_encode(self.vae_params, self.vae_cfg, v),
                _as_tensor(first_frame, dev), _as_tensor(last_frame, dev),
                num_frames, h_lat, w_lat, self.vae_scale_t)

        def dit(x, t, positive):
            ctx = prompt_embeds if positive else negative_prompt_embeds
            tb = torch.full((b,), t, dtype=torch.float32, device=dev)
            return wan_dit_forward(self.dit_params, self.dit_cfg, x.float(),
                                   tb, ctx, clip_fea=image_embeds, y=cond,
                                   policy=self.policy)

        latents = unipc_cfg_loop(dit, latents, sched, guidance_scale, do_cfg)
        if output_type == "latent":
            return latents
        return decode_to_numpy(self.vae_params, self.vae_cfg, latents,
                               self.streaming_vae)
