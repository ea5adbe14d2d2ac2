"""VACE generation: context preparation and the denoise loop.

Counterpart of ``worldforge_tpu/pipelines/wan_vace.py``:
  - ``prepare_vace_context``: the source split by its mask into the
    inactive (frames * (1 - m)) and reactive (frames * m) videos, each
    VAE-encoded (16 + 16 channels), and the mask pixel-shuffled 8 x 8 into
    64 channels (``encode_vace_masks``): a 96-channel context, optionally
    prefixed by reference-image latent frames;
  - ``WanVacePipeline.generate``: the Wan facades' CFG loop on flow-UniPC
    (``pipelines/wan_t2v.py::unipc_cfg_loop``) over ``vace_forward``.
Noise comes from a ``torch.Generator`` or from ``noise_fn(shape)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from worldforge_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from worldforge_tpu_torch.models.wan.vace import VaceConfig, vace_forward
from worldforge_tpu_torch.models.wan.vae import WanVAEConfig, vae_encode
from worldforge_tpu_torch.ops.sampling import jax_nearest_index
from worldforge_tpu_torch.pipelines.wan_i2v import _as_tensor
from worldforge_tpu_torch.pipelines.wan_t2v import (decode_to_numpy,
                                                    unipc_cfg_loop)
from worldforge_tpu_torch.sampling.unipc import make_flow_unipc_schedule


def encode_vace_masks(masks: torch.Tensor, vae_stride=(4, 8, 8)
                      ) -> torch.Tensor:
    """[B, 1, T, H, W] {0, 1} -> [B, 64, (T+3)//4, H/8, W/8]: the 8 x 8
    pixel-shuffle into channels, then the nearest temporal resize of
    ``jax.image.resize``."""
    b, _, t, h, w = masks.shape
    st, sh, sw = vae_stride
    new_t = (t + 3) // st
    hh, ww = h // sh, w // sw
    m = masks[:, 0].reshape(b, t, hh, sh, ww, sw)
    m = m.permute(0, 3, 5, 1, 2, 4).reshape(b, sh * sw, t, hh, ww)
    if new_t == t:
        return m
    return m[:, :, jax_nearest_index(t, new_t, m.device)]


def prepare_vace_context(frames: torch.Tensor, masks: Optional[torch.Tensor],
                         vae_params, vae_cfg: WanVAEConfig,
                         ref_images: Optional[List[torch.Tensor]] = None
                         ) -> torch.Tensor:
    """frames [B,3,T,H,W] in [-1,1]; masks [B,1,T,H,W] (None: all ones);
    ref_images: a list of [B,3,1,H,W] -> vace_context [B, 96, R + T', H/8,
    W/8]. Each reference image is one latent frame in front: its latent in
    the inactive half, zeros in the reactive half and the mask channels."""
    if masks is None:
        masks = torch.ones(frames.shape[:1] + (1,) + frames.shape[2:],
                           dtype=frames.dtype, device=frames.device)
    m = torch.where(masks > 0.5, 1.0, 0.0).to(frames.dtype)
    inactive = vae_encode(vae_params, vae_cfg, frames * (1.0 - m))
    reactive = vae_encode(vae_params, vae_cfg, frames * m)
    t_lat = inactive.shape[2]
    mask_enc = encode_vace_masks(m)[:, :, :t_lat].to(inactive.dtype)
    if ref_images:
        ref = torch.cat([vae_encode(vae_params, vae_cfg, r)
                         for r in ref_images], dim=2)     # [B, z, R, h, w]
        inactive = torch.cat([ref, inactive], dim=2)
        reactive = torch.cat([torch.zeros_like(ref), reactive], dim=2)
        mpad = torch.zeros(mask_enc.shape[:2] + (ref.shape[2],)
                           + mask_enc.shape[3:], dtype=mask_enc.dtype,
                           device=mask_enc.device)
        mask_enc = torch.cat([mpad, mask_enc], dim=2)
    return torch.cat([inactive, reactive, mask_enc], dim=1)


@dataclasses.dataclass(eq=False)
class WanVacePipeline:
    """The device is the one the VACE params live on."""

    vace_params: dict
    vace_cfg: VaceConfig
    vae_params: dict
    vae_cfg: WanVAEConfig
    policy: Policy = DEFAULT_POLICY
    vae_scale_t: int = 4
    vae_scale_s: int = 8
    streaming_vae: bool = False

    @property
    def device(self) -> torch.device:
        return self.vace_params["patch_embedding"]["w"].device

    @torch.inference_mode()
    def generate(
        self,
        generator: Optional[torch.Generator],
        src_video,                             # [B,3,T,H,W] in [-1,1]
        src_mask,                              # [B,1,T,H,W] (1 = edit)
        prompt_embeds,
        negative_prompt_embeds,
        *,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        flow_shift: float = 5.0,
        context_scale: float = 1.0,
        output_type: str = "np",
        noise_fn: Optional[Callable] = None,
    ):
        """Edit ``src_video`` where ``src_mask`` is 1; numpy [B,3,T,H,W] in
        [0,1] (or the latents for ``output_type="latent"``).
        ``noise_fn(shape) -> array`` replaces the generator's draw."""
        dev = self.device
        src_video = _as_tensor(src_video, dev)
        src_mask = _as_tensor(src_mask, dev)
        prompt_embeds = _as_tensor(prompt_embeds, dev)
        negative_prompt_embeds = _as_tensor(negative_prompt_embeds, dev)
        b, _, _, h, w = src_video.shape
        do_cfg = guidance_scale > 1 and negative_prompt_embeds is not None

        vace_context = prepare_vace_context(src_video, src_mask,
                                            self.vae_params, self.vae_cfg)
        sched = make_flow_unipc_schedule(num_inference_steps, flow_shift)
        shape = (b, self.vace_cfg.base.out_dim, vace_context.shape[2],
                 h // self.vae_scale_s, w // self.vae_scale_s)
        if noise_fn is not None:
            latents = _as_tensor(noise_fn(shape), dev)
        else:
            latents = torch.randn(shape, generator=generator,
                                  dtype=torch.float32, device=dev)

        def dit(x, t, positive):
            ctx = prompt_embeds if positive else negative_prompt_embeds
            tb = torch.full((b,), t, dtype=torch.float32, device=dev)
            return vace_forward(self.vace_params, self.vace_cfg, x, tb,
                                vace_context, ctx,
                                vace_context_scale=context_scale,
                                policy=self.policy)

        latents = unipc_cfg_loop(dit, latents, sched, guidance_scale, do_cfg)
        if output_type == "latent":
            return latents
        return decode_to_numpy(self.vae_params, self.vae_cfg, latents,
                               self.streaming_vae)
