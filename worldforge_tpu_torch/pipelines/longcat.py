"""LongCat-Video pipeline: the 480p -> 720p refine (SDEdit upscale).

Counterpart of ``worldforge_tpu/pipelines/longcat.py`` on the refine path
(``prepare_refine_latents`` and ``generate_refine``): an align-corners
spatial upscale (and a 2x trilinear temporal one unless
``spatial_refine_only``), noise frames padded to the BSA latent
granularity, the VAE encode, a mix with noise at ``t_thresh``, the Euler
schedule truncated below ``t_thresh``, no CFG, and block-sparse attention
where the token grid factors into (4, 4, 8) chunks.

The guided i2v, t2v and video-continuation paths (``generate_i2v``,
``generate_t2v``, ``generate_vc`` with its cond-token KV cache), meshes,
``token_chunk`` > 1 and ``auto_layout`` are a later slice of the port and
raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from worldforge_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from worldforge_tpu_torch.models.longcat.dit import (LongCatDiTConfig,
                                                     longcat_dit_forward)
from worldforge_tpu_torch.models.wan.vae import WanVAEConfig
from worldforge_tpu_torch.ops.sampling import resize3d_align_corners
from worldforge_tpu_torch.pipelines.vae_dispatch import vae_fn_pair
from worldforge_tpu_torch.pipelines.wan_i2v import _as_tensor
from worldforge_tpu_torch.sampling.flow_match import (FlowMatchSchedule,
                                                      fm_euler_step,
                                                      make_flow_match_schedule)

LATER_SLICE = ("the LongCat {} path is a later slice of the port (ROADMAP "
               "Queue A: the LongCat guided i2v/t2v/vc path); the refine "
               "(generate_refine) is ported")


@dataclasses.dataclass(eq=False)
class LongCatPipeline:
    """Holds params/configs; generation is functional underneath. The
    device is the one the DiT params live on."""

    dit_params: dict
    dit_cfg: LongCatDiTConfig
    vae_params: dict
    vae_cfg: WanVAEConfig
    policy: Policy = DEFAULT_POLICY
    vae_scale_t: int = 4
    vae_scale_s: int = 8
    streaming_vae: bool = False
    streaming_vae_chunk: int = 1    # latent frames per streaming decode step
    mesh: object = None             # a later slice (the parallel layer)
    token_chunk: int = 1            # > 1: a later slice
    auto_layout: bool = False       # XLA entry layouts: no counterpart

    @property
    def device(self) -> torch.device:
        return self.dit_params["x_embedder"]["w"].device

    def _vae_fns(self):
        """(decode(z), encode(video)) closures over the VAE params."""
        dec, enc = vae_fn_pair(self.streaming_vae, self.streaming_vae_chunk)
        return ((lambda z: dec(self.vae_params, self.vae_cfg, z)),
                (lambda v: enc(self.vae_params, self.vae_cfg, v)))

    def _check_ported(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "LongCatPipeline.mesh: meshes and context parallelism are "
                "the parallel layer, a later slice of the port")
        if self.token_chunk != 1:
            raise NotImplementedError(
                "LongCatPipeline.token_chunk > 1 is a later slice of the "
                "port")
        if self.auto_layout:
            raise NotImplementedError(
                "LongCatPipeline.auto_layout sets XLA entry layouts; the "
                "port has no counterpart")

    def generate_i2v(self, *args, **kwargs):
        raise NotImplementedError(LATER_SLICE.format("guided i2v"))

    def generate_t2v(self, *args, **kwargs):
        raise NotImplementedError(LATER_SLICE.format("t2v"))

    def generate_vc(self, *args, **kwargs):
        raise NotImplementedError(LATER_SLICE.format("video continuation"))

    @torch.inference_mode()
    def prepare_refine_latents(self, stage1_video, *, height: int = 720,
                               width: int = 1280,
                               spatial_refine_only: bool = False,
                               bsa_latent_granularity: int = 4
                               ) -> torch.Tensor:
        """Upscale + pad + VAE-encode the stage-1 video [T, H_lo, W_lo, 3]
        in [0, 1] (numpy or torch); returns the latents [1, z, T', h, w]."""
        t_in = stage1_video.shape[0]
        new_t = t_in if spatial_refine_only else 2 * t_in
        vid = _as_tensor(stage1_video, self.device).permute(3, 0, 1, 2)[None]
        # align_corners=True trilinear, the reference's F.interpolate
        up = resize3d_align_corners(vid, new_t, height, width) * 2.0 - 1.0
        # pad the noise frames to the BSA granularity (no cond frames here)
        num_noise_latents = -(-new_t // self.vae_scale_t)
        num_noise_latents = (-(-num_noise_latents // bsa_latent_granularity)
                             * bsa_latent_granularity)
        frames_added = num_noise_latents * self.vae_scale_t - new_t
        if frames_added:
            up = torch.cat([up, up[:, :, -1:].expand(
                -1, -1, frames_added, -1, -1)], dim=2)
        return self._vae_fns()[1](up)

    @torch.inference_mode()
    def generate_refine(
        self,
        generator: Optional[torch.Generator],
        stage1_video,                          # [T, H_lo, W_lo, 3] in [0,1]
        prompt_embeds,                         # [B, M, caption]
        prompt_mask,                           # [B, M] or None
        *,
        height: int = 720,
        width: int = 1280,
        num_inference_steps: int = 50,
        flow_shift: float = 1.0,
        t_thresh: float = 0.5,
        spatial_refine_only: bool = False,
        bsa_latent_granularity: int = 4,
        use_bsa: bool = True,
        bsa_sparsity: float = 0.875,
        output_type: str = "np",
        stage1_latents: Optional[torch.Tensor] = None,
        noise_fn: Optional[Callable] = None,
        callback: Optional[Callable[[int, torch.Tensor], None]] = None,
    ):
        """SDEdit upscale. ``generator`` (a torch.Generator on the
        pipeline's device, or None for the global one) draws the noise;
        ``noise_fn(shape) -> array`` overrides it, so a test can feed one
        noise stream to two implementations. Pass ``stage1_latents`` (from
        ``prepare_refine_latents``) to skip the upscale and encode.
        ``callback(i, latents)`` runs after each step. Returns numpy
        [1, 3, T, H, W] in [0, 1] with the granularity padding dropped (or
        the latents for ``output_type="latent"``)."""
        self._check_ported()
        dev = self.device
        if stage1_latents is not None:
            latent_up = _as_tensor(stage1_latents, dev)
            new_t = (stage1_video.shape[0] if stage1_video is not None
                     else (latent_up.shape[2] - 1) * self.vae_scale_t + 1)
            if not spatial_refine_only and stage1_video is not None:
                new_t *= 2
        else:
            t_in = stage1_video.shape[0]
            new_t = t_in if spatial_refine_only else 2 * t_in
            latent_up = self.prepare_refine_latents(
                stage1_video, height=height, width=width,
                spatial_refine_only=spatial_refine_only,
                bsa_latent_granularity=bsa_latent_granularity)
        latent_up = latent_up.float()
        pe = _as_tensor(prompt_embeds, dev)
        pmask = _as_tensor(prompt_mask, dev, dtype=torch.int32)
        if noise_fn is not None:
            noise = _as_tensor(noise_fn(tuple(latent_up.shape)), dev)
        else:
            noise = torch.randn(latent_up.shape, generator=generator,
                                dtype=torch.float32, device=dev)
        latents = (1.0 - t_thresh) * latent_up + t_thresh * noise

        # truncated schedule: t_thresh first, then the steps below it
        base = make_flow_match_schedule(num_inference_steps, shift=flow_shift)
        keep = base.timesteps[base.timesteps < t_thresh * 1000.0]
        timesteps = np.concatenate([[t_thresh * 1000.0], keep])
        sigmas = np.concatenate([timesteps / 1000.0, [0.0]])
        sched = FlowMatchSchedule(sigmas=sigmas, timesteps=timesteps,
                                  num_steps=len(timesteps))

        t_lat = latents.shape[2]
        # BSA needs the token grid to factor into (4, 4, 8) chunks
        hw_ok = (latents.shape[3] // 2) % 4 == 0 and \
                (latents.shape[4] // 2) % 8 == 0 and t_lat % 4 == 0
        if use_bsa and not hw_ok:
            print(f"generate_refine: BSA disabled — token grid "
                  f"({t_lat}, {latents.shape[3] // 2}, "
                  f"{latents.shape[4] // 2}) does not factor into (4,4,8) "
                  f"chunks; running dense attention (pick e.g. 768x1280 -> "
                  f"48x80 tokens for the sparse path)")
        bsa_params = ({"sparsity": bsa_sparsity} if use_bsa and hw_ok
                      else None)
        for i in range(sched.num_steps):
            tb = torch.full((1, t_lat), float(sched.timesteps[i]),
                            dtype=torch.float32, device=dev)
            v = longcat_dit_forward(
                self.dit_params, self.dit_cfg, latents, tb, pe,
                encoder_attention_mask=pmask, policy=self.policy,
                bsa_params=bsa_params)
            latents = fm_euler_step(sched, i, latents, -v)
            if callback is not None:
                callback(i, latents)

        if output_type == "latent":
            return latents
        video = self._vae_fns()[0](latents)
        out = (video.float().cpu().numpy() + 1.0) / 2.0
        return np.clip(out, 0.0, 1.0)[:, :, :new_t]
