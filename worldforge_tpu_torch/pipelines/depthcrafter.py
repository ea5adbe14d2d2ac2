"""DepthCrafter pipeline: SVD-based video depth diffusion over sliding
windows, in PyTorch.

Counterpart of ``worldforge_tpu/pipelines/depthcrafter.py`` (:44-182),
every branch kept:

  - per-frame CLIP image embeds [1, T, 1, D] (zeros without an encoder)
  - the frames noise-augmented (sigma 0.02), then VAE-encoded as the
    conditioning in ``decode_chunk_size`` chunks, RAW (no scaling factor),
    concatenated on channels with the noisy latents
  - added_time_ids = (fps 7, motion_bucket 127, noise_aug)
  - sliding windows of ``window_size`` with ``overlap``: the first window
    denoises from the initial draw; the initial draw rolls by the stride
    each window (``latents_init``); a later window re-initialises its
    overlap at step 0 from the previous result re-noised to sigma_0; the
    results blend with linspace weights over the overlap. ``t_frames <=
    window_size`` runs one window with overlap 0.
  - EDM Euler (v-prediction), CFG with zeroed conditioning when
    ``guidance_scale > 1``
  - decode in chunks; depth is the channel mean, min-max normalised
    (``normalize_depth``)

Noise comes from a ``torch.Generator`` on the pipeline's device: first the
frame noise [T, 3, H, W], then the initial latents [1, window, 4, h, w].
``noise_fn(shape) -> array`` replaces both draws, in that order, so a test
can feed the JAX package's ``k_aug`` and ``k_lat`` draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from worldforge_tpu_torch.models.depthcrafter.unet import (SVDUNetConfig,
                                                           svd_unet_forward)
from worldforge_tpu_torch.models.depthcrafter.vae import (SVDVAEConfig,
                                                          svd_vae_decode,
                                                          svd_vae_encode)
from worldforge_tpu_torch.sampling.euler_edm import (edm_euler_step,
                                                     edm_scale_model_input,
                                                     make_edm_euler_schedule)


def clip_frame_encoder(clip_params, proj_params, clip_cfg) -> Callable:
    """``encode_frames_clip`` from CLIP vision params and the visual
    projection: frames [T, 3, H, W] in [-1, 1] -> image embeds [T, D]
    (``preprocess_clip`` on the host, then ``clip_vision_image_embeds``)."""
    from worldforge_tpu_torch.models.encoders.clip_vision import (
        clip_vision_image_embeds, preprocess_clip)

    def encode(frames: torch.Tensor) -> torch.Tensor:
        arr = ((frames + 1.0) / 2.0).permute(0, 2, 3, 1).float().cpu().numpy()
        px = np.concatenate([preprocess_clip(f, clip_cfg.image_size)
                             for f in arr], axis=0)
        return clip_vision_image_embeds(
            clip_params, proj_params, clip_cfg,
            torch.from_numpy(px).to(frames.device))

    return encode


@dataclasses.dataclass
class DepthCrafterPipeline:
    """Model params and configs; the device is the one the UNet params
    live on."""

    unet_params: dict
    unet_cfg: SVDUNetConfig
    vae_params: dict
    vae_cfg: SVDVAEConfig
    encode_frames_clip: Optional[Callable] = None  # [T,3,H,W] -> [T, D]
    # exact-math transformer-block chunking (models/depthcrafter/unet.py::
    # _map_chunked), the capacity knob for long high-resolution windows;
    # 1 runs each block in one pass
    attn_chunks: int = 1

    @property
    def device(self) -> torch.device:
        return self.unet_params["conv_in"]["w"].device

    def _noise(self, generator, noise_fn, shape):
        if noise_fn is not None:
            return torch.as_tensor(np.array(noise_fn(tuple(shape))),
                                   dtype=torch.float32, device=self.device)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.device)

    def _unet(self, latents, t, ctx, add_ids):
        return svd_unet_forward(self.unet_params, self.unet_cfg, latents, t,
                                ctx, add_ids, attn_chunks=self.attn_chunks)

    @torch.inference_mode()
    def __call__(
        self,
        generator: Optional[torch.Generator],
        video: np.ndarray,               # [T, H, W, 3] in [0, 1]
        *,
        num_inference_steps: int = 25,
        guidance_scale: float = 1.0,
        window_size: int = 110,
        overlap: int = 25,
        noise_aug_strength: float = 0.02,
        decode_chunk_size: int = 8,
        noise_fn: Optional[Callable] = None,
    ) -> np.ndarray:
        """Returns decoded frames [T, H, W, 3] in [-1, 1] (depth is the
        channel mean, normalised by the caller)."""
        dev = self.device
        t_frames, H, W, _ = video.shape
        if t_frames <= window_size:
            window_size, overlap = t_frames, 0
        stride = window_size - overlap

        frames = torch.as_tensor(np.ascontiguousarray(
            video.transpose(0, 3, 1, 2)), dtype=torch.float32, device=dev)
        frames = frames * 2.0 - 1.0

        if self.encode_frames_clip is not None:
            clip_embeds = torch.as_tensor(self.encode_frames_clip(frames),
                                          dtype=torch.float32, device=dev)
        else:
            clip_embeds = torch.zeros(
                (t_frames, self.unet_cfg.cross_attention_dim),
                dtype=torch.float32, device=dev)
        ctx_all = clip_embeds[None, :, None, :]  # [1, T, 1, D]

        frames_aug = frames + noise_aug_strength * self._noise(
            generator, noise_fn, frames.shape)
        cond_latents = [
            svd_vae_encode(self.vae_params, self.vae_cfg,
                           frames_aug[s0:s0 + decode_chunk_size], scale=False)
            for s0 in range(0, t_frames, decode_chunk_size)]
        # the RAW latent_dist.mode(): no scaling factor here
        video_latents = torch.cat(cond_latents, dim=0)[None]  # [1,T,4,h,w]

        sched = make_edm_euler_schedule(num_inference_steps)
        add_ids = torch.tensor([[7.0, 127.0, noise_aug_strength]],
                               dtype=torch.float32, device=dev)
        do_cfg = guidance_scale > 1.0

        zc = self.vae_cfg.latent_channels
        latents_init = self._noise(
            generator, noise_fn, (1, window_size, zc, H // 8, W // 8)
        ) * sched.init_noise_sigma

        latents_all = None
        idx_start = 0
        weights = (torch.linspace(0, 1, overlap, device=dev).reshape(
            1, overlap, 1, 1, 1) if overlap > 0 else None)

        while idx_start < t_frames - overlap or latents_all is None:
            idx_end = min(idx_start + window_size, t_frames)
            latents = latents_init[:, : idx_end - idx_start]
            latents_init = torch.cat(
                [latents_init[:, -overlap:] if overlap
                 else latents_init[:, :0], latents_init[:, :stride]], dim=1)

            cond_cur = video_latents[:, idx_start:idx_end]
            ctx_cur = ctx_all[:, idx_start:idx_end]

            for i in range(sched.num_steps):
                if latents_all is not None and i == 0 and overlap > 0:
                    patch = (latents_all[:, -overlap:]
                             + latents[:, :overlap] / sched.init_noise_sigma
                             * float(sched.sigmas[0]))
                    latents = torch.cat([patch, latents[:, overlap:]], dim=1)

                t_cont = float(sched.timesteps[i])
                x_in = edm_scale_model_input(sched, i, latents)
                model_in = torch.cat([x_in, cond_cur], dim=2)
                v = self._unet(model_in, t_cont, ctx_cur, add_ids)
                if do_cfg:
                    model_in_u = torch.cat([x_in, torch.zeros_like(x_in)],
                                           dim=2)
                    vu = self._unet(model_in_u, t_cont,
                                    torch.zeros_like(ctx_cur), add_ids)
                    v = vu + guidance_scale * (v - vu)
                latents = edm_euler_step(sched, i, latents, v)

            if latents_all is None:
                latents_all = latents
            else:
                blended = (latents[:, :overlap] * weights
                           + latents_all[:, -overlap:] * (1 - weights))
                latents_all = torch.cat(
                    [latents_all[:, :-overlap], blended,
                     latents[:, overlap:]], dim=1)
            idx_start += stride
            if idx_end >= t_frames:
                break

        lat_flat = latents_all[0]
        outs = [svd_vae_decode(self.vae_params, self.vae_cfg,
                               lat_flat[s0:s0 + decode_chunk_size])
                for s0 in range(0, lat_flat.shape[0], decode_chunk_size)]
        frames_out = torch.cat(outs, dim=0)  # [T, 3, H, W]
        return np.ascontiguousarray(
            frames_out.permute(0, 2, 3, 1).float().cpu().numpy())


def normalize_depth(frames: np.ndarray) -> np.ndarray:
    """Channel mean + min-max normalisation (host numpy)."""
    depth = frames.mean(axis=-1)
    lo, hi = depth.min(), depth.max()
    return (depth - lo) / max(hi - lo, 1e-8)
