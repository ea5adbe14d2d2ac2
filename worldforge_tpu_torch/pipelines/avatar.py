"""Avatar (audio-driven talking-head) generation.

Counterpart of ``worldforge_tpu/pipelines/avatar.py``: the base LongCat i2v
recipe with the avatar DiT. The first latent frame is the VAE-encoded
reference image with t = 0; CFG is the CFG-zero combination; the velocity
is negated and the flow-match Euler step runs on the noise frames only;
every block takes the per-latent-frame audio tokens.

Audio: waveform -> wav2vec2 (features resampled to the video frame count)
-> per-frame sliding windows (``encode_audio_windows``) -> the DiT's audio
projection. Noise comes from a ``torch.Generator`` on the pipeline's
device, or from ``noise_fn(shape)`` (tests feed the JAX draw through it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from worldforge_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from worldforge_tpu_torch.models.encoders.wav2vec2 import (Wav2Vec2Config,
                                                           get_audio_windows,
                                                           wav2vec2_forward)
from worldforge_tpu_torch.models.longcat.avatar import (AvatarConfig,
                                                        avatar_dit_forward)
from worldforge_tpu_torch.models.wan.vae import (WanVAEConfig, vae_decode,
                                                 vae_encode)
from worldforge_tpu_torch.pipelines.wan_i2v import _as_tensor
from worldforge_tpu_torch.sampling.flow_match import (cfg_zero_combine,
                                                      fm_euler_step,
                                                      make_flow_match_schedule)


def encode_audio_windows(w2v_params, w2v_cfg: Wav2Vec2Config, waveform,
                         num_frames: int, window: int = 5) -> torch.Tensor:
    """[B, L] waveform -> [B, num_frames, window, blocks, C] per-frame audio
    windows for the avatar DiT (on the wav2vec2 params' device)."""
    dev = w2v_params["fp_proj"]["w"].device
    feats = wav2vec2_forward(w2v_params, w2v_cfg, _as_tensor(waveform, dev),
                             seq_len=num_frames)
    return get_audio_windows(feats, window=window)


@dataclasses.dataclass(eq=False)
class AvatarPipeline:
    """The device is the one the DiT params live on."""

    dit_params: dict
    dit_cfg: AvatarConfig
    vae_params: dict
    vae_cfg: WanVAEConfig
    policy: Policy = DEFAULT_POLICY
    vae_scale_t: int = 4
    vae_scale_s: int = 8
    # the parallel layer's mesh, passed to every DiT forward (the base
    # self-attention through Ulysses on sp, models/longcat/avatar.py)
    mesh: object = None

    @property
    def device(self) -> torch.device:
        return self.dit_params["x_embedder"]["w"].device

    def _dit(self, latents, t_per_frame, ctx, ctx_mask, audio, num_cond):
        return avatar_dit_forward(self.dit_params, self.dit_cfg, latents,
                                  t_per_frame, ctx, audio,
                                  encoder_attention_mask=ctx_mask,
                                  num_cond_latents=num_cond,
                                  policy=self.policy, mesh=self.mesh)

    @torch.inference_mode()
    def generate_i2v_audio(
        self,
        generator: Optional[torch.Generator],
        image,                                 # [B,3,H,W] in [-1,1]
        audio_embs,                            # [B,T_video,W,S,C_a]
        prompt_embeds,
        prompt_mask,
        negative_prompt_embeds,
        negative_prompt_mask,
        *,
        height: int = 480,
        width: int = 832,
        num_frames: int = 49,
        num_inference_steps: int = 50,
        guidance_scale: float = 4.0,
        use_distill: bool = False,
        flow_shift: float = 1.0,
        output_type: str = "np",
        noise_fn: Optional[Callable] = None,
    ):
        """A talking-head video from a reference image and audio windows;
        numpy [B,3,T,H,W] in [0,1] (or the latents for
        ``output_type="latent"``). ``noise_fn(shape) -> array`` replaces the
        generator's draw of the initial latents."""
        dev = self.device
        image = _as_tensor(image, dev)
        audio_embs = _as_tensor(audio_embs, dev)
        prompt_embeds = _as_tensor(prompt_embeds, dev)
        negative_prompt_embeds = _as_tensor(negative_prompt_embeds, dev)
        prompt_mask = _as_tensor(prompt_mask, dev, torch.int32)
        negative_prompt_mask = _as_tensor(negative_prompt_mask, dev,
                                          torch.int32)
        b = image.shape[0]
        do_cfg = (guidance_scale > 1 and negative_prompt_embeds is not None
                  and not use_distill)
        sched = make_flow_match_schedule(num_inference_steps,
                                         shift=flow_shift,
                                         use_distill=use_distill)
        t_lat = (num_frames - 1) // self.vae_scale_t + 1
        shape = (b, self.dit_cfg.base.in_channels, t_lat,
                 height // self.vae_scale_s, width // self.vae_scale_s)
        if noise_fn is not None:
            latents = _as_tensor(noise_fn(shape), dev)
        else:
            latents = torch.randn(shape, generator=generator,
                                  dtype=torch.float32, device=dev)
        latents[:, :, :1] = vae_encode(self.vae_params, self.vae_cfg,
                                       image[:, :, None].float())

        for i in range(sched.num_steps):
            tb = torch.full((b, t_lat), float(sched.timesteps[i]),
                            dtype=torch.float32, device=dev)
            tb[:, 0] = 0.0                       # the cond frame
            v = self._dit(latents, tb, prompt_embeds, prompt_mask,
                          audio_embs, 1)
            if do_cfg:
                vu = self._dit(latents, tb, negative_prompt_embeds,
                               negative_prompt_mask, audio_embs, 1)
                v = cfg_zero_combine(v, vu, guidance_scale)
            v = -v                               # scheduler-compat negation
            latents[:, :, 1:] = fm_euler_step(sched, i, latents[:, :, 1:],
                                              v[:, :, 1:])

        if output_type == "latent":
            return latents
        video = vae_decode(self.vae_params, self.vae_cfg, latents)
        out = (video.float().cpu().numpy() + 1.0) / 2.0
        return np.clip(out, 0.0, 1.0)
