"""LongCat-Video pipeline: guided i2v (IRR + FLF + DSG), t2v, video
continuation, and the 480p -> 720p refine.

Counterpart of ``worldforge_tpu/pipelines/longcat.py`` on its host-loop
paths:

- ``generate_i2v``: the first frame VAE-encoded into latent slot 0 and a
  per-frame timestep of 0 there; CFG batch pairs combined with CFG-zero
  (off under ``use_distill``), the model output negated for the scheduler;
  ``sampling/engine.py::longcat_denoise_loop`` runs IRR and DSG on the
  noise frames, and the guided fuse on the full latents with FLF
  (the LongCat schedule) at r = 0.
- ``generate_t2v``: a plain flow-match Euler loop with CFG-zero.
- ``generate_vc``: the DiT runs once over the clean cond latents to cache
  each layer's k/v, then denoises the noise latents only against that
  cache; ``enhance_hf`` swaps the timestep tail below 500 for a 10-step
  ramp. ``vc_cache_dtype`` "bfloat16" halves the cache.
- ``prepare_refine_latents`` / ``generate_refine``: an align-corners
  spatial upscale (and a 2x trilinear temporal one unless
  ``spatial_refine_only``), noise frames padded to the BSA latent
  granularity, the VAE encode, a mix with noise at ``t_thresh``, the Euler
  schedule truncated below ``t_thresh``, no CFG, and block-sparse attention
  where the token grid factors into (4, 4, 8) chunks.

The fused and chunked scan runners (``fused=True``, ``exec_chunk``) work
around TPU runtime limits and raise, as ``auto_layout`` does. ``mesh``
(``core/mesh.py``) goes to every DiT call, the vc cache pair included (the
cache then sequence-sharded); the pipeline stays global-view, as
``pipelines/wan_i2v.py`` says. ``token_chunk`` > 1 runs the DiT's QKV
prologue and FFN over token chunks (ignored under a mesh).
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
from worldforge_tpu_torch.models.longcat.dit import (
    longcat_dit_cache_cond, longcat_dit_forward_with_cache)
from worldforge_tpu_torch.pipelines.wan_i2v import (NOT_PORTED_RUNNERS,
                                                    _as_tensor)
from worldforge_tpu_torch.sampling.engine import longcat_denoise_loop
from worldforge_tpu_torch.sampling.flow_match import (FlowMatchSchedule,
                                                      cfg_zero_combine,
                                                      fm_euler_step,
                                                      make_flow_match_schedule)
from worldforge_tpu_torch.sampling.guidance import (GuidanceConfig,
                                                    guided_fuse)


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
    mesh: object = None             # the parallel layer's mesh
    token_chunk: int = 1            # the DiT's token chunks
    auto_layout: bool = False       # XLA entry layouts: no counterpart
    # generate_vc's cond-token k/v cache: "float32" is exact, "bfloat16"
    # halves it (k rounded before its RoPE)
    vc_cache_dtype: str = "float32"

    @property
    def device(self) -> torch.device:
        return self.dit_params["x_embedder"]["w"].device

    def _vae_fns(self):
        """(decode(z), encode(video)) closures over the VAE params."""
        dec, enc = vae_fn_pair(self.streaming_vae, self.streaming_vae_chunk)
        return ((lambda z: dec(self.vae_params, self.vae_cfg, z)),
                (lambda v: enc(self.vae_params, self.vae_cfg, v)))

    def _check_ported(self):
        if self.auto_layout:
            raise NotImplementedError(
                "LongCatPipeline.auto_layout sets XLA entry layouts; the "
                "port has no counterpart")

    def _to_video(self, latents):
        video = self._vae_fns()[0](latents)
        out = (video.float().cpu().numpy() + 1.0) / 2.0
        return np.clip(out, 0.0, 1.0)

    def _initial_noise(self, generator, noise_fn, shape):
        if noise_fn is not None:
            return _as_tensor(noise_fn(tuple(shape)), self.device)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.device)

    @torch.inference_mode()
    def generate_i2v(
        self,
        generator: Optional[torch.Generator],
        image,                                 # [B,3,H,W] in [-1,1]
        prompt_embeds,                         # [B, M, caption]
        prompt_mask,                           # [B, M] or None
        negative_prompt_embeds=None,
        negative_prompt_mask=None,
        *,
        height: int = 480,
        width: int = 832,
        num_frames: int = 49,
        num_inference_steps: int = 50,
        guidance_scale: float = 4.0,
        use_distill: bool = False,
        flow_shift: float = 1.0,
        video_ref=None,                        # [B,3,T,H,W] in [0,1]
        mask=None,                             # [B,1,T,H,W]
        guidance: GuidanceConfig = GuidanceConfig(flf_backend="longcat"),
        output_type: str = "np",
        noise_fn: Optional[Callable] = None,
        callback: Optional[Callable[[int, torch.Tensor], None]] = None,
        fused: bool = False,
        exec_chunk: int = 0,
    ):
        """Guided image-to-video. ``generator`` (on the pipeline's device,
        or None for the global one) draws the initial latents and the IRR
        re-noise; ``noise_fn(shape) -> array`` overrides both, so a test can
        feed one noise stream to two implementations. Guidance runs when
        ``guidance.guided`` and both ``video_ref`` and ``mask`` are given.
        Returns numpy [B, 3, T, H, W] in [0, 1] (or the latents for
        ``output_type="latent"``)."""
        if fused or exec_chunk:
            raise NotImplementedError(NOT_PORTED_RUNNERS)
        self._check_ported()
        dev = self.device
        image = _as_tensor(image, dev)
        pe = _as_tensor(prompt_embeds, dev)
        pmask = _as_tensor(prompt_mask, dev, dtype=torch.int32)
        ne = _as_tensor(negative_prompt_embeds, dev)
        nmask = _as_tensor(negative_prompt_mask, dev, dtype=torch.int32)
        video_ref = _as_tensor(video_ref, dev)
        mask = _as_tensor(mask, dev)
        b = image.shape[0]
        do_cfg = guidance_scale > 1 and ne is not None and not use_distill

        sched = make_flow_match_schedule(num_inference_steps,
                                         shift=flow_shift,
                                         use_distill=use_distill)
        t_lat = (num_frames - 1) // self.vae_scale_t + 1
        h_lat, w_lat = height // self.vae_scale_s, width // self.vae_scale_s
        latents = self._initial_noise(
            generator, noise_fn,
            (b, self.dit_cfg.in_channels, t_lat, h_lat, w_lat))
        dec, enc = self._vae_fns()
        cond_lat = enc(image[:, :, None].float())          # [B, z, 1, h, w]
        latents = torch.cat([cond_lat.float(), latents[:, :, 1:]], dim=2)

        guided_on = (guidance.guided and video_ref is not None
                     and mask is not None)
        gcfg = dataclasses.replace(guidance, flf_backend="longcat",
                                   distill=use_distill)

        def model_fn(lat, t_val, i, r):
            tb = torch.full((b, t_lat), t_val, dtype=torch.float32,
                            device=dev)
            tb[:, 0] = 0.0                    # the cond frame
            v = longcat_dit_forward(
                self.dit_params, self.dit_cfg, lat.float(), tb, pe,
                encoder_attention_mask=pmask, num_cond_latents=1,
                policy=self.policy, mesh=self.mesh,
                token_chunk=self.token_chunk)
            if do_cfg:
                vu = longcat_dit_forward(
                    self.dit_params, self.dit_cfg, lat.float(), tb, ne,
                    encoder_attention_mask=nmask, num_cond_latents=1,
                    policy=self.policy, mesh=self.mesh,
                    token_chunk=self.token_chunk)
                v = cfg_zero_combine(v, vu, guidance_scale)
            return -v                         # the scheduler's sign

        fuse_fn = None
        if guided_on:
            def fuse_fn(x0_full, i, r):
                return guided_fuse(x0_full, video_ref, mask, dec, enc, i,
                                   gcfg)

        latents = longcat_denoise_loop(
            model_fn, latents, sched, gcfg, generator=generator,
            noise_fn=noise_fn, fuse_fn=fuse_fn, callback=callback)
        if output_type == "latent":
            return latents
        return self._to_video(latents)

    @torch.inference_mode()
    def generate_t2v(
        self,
        generator: Optional[torch.Generator],
        prompt_embeds,
        prompt_mask,
        negative_prompt_embeds=None,
        negative_prompt_mask=None,
        *,
        height: int = 480,
        width: int = 832,
        num_frames: int = 93,
        num_inference_steps: int = 50,
        guidance_scale: float = 4.0,
        use_distill: bool = False,
        flow_shift: float = 1.0,
        output_type: str = "np",
        noise_fn: Optional[Callable] = None,
    ):
        """Text-to-video: a plain flow-match Euler loop with CFG-zero and no
        cond latents. ``noise_fn`` overrides the initial draw."""
        self._check_ported()
        dev = self.device
        pe = _as_tensor(prompt_embeds, dev)
        pmask = _as_tensor(prompt_mask, dev, dtype=torch.int32)
        ne = _as_tensor(negative_prompt_embeds, dev)
        nmask = _as_tensor(negative_prompt_mask, dev, dtype=torch.int32)
        b = pe.shape[0]
        do_cfg = guidance_scale > 1 and ne is not None and not use_distill
        sched = make_flow_match_schedule(num_inference_steps,
                                         shift=flow_shift,
                                         use_distill=use_distill)
        t_lat = (num_frames - 1) // self.vae_scale_t + 1
        latents = self._initial_noise(
            generator, noise_fn,
            (b, self.dit_cfg.in_channels, t_lat,
             height // self.vae_scale_s, width // self.vae_scale_s))
        for i in range(sched.num_steps):
            tb = torch.full((b, t_lat), float(sched.timesteps[i]),
                            dtype=torch.float32, device=dev)
            v = longcat_dit_forward(self.dit_params, self.dit_cfg, latents,
                                    tb, pe, encoder_attention_mask=pmask,
                                    policy=self.policy, mesh=self.mesh,
                                    token_chunk=self.token_chunk)
            if do_cfg:
                vu = longcat_dit_forward(
                    self.dit_params, self.dit_cfg, latents, tb, ne,
                    encoder_attention_mask=nmask, policy=self.policy,
                    mesh=self.mesh, token_chunk=self.token_chunk)
                v = cfg_zero_combine(v, vu, guidance_scale)
            latents = fm_euler_step(sched, i, latents, -v)
        if output_type == "latent":
            return latents
        return self._to_video(latents)

    @torch.inference_mode()
    def generate_vc(
        self,
        generator: Optional[torch.Generator],
        video,                                 # [B,3,Tc,H,W] in [-1,1]
        prompt_embeds,
        prompt_mask,
        *,
        height: int = 480,
        width: int = 832,
        num_frames: int = 93,
        num_cond_frames: int = 13,
        num_inference_steps: int = 50,
        use_distill: bool = False,
        flow_shift: float = 1.0,
        enhance_hf: bool = True,
        output_type: str = "np",
        noise_fn: Optional[Callable] = None,
    ):
        """Video continuation with per-layer k/v caches of the cond tokens:
        the last ``num_cond_frames`` frames of ``video`` are encoded and
        run through the DiT once (``longcat_dit_cache_cond``); each step
        then denoises the noise latents only against that cache.
        ``enhance_hf`` replaces the timesteps below 500 with a 10-step
        uniform ramp; it cannot combine with ``use_distill``.
        ``noise_fn`` overrides the initial draw. Returns the cond and new
        frames together."""
        if use_distill and enhance_hf:
            raise ValueError("use_distill and enhance_hf cannot both be "
                             "True")
        self._check_ported()
        dev = self.device
        video = _as_tensor(video, dev)
        pe = _as_tensor(prompt_embeds, dev)
        pmask = _as_tensor(prompt_mask, dev, dtype=torch.int32)
        b = video.shape[0]
        sched = make_flow_match_schedule(num_inference_steps,
                                         shift=flow_shift,
                                         use_distill=use_distill)
        if enhance_hf:
            keep = sched.timesteps[sched.timesteps > 500.0]
            tail = np.linspace(500.0, 0.0, 10, endpoint=False)
            ts = np.concatenate([keep, tail])
            sched = FlowMatchSchedule(
                sigmas=np.concatenate([ts / 1000.0, [0.0]]), timesteps=ts,
                num_steps=len(ts))

        n_cond_lat = 1 + (num_cond_frames - 1) // self.vae_scale_t
        t_lat = (num_frames - 1) // self.vae_scale_t + 1
        h_lat, w_lat = height // self.vae_scale_s, width // self.vae_scale_s
        dec, enc = self._vae_fns()
        cond_lat = enc(video[:, :, -num_cond_frames:].float())
        latents = self._initial_noise(
            generator, noise_fn,
            (b, self.dit_cfg.in_channels, t_lat - n_cond_lat, h_lat, w_lat))
        cache_dtype = {"float32": torch.float32,
                       "bfloat16": torch.bfloat16}[self.vc_cache_dtype]
        kv_cache = longcat_dit_cache_cond(self.dit_params, self.dit_cfg,
                                          cond_lat, policy=self.policy,
                                          cache_dtype=cache_dtype,
                                          mesh=self.mesh)
        for i in range(sched.num_steps):
            nt = latents.shape[2] // self.dit_cfg.patch_size[0]
            tb = torch.full((b, nt), float(sched.timesteps[i]),
                            dtype=torch.float32, device=dev)
            v = longcat_dit_forward_with_cache(
                self.dit_params, self.dit_cfg, latents, tb, pe, kv_cache,
                (n_cond_lat,), encoder_attention_mask=pmask,
                policy=self.policy, mesh=self.mesh)
            latents = fm_euler_step(sched, i, latents, -v)

        full = torch.cat([cond_lat.float(), latents], dim=2)
        if output_type == "latent":
            return full
        return self._to_video(full)

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
                bsa_params=bsa_params, mesh=self.mesh,
                token_chunk=self.token_chunk)
            latents = fm_euler_step(sched, i, latents, -v)
            if callback is not None:
                callback(i, latents)

        if output_type == "latent":
            return latents
        return self._to_video(latents)[:, :, :new_t]
