"""Wan2.1 image-to-video WorldForge pipeline (CFG + IRR + VAE fuse + DSG).

Counterpart of ``worldforge_tpu/pipelines/wan_i2v.py`` on its host-loop path
(``fused=False``). Per outer step i (timestep t):

    for r in range(resample_steps):              # IRR
      r>0: model timestep = floor(sigma_i*1000)
      noise_pred = cond + g*(cond - uncond)      # WorldForge CFG form
      x0 = x - sigma_i * v; guided -> fuse_latents (decode/blend/encode)
      prev = UniP(x, m0, m1)
      i < resample_round and r < last: x = (1-sigma_i)*x0_fused + sigma_i*eps
    DSG: if >=2 noise preds were recorded, angular-extrapolate (omega, or
    omega_resample past guide_steps), re-convert (unfused), replace m0 and
    redo the UniP update from the ORIGINAL x of this step.

FLF (``GuidanceConfig.use_flf``, on by default) runs at r = 0 of every
guided step (``sampling/guidance.py::guided_fuse``). The whole-loop fused and chunked runners (``fused=True``,
``exec_chunk``, ``auto_layout``) are later slices of the port and raise.
``streaming_vae`` runs the streaming VAE (``models/wan/vae_stream.py``).
``mesh`` (``core/mesh.py``) goes to every DiT forward: the pipeline stays
global-view (every rank draws the same noise from the same seed and runs
the solver, the fuse, FLF and the VAE on the whole batch, so FLF's
statistics are the global batch's, as JAX computes them) while the DiT
cuts the batch on ``dp`` and the tokens on ``sp``. ``token_chunk`` > 1
runs the DiT's FFN over token chunks (ignored under a mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from worldforge_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from worldforge_tpu_torch.models.wan.dit import WanDiTConfig, wan_dit_forward
from worldforge_tpu_torch.models.wan.vae import WanVAEConfig
from worldforge_tpu_torch.pipelines.vae_dispatch import vae_fn_pair
from worldforge_tpu_torch.sampling.engine import wan_denoise_loop
from worldforge_tpu_torch.sampling.guidance import (GuidanceConfig,
                                                    guided_fuse)
from worldforge_tpu_torch.sampling.unipc import make_flow_unipc_schedule


NOT_PORTED_RUNNERS = (
    "the fused / chunked scan runners (fused=True, exec_chunk) work around "
    "TPU runtime limits and are not ported; the host-loop path "
    "(fused=False) is the port's path")


def _as_tensor(x, device, dtype=torch.float32) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, dtype=dtype).to(device)


def frame_condition(encode: Callable, first: torch.Tensor,
                    last: Optional[torch.Tensor], num_frames: int,
                    h_lat: int, w_lat: int, vae_scale_t: int
                    ) -> torch.Tensor:
    """The conditioning input [B, 4 + z, T', h, w]: a 4-channel temporal
    mask || the latents of the conditioning video. i2v (``last`` None)
    encodes [first, zeros...] and masks frame 0; flf2v encodes
    [first, zeros..., last] and masks frames 0 and -1. The mask's frame 0 is
    repeated ``vae_scale_t`` times and the frames folded into 4 channels per
    latent frame. first / last: [B, 3, H, W] in [-1, 1]."""
    b, _, height, width = first.shape
    dev = first.device
    t_lat = (num_frames - 1) // vae_scale_t + 1
    n_zero = num_frames - 1 - (last is not None)
    parts = [first[:, :, None].float(),
             torch.zeros((b, 3, n_zero, height, width), dtype=torch.float32,
                         device=dev)]
    if last is not None:
        parts.append(last[:, :, None].float())
    cond_lat = encode(torch.cat(parts, dim=2)).float()

    mask = np.zeros((b, 1, num_frames, h_lat, w_lat), np.float32)
    mask[:, :, 0] = 1.0
    if last is not None:
        mask[:, :, -1] = 1.0
    head = np.repeat(mask[:, :, 0:1], vae_scale_t, axis=2)
    mask = np.concatenate([head, mask[:, :, 1:]], axis=2)
    mask = mask.reshape(b, t_lat, vae_scale_t, h_lat, w_lat)
    mask = mask.transpose(0, 2, 1, 3, 4)  # [B, 4, T', h, w]
    return torch.cat([torch.from_numpy(np.ascontiguousarray(mask)).to(dev),
                      cond_lat], dim=1)


@dataclasses.dataclass(eq=False)
class WanI2VPipeline:
    """Holds params/configs; generation is functional underneath. The
    device is the one the DiT params live on."""

    dit_params: dict
    dit_cfg: WanDiTConfig
    vae_params: dict
    vae_cfg: WanVAEConfig
    policy: Policy = DEFAULT_POLICY
    vae_scale_t: int = 4
    vae_scale_s: int = 8
    streaming_vae: bool = False
    # the parallel layer's mesh, passed to every DiT forward
    mesh: object = None
    token_chunk: int = 1

    @property
    def device(self) -> torch.device:
        return self.dit_params["patch_embedding"]["w"].device

    # ------------------------------------------------------------ pieces

    def _vae_fns(self):
        """(decode(z), encode(video)) closures over the VAE params."""
        dec, enc = vae_fn_pair(self.streaming_vae)
        return ((lambda z: dec(self.vae_params, self.vae_cfg, z)),
                (lambda v: enc(self.vae_params, self.vae_cfg, v)))

    def _dit(self, latents, condition, t, ctx, clip_fea):
        tb = torch.full((latents.shape[0],), float(t), dtype=torch.float32,
                        device=latents.device)
        return wan_dit_forward(self.dit_params, self.dit_cfg,
                               latents.float(), tb, ctx, clip_fea=clip_fea,
                               y=condition.float(), policy=self.policy,
                               mesh=self.mesh, token_chunk=self.token_chunk)

    def prepare_latents(self, generator: Optional[torch.Generator],
                        image: torch.Tensor, batch_size: int, height: int,
                        width: int, num_frames: int):
        """Noise + [4ch temporal mask || first-frame cond latents].
        image: [B,3,H,W] in [-1,1]."""
        dev = self.device
        t_lat = (num_frames - 1) // self.vae_scale_t + 1
        h_lat = height // self.vae_scale_s
        w_lat = width // self.vae_scale_s
        z = self.dit_cfg.out_dim
        latents = torch.randn((batch_size, z, t_lat, h_lat, w_lat),
                              generator=generator, dtype=torch.float32,
                              device=dev)
        condition = frame_condition(self._vae_fns()[1], image, None,
                                    num_frames, h_lat, w_lat,
                                    self.vae_scale_t)
        return latents, condition

    # ------------------------------------------------------------ generate

    @torch.inference_mode()
    def generate(
        self,
        generator: Optional[torch.Generator],
        image,                                 # [B,3,H,W] in [-1,1]
        prompt_embeds,                         # [B, text_len, text_dim]
        negative_prompt_embeds,
        image_embeds,                          # [B, 257, 1280]
        *,
        height: int = 480,
        width: int = 832,
        num_frames: int = 49,
        num_inference_steps: int = 50,
        guidance_scale: float = 4.0,
        flow_shift: float = 5.0,
        video_ref=None,                        # [B,3,T,H,W] in [0,1]
        mask=None,                             # [B,1,T,H,W]
        guidance: GuidanceConfig = GuidanceConfig(),
        output_type: str = "np",
        callback: Optional[Callable[[int, torch.Tensor], None]] = None,
        noise_fn: Optional[Callable] = None,
        fused: bool = False,
        exec_chunk: int = 0,
    ):
        """Generate a video. ``generator`` (a torch.Generator on the
        pipeline's device, or None for the global one) draws the initial
        latents and the IRR re-noise; ``noise_fn(shape) -> array`` overrides
        both, so a test can feed one noise stream to two implementations.
        Array inputs may be numpy or torch; they are moved to the pipeline's
        device. Returns numpy [B,3,T,H,W] in [0,1] (or the latents for
        ``output_type="latent"``)."""
        if fused or exec_chunk:
            raise NotImplementedError(NOT_PORTED_RUNNERS)
        if num_frames % self.vae_scale_t != 1:
            num_frames = num_frames // self.vae_scale_t * self.vae_scale_t + 1
        dev = self.device
        image = _as_tensor(image, dev)
        prompt_embeds = _as_tensor(prompt_embeds, dev)
        negative_prompt_embeds = _as_tensor(negative_prompt_embeds, dev)
        image_embeds = _as_tensor(image_embeds, dev)
        video_ref = _as_tensor(video_ref, dev)
        mask = _as_tensor(mask, dev)
        batch = image.shape[0]
        do_cfg = guidance_scale > 1 and negative_prompt_embeds is not None
        guided_on = (guidance.guided and video_ref is not None
                     and mask is not None)

        sched = make_flow_unipc_schedule(num_inference_steps, flow_shift)
        latents, condition = self.prepare_latents(
            generator, image, batch, height, width, num_frames)
        if noise_fn is not None:
            latents = _as_tensor(noise_fn(tuple(latents.shape)), dev)

        dec, enc = self._vae_fns()

        def model_fn(lat, t_model, i, r):
            pred = self._dit(lat, condition, t_model, prompt_embeds,
                             image_embeds)
            if do_cfg:
                uncond = self._dit(lat, condition, t_model,
                                   negative_prompt_embeds, image_embeds)
                # WorldForge CFG form: pred + g*(pred - uncond)
                pred = pred + guidance_scale * (pred - uncond)
            return pred

        fuse_fn = None
        if guided_on:
            def fuse_fn(x0, i, r):
                # FLF only at r == 0, not while resampling
                return guided_fuse(x0, video_ref, mask, dec, enc, i,
                                   guidance, flf=r == 0)

        latents = wan_denoise_loop(
            model_fn, latents, sched, guidance, generator=generator,
            noise_fn=noise_fn, fuse_fn=fuse_fn, callback=callback,
            record_r0=do_cfg)

        if output_type == "latent":
            return latents
        video = dec(latents)
        out = (video.float().cpu().numpy() + 1.0) / 2.0
        return np.clip(out, 0.0, 1.0)
