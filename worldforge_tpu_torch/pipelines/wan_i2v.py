"""Wan2.1 image-to-video WorldForge pipeline (CFG + IRR + VAE fuse + DSG).

Counterpart of ``worldforge_tpu/pipelines/wan_i2v.py``. Per outer step i
(timestep t):

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
guided step. The host loop (``fused=False``) selects its channels on the
host (``sampling/guidance.py::guided_fuse``). ``fused=True`` runs the whole
loop through ``sampling/engine.py::wan_denoise_scan``: FLF selects on the
device (``select_mask_wan_device``), and on the card each segment kind's
step is a captured CUDA graph replayed step after step
(``runtime/step_graph.py``); ``exec_chunk=k`` replays the same graphs in
chunks of k plain-step equivalents with a synchronize between chunks
(``run_fused_chunked``). ``auto_layout`` has no counterpart in torch
(``runtime/layouts.py``): the field is accepted and read by no code, so
the fused runner takes the weights as they are whatever its value. ``streaming_vae`` runs the streaming VAE (``models/wan/vae_stream.py``).
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
from worldforge_tpu_torch.sampling.engine import (wan_denoise_loop,
                                                  wan_denoise_scan)
from worldforge_tpu_torch.sampling.guidance import (GuidanceConfig,
                                                    fuse_latents,
                                                    guided_fuse)
from worldforge_tpu_torch.sampling.unipc import make_flow_unipc_schedule


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
    # XLA entry layouts in the JAX package. Inert here: torch has none to
    # choose, no code reads the field, and the fused runner takes the
    # weights as they are (runtime/layouts.py)
    auto_layout: bool = False
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
        """One DiT forward; t a number or a [B] tensor of timesteps."""
        tb = t if isinstance(t, torch.Tensor) else torch.full(
            (latents.shape[0],), float(t), dtype=torch.float32,
            device=latents.device)
        return wan_dit_forward(self.dit_params, self.dit_cfg,
                               latents.float(), tb, ctx, clip_fea=clip_fea,
                               y=condition.float(), policy=self.policy,
                               mesh=self.mesh, token_chunk=self.token_chunk)

    def _make_fused_fns(self, guidance: GuidanceConfig, do_cfg: bool,
                        guided_on: bool, gscale: float, condition, pe, ne, ie,
                        video_ref, mask):
        """(model_fn, fuse_fn, flf_fn) of ``make_wan_body``, shared by the
        one-program and the chunked runners. t is a 0-dim tensor; FLF blends
        the fused x0 with the unfused one under the device mask."""
        from worldforge_tpu_torch.ops.flow import video_channel_flows_pair
        from worldforge_tpu_torch.sampling.channel_select import (
            _flow_similarity_scores, select_mask_wan_device)
        dec, enc = self._vae_fns()

        def model_fn(lat, t):
            tb = t.reshape(1).expand(lat.shape[0])
            pred = self._dit(lat, condition, tb, pe, ie)
            if do_cfg:
                unc = self._dit(lat, condition, tb, ne, ie)
                pred = pred + gscale * (pred - unc)
            return pred

        fuse_fn = flf_fn = None
        if guided_on:
            def fuse_fn(x0, step):
                return fuse_latents(x0, video_ref, mask, dec, enc)

            if guidance.use_flf:
                def flf_fn(pre, fused, step):
                    scores = _flow_similarity_scores(
                        *video_channel_flows_pair(pre, fused))
                    m = select_mask_wan_device(scores, step)
                    mb = m[None, :, None, None, None]
                    return fused * (1.0 - mb) + pre * mb, m

        return model_fn, fuse_fn, flf_fn

    def _run_fused_one_program(self, guidance, num_inference_steps,
                               flow_shift, do_cfg, guided_on, gscale,
                               latents, condition, prompt_embeds, ne_arg,
                               image_embeds, ref_arg, mask_arg, generator,
                               **kw):
        """The whole loop as one plan: ``run_fused_chunked`` at
        ``exec_chunk=0``, kept under the JAX package's name. JAX compiles
        entry layouts here under ``auto_layout``; torch has none
        (``auto_layouts_supported()`` is False), so nothing differs."""
        return self.run_fused_chunked(
            guidance, num_inference_steps, flow_shift, do_cfg, guided_on,
            gscale, 0, latents, condition, prompt_embeds, ne_arg,
            image_embeds, ref_arg, mask_arg, generator, **kw)

    def run_fused_chunked(self, guidance, num_inference_steps, flow_shift,
                          do_cfg, guided_on, gscale, exec_chunk, latents,
                          condition, prompt_embeds, ne_arg, image_embeds,
                          ref_arg, mask_arg, generator=None, on_chunk=None,
                          donate_data: bool = False, fuse_cost: float = 0.5,
                          noise_fn: Optional[Callable] = None,
                          callback: Optional[Callable] = None):
        """The fused runner in chunks of ``exec_chunk`` plain-step
        equivalents (0: one chunk a segment; ``wan_scan_chunks``, weighted
        by ``fuse_cost``, the fuse / plain step cost ratio). The UniPC
        m0 / m1 history rides the carry across chunks, so every chunking
        gives the same latents bit for bit. ``on_chunk(chunk, n_steps,
        seg_fuse, seg_irr, latents)`` runs after each chunk (synchronized on
        the card). ``donate_data`` is accepted for the JAX signature and
        ignored: the JAX package frees the data args' pre-relayout
        originals; the port makes no copies of them. ``callback(i,
        latents)`` runs after each step; ``self.last_flf_masks`` holds the
        FLF mask of every step that selected ({step: [C] numpy})."""
        sched = make_flow_unipc_schedule(num_inference_steps, flow_shift)
        model_fn, fuse_fn, flf_fn = self._make_fused_fns(
            guidance, do_cfg, guided_on, gscale, condition, prompt_embeds,
            ne_arg, image_embeds, ref_arg, mask_arg)
        masks = {}

        def on_step(i, carry, aux):
            if aux is not None:
                masks[i] = aux.clone()
            if callback is not None:
                callback(i, carry[0])

        out = wan_denoise_scan(
            model_fn, latents, sched, guidance, generator=generator,
            noise_fn=noise_fn, fuse_fn=fuse_fn, flf_fn=flf_fn,
            record_r0=do_cfg, exec_chunk=exec_chunk, fuse_cost=fuse_cost,
            on_step=on_step, on_chunk=on_chunk)
        self.last_flf_masks = {i: m.float().cpu().numpy()
                               for i, m in sorted(masks.items())}
        return out

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
        device. ``fused=True`` runs the whole-loop runner (FLF selected on
        the device; CUDA graphs on the card); ``exec_chunk`` > 0 runs it in
        chunks (``run_fused_chunked``), with or without ``fused``.
        Returns numpy [B,3,T,H,W] in [0,1] (or the latents for
        ``output_type="latent"``)."""
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

        if fused or exec_chunk:
            ne_arg = negative_prompt_embeds if do_cfg else prompt_embeds
            args = (guidance, num_inference_steps, flow_shift, do_cfg,
                    guided_on, float(guidance_scale))
            data = (latents, condition, prompt_embeds, ne_arg, image_embeds,
                    video_ref, mask, generator)
            kw = dict(noise_fn=noise_fn, callback=callback)
            if exec_chunk:
                latents = self.run_fused_chunked(*args, exec_chunk, *data,
                                                 **kw)
            else:
                latents = self._run_fused_one_program(*args, *data, **kw)
        else:
            latents = wan_denoise_loop(
                model_fn, latents, sched, guidance, generator=generator,
                noise_fn=noise_fn, fuse_fn=fuse_fn, callback=callback,
                record_r0=do_cfg)

        if output_type == "latent":
            return latents
        video = dec(latents)
        out = (video.float().cpu().numpy() + 1.0) / 2.0
        return np.clip(out, 0.0, 1.0)
