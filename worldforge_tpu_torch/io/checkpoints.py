"""Pipeline assembly: converted checkpoints, or random weights.

Counterpart of ``worldforge_tpu/io/checkpoints.py::load_wan_pipeline``,
``load_longcat_pipeline`` and ``load_avatar_pipeline`` (:30-178). Given a
directory in the upstream layout, each loader converts the real weights
onto the device (``io/convert_wan.py``, ``io/convert_longcat.py`` with the
distill LoRA under ``use_distill``, ``io/convert_wav2vec2.py``,
``io/convert_encoders.py`` for UMT5 and CLIP), with the JAX package's full
configs unless the caller passes others. ``random_init=True`` (or no
directory) builds a random-weight pipeline on the device instead: by
default the JAX package's reduced random-init sizes, or the configs the
caller passes (``chip_smoke.py`` passes the full-width Wan2.1-I2V-14B and
LongCat-Video-13.6B DiTs, the LongCat-Video-Avatar DiT with the
wav2vec2-base encoder, and the Wan2.1 VAE); hash embeddings stand in for
the text and image encoders there, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.core.dtypes import (DEFAULT_POLICY, Policy,
                                              resolve_device)
from worldforge_tpu_torch.io.convert_longcat import (convert_avatar_dit,
                                                    load_converted_longcat,
                                                    longcat_text_encoder)
from worldforge_tpu_torch.io.convert_wan import (convert_wan_vae,
                                                 load_converted_wan)
from worldforge_tpu_torch.io.convert_wav2vec2 import convert_wav2vec2
from worldforge_tpu_torch.io.torch_load import load_state_dict
from worldforge_tpu_torch.models.encoders.clip_vision import CLIPVisionConfig
from worldforge_tpu_torch.models.encoders.umt5 import UMT5Config
from worldforge_tpu_torch.models.encoders.wav2vec2 import (Wav2Vec2Config,
                                                           init_wav2vec2)
from worldforge_tpu_torch.models.longcat.avatar import (AvatarConfig,
                                                        init_avatar_dit)
from worldforge_tpu_torch.models.longcat.dit import (LongCatDiTConfig,
                                                     init_longcat_dit)
from worldforge_tpu_torch.models.wan.dit import WanDiTConfig, init_wan_dit
from worldforge_tpu_torch.models.wan.vae import WanVAEConfig, init_wan_vae
from worldforge_tpu_torch.pipelines.avatar import (AvatarPipeline,
                                                   encode_audio_windows)
from worldforge_tpu_torch.pipelines.longcat import LongCatPipeline
from worldforge_tpu_torch.pipelines.wan_i2v import WanI2VPipeline

DEFAULT_RANDOM_DIT = WanDiTConfig(model_type="i2v", in_dim=36, out_dim=16,
                                  dim=256, ffn_dim=512, num_heads=4,
                                  num_layers=4)
DEFAULT_RANDOM_VAE = WanVAEConfig(dim=32, z_dim=16, dim_mult=(1, 2, 2, 2),
                                  num_res_blocks=1)
DEFAULT_RANDOM_LONGCAT = LongCatDiTConfig(hidden_size=256, depth=4,
                                          num_heads=4, caption_channels=4096,
                                          adaln_tembed_dim=64)
DEFAULT_RANDOM_AVATAR = AvatarConfig(base=DEFAULT_RANDOM_LONGCAT,
                                     audio_blocks=12, audio_channels=768,
                                     intermediate_dim=128, output_dim=768,
                                     context_tokens=8)
DEFAULT_RANDOM_WAV2VEC2 = Wav2Vec2Config(hidden_size=768, num_layers=12,
                                         num_heads=12,
                                         intermediate_size=1536)


def _seed_of(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest()[:4], "little")


def _hash_embed(text: str, shape, device, scale: float = 1.0
                ) -> torch.Tensor:
    """Deterministic pseudo-embedding from text (random-init path)."""
    gen = torch.Generator().manual_seed(_seed_of(text.encode()))
    return (scale * torch.randn(shape, generator=gen)).to(device)


def load_wan_pipeline(models_dir: Optional[str] = None,
                      variant: str = "480p",
                      random_init: bool = False, *,
                      device: Optional[Union[str, torch.device]] = None,
                      dit_cfg: Optional[WanDiTConfig] = None,
                      vae_cfg: Optional[WanVAEConfig] = None,
                      umt5_cfg: Optional[UMT5Config] = None,
                      clip_cfg: Optional[CLIPVisionConfig] = None,
                      policy: Policy = DEFAULT_POLICY,
                      seed: int = 0,
                      ) -> Tuple[WanI2VPipeline, Callable, Callable]:
    """Returns (pipeline, encode_text(str)->[1,L,D],
    encode_image(img)->[1,257,1280]).

    device: None means the card (raises when there is none); the CPU only
    when asked for by name. With ``models_dir`` (and not ``random_init``)
    the converted checkpoints there (``io/convert_wan.py::
    load_converted_wan``: Wan2.1-I2V-14B, the Wan2.1 VAE, UMT5-XXL and
    CLIP-H unless ``dit_cfg`` / ``vae_cfg`` / ``umt5_cfg`` / ``clip_cfg``
    say otherwise). Else random weights: the DiT in bf16 (fp32 under an
    fp32 policy), the VAE in fp32, from generators seeded ``seed``,
    ``seed + 1`` and ``seed + 99`` (the randomized head)."""
    dev = resolve_device(device)
    if not (random_init or models_dir is None):
        return load_converted_wan(models_dir, variant, device=dev,
                                  dit_cfg=dit_cfg, vae_cfg=vae_cfg,
                                  umt5_cfg=umt5_cfg, clip_cfg=clip_cfg,
                                  policy=policy)
    dit_cfg = dit_cfg or DEFAULT_RANDOM_DIT
    vae_cfg = vae_cfg or DEFAULT_RANDOM_VAE
    dit_params = init_wan_dit(P.make_generator(seed, dev), dit_cfg,
                              dtype=policy.param_dtype)
    # non-zero head so the random-init output isn't the trivial zero field
    head = dit_params["head"]["head"]
    head["w"] = (0.02 * P.normal(P.make_generator(seed + 99, dev),
                                 tuple(head["w"].shape))).to(head["w"].dtype)
    vae_params = init_wan_vae(P.make_generator(seed + 1, dev), vae_cfg)
    pipe = WanI2VPipeline(dit_params=dit_params, dit_cfg=dit_cfg,
                          vae_params=vae_params, vae_cfg=vae_cfg,
                          policy=policy)

    def encode_text(text: str) -> torch.Tensor:
        return _hash_embed(text, (1, dit_cfg.text_len, dit_cfg.text_dim), dev)

    def encode_image(img: np.ndarray) -> torch.Tensor:
        gen = torch.Generator().manual_seed(
            _seed_of(np.ascontiguousarray(img).tobytes()))
        return torch.randn((1, 257, dit_cfg.clip_dim), generator=gen).to(dev)

    return pipe, encode_text, encode_image


def load_longcat_pipeline(checkpoint_dir: Optional[str] = None,
                          random_init: bool = False, *,
                          device: Optional[Union[str, torch.device]] = None,
                          dit_cfg: Optional[LongCatDiTConfig] = None,
                          vae_cfg: Optional[WanVAEConfig] = None,
                          use_distill: bool = False,
                          umt5_cfg: Optional[UMT5Config] = None,
                          policy: Policy = DEFAULT_POLICY,
                          seed: int = 0,
                          ) -> Tuple[LongCatPipeline, Callable]:
    """Returns (LongCatPipeline, encode_text(str) -> (embeds [1, L, caption],
    mask [1, L] int32)).

    device: None means the card (raises when there is none); the CPU only
    when asked for by name. With ``checkpoint_dir`` (and not
    ``random_init``) the converted checkpoints there
    (``io/convert_longcat.py::load_converted_longcat``: LongCat-Video
    13.6B, the Wan2.1 VAE, UMT5-XXL unless the configs say otherwise), and
    with ``use_distill`` the distill LoRA ``lora/cfg_step_lora.safetensors``
    merged into the DiT when it is there. Else random weights: the DiT in
    bf16 (fp32 under an fp32 policy) one layer at a time on the device,
    the VAE in fp32, from generators seeded ``seed`` and ``seed + 1``;
    ``use_distill`` then has no effect, as in the JAX loader (the distill
    sigma table and the CFG switch-off are
    ``generate_i2v(use_distill=True)``'s)."""
    dev = resolve_device(device)
    if not (random_init or checkpoint_dir is None):
        return load_converted_longcat(checkpoint_dir, use_distill,
                                      device=dev, dit_cfg=dit_cfg,
                                      vae_cfg=vae_cfg, umt5_cfg=umt5_cfg,
                                      policy=policy)
    dit_cfg = dit_cfg or DEFAULT_RANDOM_LONGCAT
    vae_cfg = vae_cfg or DEFAULT_RANDOM_VAE
    dit_params = init_longcat_dit(P.make_generator(seed, dev), dit_cfg,
                                  dtype=policy.param_dtype)
    vae_params = init_wan_vae(P.make_generator(seed + 1, dev), vae_cfg)
    pipe = LongCatPipeline(dit_params=dit_params, dit_cfg=dit_cfg,
                           vae_params=vae_params, vae_cfg=vae_cfg,
                           policy=policy)

    return pipe, _hash_text_encoder(dit_cfg.caption_channels, dev)


def _hash_text_encoder(channels: int, dev) -> Callable:
    """encode_text(str) -> (hash embeds [1, L, channels], mask [1, L] with
    the first len(text) // 4 tokens valid)."""
    def encode_text(text: str, max_len: int = 512):
        emb = _hash_embed(text, (1, max_len, channels), dev)
        n = min(max(len(text) // 4, 1), max_len)
        mask = torch.zeros((1, max_len), dtype=torch.int32, device=dev)
        mask[:, :n] = 1
        return emb, mask

    return encode_text


def load_avatar_pipeline(checkpoint_dir: Optional[str] = None,
                         random_init: bool = False,
                         use_distill: bool = False, *,
                         device: Optional[Union[str, torch.device]] = None,
                         dit_cfg: Optional[AvatarConfig] = None,
                         vae_cfg: Optional[WanVAEConfig] = None,
                         w2v_cfg: Optional[Wav2Vec2Config] = None,
                         umt5_cfg: Optional[UMT5Config] = None,
                         seed: int = 0,
                         ) -> Tuple[AvatarPipeline, Callable, Callable]:
    """Returns (AvatarPipeline, encode_text(str) -> (embeds, mask),
    encode_audio(wav [1, L], num_frames) -> per-frame audio windows).

    device: None means the card (raises when there is none). With
    ``checkpoint_dir`` (and not ``random_init``) the converted checkpoints
    in ``<dir>/dit`` (``io/convert_longcat.py::convert_avatar_dit``),
    ``<dir>/vae``, ``<dir>/wav2vec2`` (``io/convert_wav2vec2.py``),
    ``<dir>/text_encoder`` and ``<dir>/tokenizer``, as the JAX loader
    (:121-178): the avatar on the LongCat-Video 13.6B base, wav2vec2-base,
    the Wan2.1 VAE and UMT5-XXL unless the configs say otherwise. At
    random init the JAX loader's reduced sizes by default: the loaders'
    small LongCat base with 8 audio context tokens, a wav2vec2 of full
    width (768 x 12 layers) with FFN 1536, the small Wan VAE, and hash
    embeddings for the text; the DiT built in bf16 one layer at a time on
    the device, the VAE and wav2vec2 in fp32, from generators seeded
    ``seed``, ``seed + 1`` and ``seed + 2``. ``use_distill`` has no effect
    in either branch, as in the JAX loader."""
    del use_distill
    dev = resolve_device(device)
    if not (random_init or checkpoint_dir is None):
        dit_cfg = dit_cfg or AvatarConfig(base=LongCatDiTConfig.longcat_13b())
        vae_cfg = vae_cfg or WanVAEConfig.wan_2_1()
        w2v_cfg = w2v_cfg or Wav2Vec2Config()
        dit_params = convert_avatar_dit(
            load_state_dict(os.path.join(checkpoint_dir, "dit")), dit_cfg,
            device=dev)
        vae_params = convert_wan_vae(
            load_state_dict(os.path.join(checkpoint_dir, "vae")), vae_cfg,
            device=dev)
        w2v_params = convert_wav2vec2(
            load_state_dict(os.path.join(checkpoint_dir, "wav2vec2")),
            w2v_cfg, device=dev)
        encode_text = longcat_text_encoder(checkpoint_dir, umt5_cfg, dev)
    else:
        dit_cfg = dit_cfg or DEFAULT_RANDOM_AVATAR
        vae_cfg = vae_cfg or DEFAULT_RANDOM_VAE
        w2v_cfg = w2v_cfg or DEFAULT_RANDOM_WAV2VEC2
        dit_params = init_avatar_dit(P.make_generator(seed, dev), dit_cfg)
        vae_params = init_wan_vae(P.make_generator(seed + 1, dev), vae_cfg)
        w2v_params = init_wav2vec2(P.make_generator(seed + 2, dev), w2v_cfg)
        encode_text = _hash_text_encoder(dit_cfg.base.caption_channels, dev)
    pipe = AvatarPipeline(dit_params=dit_params, dit_cfg=dit_cfg,
                          vae_params=vae_params, vae_cfg=vae_cfg)

    def encode_audio(wav, num_frames: int,
                     window: int = dit_cfg.audio_window) -> torch.Tensor:
        return encode_audio_windows(w2v_params, w2v_cfg, wav, num_frames,
                                    window=window)

    return pipe, encode_text, encode_audio
