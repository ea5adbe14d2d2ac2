"""Pipeline assembly (the random-init branch).

Counterpart of ``worldforge_tpu/io/checkpoints.py::load_wan_pipeline``,
``load_longcat_pipeline`` and ``load_avatar_pipeline``. ``random_init=True``
(or no checkpoint directory) builds a random-weight pipeline on the device:
by default the JAX package's reduced random-init sizes, or the configs the
caller passes (``chip_smoke.py`` passes the full-width Wan2.1-I2V-14B and
LongCat-Video-13.6B DiTs, the LongCat-Video-Avatar DiT with the
wav2vec2-base encoder, and the Wan2.1 VAE). Converting real checkpoints
(``io/convert_wan.py``, ``io/convert_longcat.py``) and the LongCat
refinement LoRA wait until the weights are in the repository, and so do the
text and image encoders: at random init, hash embeddings stand in for them,
as in the JAX package.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.core.dtypes import (DEFAULT_POLICY, Policy,
                                              resolve_device)
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
                      policy: Policy = DEFAULT_POLICY,
                      seed: int = 0,
                      ) -> Tuple[WanI2VPipeline, Callable, Callable]:
    """Returns (pipeline, encode_text(str)->[1,L,D],
    encode_image(img)->[1,257,1280]).

    device: None means the card (raises when there is none); the CPU only
    when asked for by name. The DiT is built in bf16 (fp32 under an fp32
    policy), the VAE in fp32, from generators seeded ``seed``, ``seed + 1``
    and ``seed + 99`` (the randomized head)."""
    dev = resolve_device(device)
    if not (random_init or models_dir is None):
        raise NotImplementedError(
            "loading converted Wan checkpoints (io/convert_wan.py) waits "
            "until the weights are in the repository; use random_init=True")
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
                          policy: Policy = DEFAULT_POLICY,
                          seed: int = 0,
                          ) -> Tuple[LongCatPipeline, Callable]:
    """Returns (LongCatPipeline, encode_text(str) -> (embeds [1, L, caption],
    mask [1, L] int32)).

    device: None means the card (raises when there is none); the CPU only
    when asked for by name. The DiT is built in bf16 (fp32 under an fp32
    policy) one layer at a time on the device, the VAE in fp32, from
    generators seeded ``seed`` and ``seed + 1``. ``use_distill`` is the
    JAX loader's flag: with a converted checkpoint it would merge the
    distill LoRA, which comes with checkpoint conversion; at random init it
    has no effect, as in the JAX loader (the distill sigma table and the
    CFG switch-off are ``generate_i2v(use_distill=True)``'s)."""
    dev = resolve_device(device)
    if not (random_init or checkpoint_dir is None):
        raise NotImplementedError(
            "loading converted LongCat checkpoints (io/convert_longcat.py) "
            "and the refinement LoRA wait until the weights are in the "
            "repository; use random_init=True")
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
                         seed: int = 0,
                         ) -> Tuple[AvatarPipeline, Callable, Callable]:
    """Returns (AvatarPipeline, encode_text(str) -> (embeds, mask),
    encode_audio(wav [1, L], num_frames) -> per-frame audio windows).

    At random init the JAX loader's reduced sizes by default: the loaders'
    small LongCat base with 8 audio context tokens, a wav2vec2 of full
    width (768 x 12 layers) with FFN 1536, the small Wan VAE, and hash
    embeddings for the text. device: None means the card (raises when there
    is none). The DiT is built in bf16 one layer at a time on the device,
    the VAE and wav2vec2 in fp32, from generators seeded ``seed``,
    ``seed + 1`` and ``seed + 2``.
    ``use_distill`` has no effect at random init, as in the JAX loader."""
    del use_distill
    dev = resolve_device(device)
    if not (random_init or checkpoint_dir is None):
        raise NotImplementedError(
            "loading converted avatar checkpoints (io/convert_longcat.py, "
            "io/convert_wav2vec2.py) waits until the weights are in the "
            "repository; use random_init=True")
    dit_cfg = dit_cfg or DEFAULT_RANDOM_AVATAR
    vae_cfg = vae_cfg or DEFAULT_RANDOM_VAE
    w2v_cfg = w2v_cfg or DEFAULT_RANDOM_WAV2VEC2
    dit_params = init_avatar_dit(P.make_generator(seed, dev), dit_cfg)
    vae_params = init_wan_vae(P.make_generator(seed + 1, dev), vae_cfg)
    w2v_params = init_wav2vec2(P.make_generator(seed + 2, dev), w2v_cfg)
    pipe = AvatarPipeline(dit_params=dit_params, dit_cfg=dit_cfg,
                          vae_params=vae_params, vae_cfg=vae_cfg)

    def encode_audio(wav, num_frames: int,
                     window: int = dit_cfg.audio_window) -> torch.Tensor:
        return encode_audio_windows(w2v_params, w2v_cfg, wav, num_frames,
                                    window=window)

    return (pipe, _hash_text_encoder(dit_cfg.base.caption_channels, dev),
            encode_audio)
