"""Streaming-vs-single-pass Wan-VAE dispatch for the pipelines.

Counterpart of ``worldforge_tpu/pipelines/vae_dispatch.py``. The causal
chunking of the reference encoder consumes T = 1 + 4k frames and silently
drops tail frames past the last full chunk (a T = 64 input encodes frames
[0:61]); ``_truncate_to_causal`` mirrors that before either encoder, which
keeps the refine's BSA-padded 64 frames on the streaming encoder.
"""

from __future__ import annotations

import functools

from worldforge_tpu_torch.models.wan.vae import vae_decode, vae_encode
from worldforge_tpu_torch.models.wan.vae_stream import (vae_decode_streaming,
                                                        vae_encode_streaming)


def streaming_encode_ok(t_frames: int) -> bool:
    """The causal chunking needs T = 1 + 4k."""
    return (t_frames - 1) % 4 == 0


def _truncate_to_causal(video):
    """Drop tail frames past the last full causal chunk."""
    t = video.shape[2]
    if streaming_encode_ok(t):
        return video
    return video[:, :, : 1 + 4 * ((t - 1) // 4)]


def vae_fn_pair(streaming: bool, chunk: int = 1):
    """(decode_fn, encode_fn) with signature f(params, cfg, x); the encode
    fn is shape-aware (see module docstring). ``chunk`` is the streaming
    decoder's latent frames per step."""
    if not streaming:
        return vae_decode, (lambda p, cfg, v:
                            vae_encode(p, cfg, _truncate_to_causal(v)))
    dec = functools.partial(vae_decode_streaming, chunk=chunk)

    def enc(params, cfg, video):
        return vae_encode_streaming(params, cfg, _truncate_to_causal(video))

    return dec, enc
