"""Wan-VAE dispatch for the pipelines (the single-pass branch).

Counterpart of ``worldforge_tpu/pipelines/vae_dispatch.py``. The causal
chunking of the reference encoder consumes T = 1 + 4k frames and silently
drops tail frames past the last full chunk; ``_truncate_to_causal`` mirrors
that before encoding. The streaming VAE (``vae_stream.py``) is a later
slice of the port.
"""

from __future__ import annotations

from worldforge_tpu_torch.models.wan.vae import vae_decode, vae_encode


def streaming_encode_ok(t_frames: int) -> bool:
    """The causal chunking needs T = 1 + 4k."""
    return (t_frames - 1) % 4 == 0


def _truncate_to_causal(video):
    """Drop tail frames past the last full causal chunk."""
    t = video.shape[2]
    if streaming_encode_ok(t):
        return video
    return video[:, :, : 1 + 4 * ((t - 1) // 4)]


def vae_fn_pair(streaming: bool):
    """(decode_fn, encode_fn) with signature f(params, cfg, x); the encode
    fn is shape-aware (see module docstring)."""
    if streaming:
        raise NotImplementedError(
            "the streaming VAE (models/wan/vae_stream.py, --streaming-vae) "
            "is a later slice of the port; the single-pass VAE runs here")
    return vae_decode, (lambda p, cfg, v:
                        vae_encode(p, cfg, _truncate_to_causal(v)))
