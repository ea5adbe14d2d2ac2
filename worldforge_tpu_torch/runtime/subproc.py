"""Fresh-process VAE decode: decode final latents in a new process that
holds only the VAE.

Counterpart of ``worldforge_tpu/runtime/subproc.py``. A serving process
that hit an out-of-memory error, or that holds a 14B DiT it no longer
needs, can hand its latents to a child that starts with an empty card and
decodes there.

Protocol: the parent writes the latents (.npy) and a spec (.json); the
child (``python -m worldforge_tpu_torch.runtime.subproc <spec.json>``)
builds the Wan VAE, either from ``params_seed`` (the port's init from a
generator on the child's device, as ``io/checkpoints.py``'s loaders draw
their random weights) or from a ``save_params_host`` file, runs the
streaming decode ``reps`` times on the spec's device (the card unless it
asks for the CPU), saves the clip in [0, 1] as ``out_dtype`` and writes a
result JSON with the seconds of each rep (rep 1 builds and loads the
kernels). A child that fails makes the parent raise with its stderr.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def save_params_host(params, path: str) -> None:
    """Save a param tree as host tensors (``torch.save``), for a child to
    load; call it at load time, before the card can fail."""
    from worldforge_tpu_torch.core.params import tree_map
    torch.save(tree_map(lambda t: t.detach().cpu(), params), path)


def decode_in_subprocess(
    lat_host: np.ndarray,
    vae_cfg,
    *,
    params_seed: int = 1,
    params_path: Optional[str] = None,
    dtype: str = "bfloat16",
    chunk: int = 1,
    spatial_chunks: int = 1,
    reps: int = 1,
    timeout: int = 3600,
    env: Optional[dict] = None,
    workdir: Optional[str] = None,
    verbose: bool = True,
    device: str = "cuda",
    out_dtype: str = "float16",
) -> Tuple[Optional[np.ndarray], Sequence[float]]:
    """Decode ``lat_host`` ([B, z, T, h, w] fp32) with the streaming Wan VAE
    in a fresh process on ``device``. Returns ``(video, times)``: video in
    [0, 1] as ``out_dtype``, [B, 3, T, H, W]; times the seconds of each rep.
    ``params_path``: a ``save_params_host`` file; otherwise the child makes
    the VAE from ``params_seed`` in ``dtype``. Raises RuntimeError with the
    child's stderr if it fails. The spec, latents and clip stay in
    ``workdir`` when one is given; otherwise they go in a temporary folder
    that is removed before this returns."""
    with contextlib.ExitStack() as stack:
        # without a workdir nothing is kept: the folder goes once the clip
        # is loaded
        wd = workdir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="wf_subproc_"))
        os.makedirs(wd, exist_ok=True)
        return _decode_in(wd, lat_host, spec={
            "vae_cfg": dataclasses.asdict(vae_cfg), "dtype": dtype,
            "chunk": int(chunk), "spatial_chunks": int(spatial_chunks),
            "reps": int(reps), "params_seed": int(params_seed),
            "params_path": params_path, "device": device,
            "out_dtype": out_dtype,
        }, timeout=timeout, env=env, verbose=verbose)


def _decode_in(wd: str, lat_host, spec: dict, timeout: int,
               env: Optional[dict], verbose: bool):
    lat_path = os.path.join(wd, "latents.npy")
    out_path = os.path.join(wd, "video.npy")
    result_path = os.path.join(wd, "result.json")
    for stale in (out_path, result_path):
        if os.path.exists(stale):
            os.unlink(stale)
    np.save(lat_path, np.asarray(lat_host, np.float32))
    spec = dict(spec, lat_path=lat_path, out_path=out_path,
                result_path=result_path)
    spec_path = os.path.join(wd, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    r = subprocess.run(
        [sys.executable, "-m", "worldforge_tpu_torch.runtime.subproc",
         spec_path], capture_output=True, text=True, timeout=timeout,
        env=child_env, cwd=_ROOT)
    if verbose and r.stdout:
        print(r.stdout, end="", flush=True)
    if r.returncode != 0 or not os.path.exists(result_path):
        raise RuntimeError(f"subprocess decode failed (rc={r.returncode}): "
                           f"{r.stderr[-2000:]}")
    with open(result_path) as f:
        result = json.load(f)
    video = np.load(out_path) if os.path.exists(out_path) else None
    return video, result["times"]


def vae_from_spec(spec: dict):
    """(params, cfg) the child builds from a spec, on the spec's device."""
    from worldforge_tpu_torch.core.params import make_generator, tree_map
    from worldforge_tpu_torch.models.wan.vae import WanVAEConfig, init_wan_vae
    d = dict(spec["vae_cfg"])
    for k in ("dim_mult", "temporal_downsample"):
        if k in d:
            d[k] = tuple(d[k])
    cfg = WanVAEConfig(**d)
    dev = torch.device(spec.get("device", "cuda"))
    if spec.get("params_path"):
        params = torch.load(spec["params_path"], map_location="cpu",
                            weights_only=True)
    else:
        # drawn on the child's device, as the loaders draw their random init
        params = init_wan_vae(make_generator(spec["params_seed"], dev), cfg,
                              dtype=getattr(torch, spec["dtype"]))
    return tree_map(lambda t: t.to(dev), params), cfg


def decode_clip(params, cfg, lat: torch.Tensor, chunk: int = 1,
                spatial_chunks: int = 1) -> torch.Tensor:
    """The child's decode: the streaming decode, mapped to [0, 1] in
    fp32."""
    from worldforge_tpu_torch.models.wan.vae_stream import \
        vae_decode_streaming
    with torch.inference_mode():
        video = vae_decode_streaming(params, cfg, lat, chunk=chunk,
                                     spatial_chunks=spatial_chunks)
    return torch.clamp((video.float() + 1.0) / 2.0, 0.0, 1.0)


def _child(spec_path: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    params, cfg = vae_from_spec(spec)
    dev = next(iter(params["conv2"].values())).device
    lat = torch.from_numpy(np.load(spec["lat_path"])).to(dev)
    times = []
    out = None
    for rep in range(spec["reps"]):
        t0 = time.perf_counter()
        out = decode_clip(params, cfg, lat, spec["chunk"],
                          spec.get("spatial_chunks", 1)).cpu().numpy()
        times.append(time.perf_counter() - t0)
        print(f"[subproc-decode] rep {rep + 1}/{spec['reps']} {out.shape}: "
              f"{times[-1]:.2f} s on {dev}", flush=True)
    np.save(spec["out_path"], out.astype(spec.get("out_dtype", "float16")))
    with open(spec["result_path"], "w") as f:
        json.dump({"times": times, "shape": list(out.shape)}, f)


if __name__ == "__main__":
    _child(sys.argv[1])
