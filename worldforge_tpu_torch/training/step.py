"""Flow-matching training step for the Wan and LongCat DiTs.

Counterpart of ``worldforge_tpu/training/step.py`` (:27-83). The loss is the
inference solvers' convention: x_sigma = (1 - sigma) x0 + sigma eps, the
model predicts the flow velocity eps - x0 (fp32 target), and the DiT sees
the timestep sigma * 1000. The forward is the serving DiT itself, made
differentiable: on CUDA tensors its gradients run through the backward
kernels of kernels 1, 2 and 3 (``ops/flash_attention.py``, ``ops/rope.py``,
``ops/fused_norm.py``), and ``remat`` recomputes each block in the backward
pass (``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` around the scan
body).

The port's idiom for the step: JAX's ``step(params, opt_state, batch, key)``
is pure; here ``step(params, batch, gen)`` takes a ``torch.Generator``, and
the ``torch.optim.Optimizer`` given to ``make_train_step`` (built over
``trainable_leaves(params)``) updates the parameters in place. For
``optax.adamw`` pass ``torch.optim.AdamW(..., weight_decay=1e-4)``: optax's
default decay is 1e-4, PyTorch's 1e-2. ``sigma=`` and ``noise=`` take given
draws in place of the generator's (tests feed JAX's).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from worldforge_tpu_torch.core import params as P


def _wan_forward(params, cfg, x_sigma, t, context, *, y=None, clip_fea=None,
                 mesh=None, remat=True):
    from worldforge_tpu_torch.models.wan.dit import wan_dit_forward
    return wan_dit_forward(params, cfg, x_sigma, t, context, y=y,
                           clip_fea=clip_fea, remat=remat, mesh=mesh)


def longcat_forward(params, cfg, x_sigma, t, context, *, y=None,
                    clip_fea=None, mesh=None, remat=True):
    """LongCat adapter: the per-frame timestep vector [B, T] (``y`` and
    ``clip_fea`` are not the LongCat DiT's inputs and are ignored, as in
    JAX)."""
    from worldforge_tpu_torch.models.longcat.dit import longcat_dit_forward
    tv = t[:, None].expand(t.shape[0], x_sigma.shape[2])
    return longcat_dit_forward(params, cfg, x_sigma, tv, context, mesh=mesh,
                               remat=remat)


def flow_match_loss(params, cfg, x0, noise, sigma, context, *, y=None,
                    clip_fea=None, mesh=None, remat: bool = True,
                    forward_fn=_wan_forward):
    """Per-batch flow-matching MSE (fp32). x0 / noise: [B, C, F, H, W];
    sigma: [B] in (0, 1]; context: [B, text_len, text_dim]."""
    s = sigma[:, None, None, None, None]
    x_sigma = (1.0 - s) * x0 + s * noise
    t = sigma * 1000.0
    v = forward_fn(params, cfg, x_sigma, t, context, y=y, clip_fea=clip_fea,
                   remat=remat, mesh=mesh)
    target = (noise - x0).float()
    return (v - target).square().mean()


def trainable_leaves(tree) -> List[torch.Tensor]:
    """Every floating-point tensor leaf of a param tree, in tree order, set
    to require a gradient: what the optimizer of ``make_train_step`` (or of
    ``make_lora_train_step``, over the adapters) is built over."""
    leaves = []

    def take(t):
        if t.is_floating_point():
            leaves.append(t.requires_grad_(True))
        return t

    P.tree_map(take, tree)
    return leaves


def _draw_sigma_noise(x0: torch.Tensor, gen: torch.Generator):
    """sigma ~ U(1e-3, 1) per sample, then eps ~ N(0, 1) of x0's shape, both
    fp32 from ``gen`` (on its device), moved to x0's device."""
    b = x0.shape[0]
    u = torch.rand((b,), generator=gen, device=gen.device)
    sigma = 1e-3 + u * (1.0 - 1e-3)
    noise = torch.randn(x0.shape, generator=gen, device=gen.device)
    return sigma.to(x0.device), noise.to(x0.device)


def make_train_step(cfg, optimizer: torch.optim.Optimizer, *, mesh=None,
                    remat: bool = True, forward_fn=_wan_forward):
    """Returns ``step(params, batch, gen, *, sigma=None, noise=None) ->
    loss``. batch: dict with "x0" [B, C, F, H, W] and "context" [B, L, D]
    (plus optional "y" / "clip_fea" for i2v). sigma ~ U(1e-3, 1) per sample
    and the noise are drawn from ``gen`` unless given. The step computes the
    loss and its gradients and calls ``optimizer.step()``: the parameters
    it was built over update in place. Returns the loss (fp32 0-d, no
    gradient). ``mesh`` belongs to a later slice and raises."""
    if mesh is not None:
        raise NotImplementedError("meshes / data and FSDP parallelism are "
                                  "not ported yet (a later slice of the "
                                  "port)")

    def step(params, batch, gen: Optional[torch.Generator] = None, *,
             sigma=None, noise=None):
        x0 = batch["x0"]
        if sigma is None or noise is None:
            ds, dn = _draw_sigma_noise(x0, gen)
            sigma = ds if sigma is None else sigma
            noise = dn if noise is None else noise
        optimizer.zero_grad(set_to_none=True)
        loss = flow_match_loss(params, cfg, x0, noise, sigma,
                               batch["context"], y=batch.get("y"),
                               clip_fea=batch.get("clip_fea"), remat=remat,
                               forward_fn=forward_fn)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
