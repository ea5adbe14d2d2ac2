"""LoRA adapters over a frozen base: made, applied, saved and exported.

Counterpart of ``worldforge_tpu/training/lora.py`` (:22-98, :145-194).
Adapters keep the JAX layout, so one adapter file serves both packages: a
'/'-joined path to a dense leaf maps to ``{down [in, r], up [r, out]}``, and
a path into the blocks (``blocks/self_attn/q``) to ``{down [L, in, r],
up [L, r, out]}`` stacked over the layers. The port holds the blocks as a
list; the list at the tree's top-level ``blocks`` key stands for JAX's
stacked layer axis, and layer i takes slice i of a stacked adapter. Other
lists are left alone, as the JAX walk leaves lists alone.

``apply_lora`` merges into dense leaves and attaches unmerged terms
(``lora_down`` / ``lora_up`` / ``lora_scale``) to quantized ones, which
``core/params.py::dense`` adds at product time, so the base stays int8 /
int4 / int6.

``make_lora_train_step`` (JAX's :101) trains the adapters over a frozen
base. JAX merges them into the weights (``apply_lora``) inside its loss;
the port's step attaches them unmerged to every targeted leaf instead
(``x @ w + ((x @ down) @ up) * scale``, the same function up to fp32
rounding): a merged weight would keep a second copy of every targeted
weight alive for the backward pass (27 GB at Wan2.1-14B, beside the 33 GB
base) and would need the full weight gradient dW = x^T dy of each before
dW @ up^T gives the adapter's. With ``up`` at zero the forward is the
base forward exactly.
"""

from __future__ import annotations

from typing import Dict

import torch

from worldforge_tpu_torch.core import params as P
from worldforge_tpu_torch.io.torch_load import load_state_dict, save_safetensors
from worldforge_tpu_torch.models.longcat.dit import lora_merged_weight
from worldforge_tpu_torch.training.step import _wan_forward, make_train_step

LORA_TARGETS = ("q", "k", "v", "o", "fc1", "fc2",           # wan
                "qkv", "attn_proj", "x_q", "x_kv", "x_proj",  # longcat
                "w1", "w2", "w3")


def _leaf_shape(node: dict):
    """(in, out) of a dense or quantized leaf, else None."""
    for key, ndim, rows in (("w", 2, 1), ("w8", 2, 1), ("w4", 2, 2),
                            ("w6", 3, 4)):
        t = node.get(key)
        if isinstance(t, torch.Tensor) and t.ndim == ndim:
            return t.shape[-2] * rows, t.shape[-1]
    return None


def _children(node: dict, path: str):
    """(key, child path, is the layer list) for each entry of a dict."""
    for k, v in node.items():
        yield k, f"{path}/{k}" if path else k, (
            not path and k == "blocks" and isinstance(v, list))


def init_lora(gen: torch.Generator, params, *, rank: int = 16,
              targets=LORA_TARGETS, dtype=torch.float32) -> Dict[str, dict]:
    """Zero-effect adapters for every dense or quantized leaf named in
    ``targets``, on ``gen.device``: ``down`` ~ N(0, 1 / in), ``up`` zeros;
    stacked over the layers for the blocks. Drawn from ``gen`` in the JAX
    walk's order (a torch.Generator draws other numbers than a JAX key)."""
    adapters: Dict[str, dict] = {}

    def walk(nodes, path, stacked):
        node = nodes[0] if nodes else None
        if not isinstance(node, dict):
            return
        shape = _leaf_shape(node)
        if shape is not None and path.split("/")[-1] in targets:
            lead = (len(nodes),) if stacked else ()
            fan_in = torch.tensor(float(shape[0])).sqrt().to(dtype)
            adapters[path] = {
                "down": (P.normal(gen, lead + (shape[0], rank)).to(dtype)
                         / fan_in.to(gen.device)),
                "up": torch.zeros(lead + (rank, shape[1]), dtype=dtype,
                                  device=gen.device),
            }
            return
        for k, sub, layers in _children(node, path):
            walk(node[k] if layers else [n[k] for n in nodes], sub,
                 stacked or layers)

    walk([params], "", False)
    return adapters


def apply_lora(params, lora: Dict[str, dict], scale: float = 1.0):
    """``w' = w + scale * down @ up`` (fp32, rounded once to w's dtype) on
    dense leaves; on quantized leaves the unmerged terms are attached.
    Returns a new tree; leaves it does not change are shared."""
    return _with_lora(params, lora, scale, merge=True)


def _with_lora(params, lora: Dict[str, dict], scale: float, merge: bool):
    """``apply_lora``'s walk; ``merge=False`` attaches the unmerged terms to
    dense leaves too (the train step's form)."""

    def attach(node, a, layer):
        down, up = a["down"], a["up"]
        if layer is not None and down.ndim == 3:
            down, up = down[layer], up[layer]
        if "w" not in node or not merge:
            return dict(node, lora_down=down, lora_up=up,
                        lora_scale=torch.tensor(scale, dtype=torch.float32,
                                                device=down.device))
        return dict(node, w=lora_merged_weight(node["w"],
                                               {"down": down, "up": up},
                                               scale))

    def walk(node, path, layer):
        if not isinstance(node, dict):
            return node
        if path in lora:
            return attach(node, lora[path], layer)
        return {k: ([walk(n, sub, i) for i, n in enumerate(node[k])]
                    if layers else walk(node[k], sub, layer))
                for k, sub, layers in _children(node, path)}

    return walk(params, "", None)


def make_lora_train_step(cfg, optimizer: torch.optim.Optimizer,
                         base_params, *, mesh=None, remat: bool = True,
                         scale: float = 1.0, forward_fn=_wan_forward):
    """Returns ``step(lora, batch, gen, *, sigma=None, noise=None) ->
    loss``: ``make_train_step``'s step over the adapters, whose forward
    attaches them (unmerged, as the module note says) to ``base_params``.
    Only the adapters update (in place, through ``optimizer``, built over
    ``trainable_leaves(lora)``); the base stays frozen and unchanged."""

    def lora_forward(lora, cfg_, x_sigma, t, context, **kw):
        model = _with_lora(base_params, lora, scale, merge=False)
        return forward_fn(model, cfg_, x_sigma, t, context, **kw)

    return make_train_step(cfg, optimizer, mesh=mesh, remat=remat,
                           forward_fn=lora_forward)


# ------------------------------------------------- persistence / interop

# the reference's module names for LongCat's tree names (lora_utils.py)
_TREE_TO_TORCH = {
    "qkv": "attn.qkv", "attn_proj": "attn.proj",
    "x_q": "cross_attn.q_linear", "x_kv": "cross_attn.kv_linear",
    "x_proj": "cross_attn.proj", "w1": "ffn.w1", "w2": "ffn.w2",
    "w3": "ffn.w3", "adaln": "adaLN_modulation.1",
}


def save_lora(path: str, lora: Dict[str, dict]) -> None:
    """Adapters as one safetensors file, keys ``<path>::down`` /
    ``<path>::up`` (the JAX package's file)."""
    flat = {}
    for p, a in lora.items():
        flat[f"{p}::down"] = a["down"]
        flat[f"{p}::up"] = a["up"]
    save_safetensors(path, flat)


def load_lora(path: str, device=None) -> Dict[str, dict]:
    """``save_lora``'s file (or the JAX package's) -> adapters on
    ``device`` (the CPU by default)."""
    lora: Dict[str, dict] = {}
    sd = load_state_dict(path)
    for k in sd:
        p, leaf = k.rsplit("::", 1)
        lora.setdefault(p, {})[leaf] = sd[k].to(device)
    return lora


def export_reference_lora(lora: Dict[str, dict], *, scale: float = 1.0
                          ) -> Dict[str, torch.Tensor]:
    """Adapters -> the reference's ``lora_utils`` state dict on the CPU:
    per layer ``<module>.lora_down.weight`` [r, in], ``.lora_up.weight``
    [out, r] (fp32) and ``.alpha`` = rank * scale, so the reference's
    merge reproduces ``apply_lora(..., scale)``. Stacked adapters unroll
    to ``blocks.<i>.*``; LongCat names map to the reference's modules,
    other targets keep their tree path with '/' -> '.'."""
    sd: Dict[str, torch.Tensor] = {}

    def emit(base, down, up):
        sd[f"{base}.lora_down.weight"] = down.float().t().contiguous()
        sd[f"{base}.lora_up.weight"] = up.float().t().contiguous()
        sd[f"{base}.alpha"] = torch.tensor(down.shape[1] * scale,
                                           dtype=torch.float32)

    for p, a in lora.items():
        parts = p.split("/")
        leaf = _TREE_TO_TORCH.get(parts[-1], parts[-1])
        down, up = a["down"].detach().cpu(), a["up"].detach().cpu()
        if down.ndim == 3:
            prefix = ".".join(parts[:-1]) or "blocks"
            for i in range(down.shape[0]):
                emit(f"{prefix}.{i}.{leaf}", down[i], up[i])
        else:
            emit(".".join(parts[:-1] + [leaf]) if len(parts) > 1 else leaf,
                 down, up)
    return sd
