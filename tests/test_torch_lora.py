"""The port's LoRA adapters (``training/lora.py``) against the JAX
package's, on the CPU.

Adapters keep the JAX layout (stacked ``[L, ...]`` over the blocks), so the
same numpy adapters go to both sides. ``init_lora`` gives the same paths
and shapes; ``apply_lora`` merges into bf16 dense leaves within 1 bf16 ulp
of JAX's and attaches unmerged terms to int8 / int4 / int6 leaves, whose
products (and the Wan DiT forward over them) agree to 1e-6 / 1e-5
relative; the gradients of ``down`` and ``up`` through ``dense`` agree with
``jax.grad`` to 1e-5; the adapter file round-trips and reads on both
sides; ``export_reference_lora`` equals JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.core import params as JP
from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.models.wan import dit as jwan
from worldforge_tpu.ops import quant as jq
from worldforge_tpu.training import lora as jlora
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io.from_jax import (dit_params_from_jax,
                                              lora_from_jax,
                                              tensor_from_numpy)
from worldforge_tpu_torch.models.wan import dit as twan
from worldforge_tpu_torch.ops import quant as tq
from worldforge_tpu_torch.training import lora as tlora

torch.set_num_threads(2)

KEY = functools.partial(jax.random.key, impl="rbg")
QUANT = {
    "bf16": None,
    "int8": {},
    "int4": dict(int4_keys=("*",), int4_group=32),
    "int6": dict(int6_keys=("*",), int6_group=32),
}


def _nptree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _base(kind):
    """The tiny JAX Wan i2v tree (bf16, head randomised), quantized as
    ``kind`` says, as numpy; and random adapters (``up`` non-zero) for it."""
    cfg = jwan.WanDiTConfig.tiny("i2v")
    p = jwan.init_wan_dit(KEY(0), cfg, dtype=jnp.bfloat16)
    head = p["head"]["head"]["w"]
    p["head"]["head"]["w"] = (0.02 * jax.random.normal(
        KEY(9), head.shape)).astype(head.dtype)
    if QUANT[kind] is not None:
        p = jq.quantize_tree(p, **QUANT[kind])
    lora = jlora.init_lora(KEY(1), p, rank=4)
    rng = np.random.default_rng(2)
    lora = {k: {"down": np.asarray(a["down"]),
                "up": (0.05 * rng.standard_normal(a["up"].shape)).astype(
                    np.float32)} for k, a in lora.items()}
    return _nptree(p), lora


@pytest.mark.parametrize("kind", list(QUANT))
def test_init_lora_paths_and_shapes_match_jax(kind):
    """The same adapter paths (JAX walks its key-sorted tree) with the same
    shapes and
    dtypes (down ~ N(0, 1/in), up zeros), from dense and quantized leaves;
    the blocks' adapters stacked over the layer list."""
    tree, _ = _base(kind)
    want = jlora.init_lora(KEY(1), _jnp(tree), rank=4)
    got = tlora.init_lora(torch.Generator().manual_seed(0),
                          dit_params_from_jax(tree), rank=4)
    assert sorted(got) == sorted(want)
    for path in want:
        for leaf in ("down", "up"):
            assert tuple(got[path][leaf].shape) == want[path][leaf].shape
            assert got[path][leaf].dtype == torch.float32
        assert not got[path]["up"].any()
    assert got["blocks/ffn/fc1"]["down"].shape == (2, 128, 4)
    d = got["blocks/self_attn/q"]["down"]
    assert 0.5 < float(d.std() * d.shape[1] ** 0.5) < 1.5


def _bf16_ulps(got, want):
    """|got - want| in units of the bf16 ulp at |want|."""
    g, w = got.float(), want.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
        torch.log2(w.abs().clamp_min(torch.finfo(torch.float32).tiny))))
    return ((g - w).abs() / ulp).max().item()


def _leaves_with_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("kind", list(QUANT))
def test_apply_lora_matches_jax(kind):
    """Dense bf16 leaves: merged within 1 bf16 ulp of JAX's merge.
    Quantized leaves: the base untouched and the unmerged terms attached;
    JAX's tree (its 0-d ``lora_scale`` given to every layer) carried over
    equals the port's, bit for bit."""
    tree, lora = _base(kind)
    want = dit_params_from_jax(_nptree(jlora.apply_lora(
        _jnp(tree), _jnp(lora), scale=0.75)))
    got = tlora.apply_lora(dit_params_from_jax(tree), lora_from_jax(lora),
                           scale=0.75)
    want_leaves = dict(_leaves_with_paths(want))
    got_leaves = dict(_leaves_with_paths(got))
    assert sorted(got_leaves) == sorted(want_leaves)
    worst = 0.0
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if w.dtype == torch.bfloat16:
            worst = max(worst, _bf16_ulps(g, w))
        else:
            assert torch.equal(g, w), path
    assert worst <= 1.0, worst
    blk = got["blocks"][1]["self_attn"]["q"]
    if kind == "bf16":
        assert "lora_down" not in blk
    else:
        assert float(blk["lora_scale"]) == 0.75
        torch.testing.assert_close(blk["lora_down"], torch.from_numpy(
            lora["blocks/self_attn/q"]["down"][1]), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["int8", "int4", "int6"])
def test_unmerged_lora_products_match_jax(kind):
    """``dense`` on a quantized leaf with its adapter attached: the base
    product plus ``((x @ down) @ up) * scale``, to 1e-6 relative."""
    tree, lora = _base(kind)
    jt = jlora.apply_lora(_jnp(tree), _jnp(lora), scale=0.5)
    tt = tlora.apply_lora(dit_params_from_jax(tree), lora_from_jax(lora),
                          scale=0.5)
    x = np.random.default_rng(3).standard_normal((2, 5, 128)).astype(
        np.float32)
    for name in ("q", "o"):
        jp = jax.tree_util.tree_map(lambda a: a[1] if a.ndim else a,
                                    jt["blocks"]["self_attn"][name])
        want = np.asarray(JP.dense(jp, jnp.asarray(x)))
        got = TP.dense(tt["blocks"][1]["self_attn"][name],
                       torch.from_numpy(x)).numpy()
        assert np.abs(got - want).max() / np.abs(want).max() <= 1e-6


def test_wan_forward_with_lora_over_w8a8_matches_jax(monkeypatch):
    """The Wan DiT over a W8A8 base with adapters on q / k / v / o / fc1 /
    fc2 (the self-attention leaves the shared-quantization fast path for
    the generic dense on both sides), under the fp32 policy, to 2e-3
    relative. The adapters' fp32 products sum in another order in the two
    frameworks, so a few activations land on the other side of a rounding
    boundary in the next quantization: recorded with JAX run op by op
    (``jax.disable_jit``), 356 of the 911,360 activation codes flipped
    (held under 0.1%), and the output moved 1.2e-3 (the same against JAX's
    traced forward). The adapters move the output. JAX's ``apply_lora``
    attaches a 0-d ``lora_scale`` to the stacked blocks, which its
    ``lax.scan`` cannot slice; the JAX side gets it as one value per
    layer."""
    tree, lora = _base("int8")
    jt = jlora.apply_lora(_jnp(tree), _jnp(lora))
    jt["blocks"] = jax.tree_util.tree_map(
        lambda a: jnp.full((2,), a) if a.ndim == 0 else a, jt["blocks"])
    tbase = dit_params_from_jax(tree)
    tt = tlora.apply_lora(tbase, lora_from_jax(lora))
    jcfg, tcfg = jwan.WanDiTConfig.tiny("i2v"), twan.WanDiTConfig.tiny("i2v")
    rng = np.random.default_rng(4)
    f32 = lambda a: a.astype(np.float32)
    x = f32(rng.standard_normal((1, 16, 3, 8, 8)))
    y = f32(rng.standard_normal((1, 20, 3, 8, 8)))
    t = np.array([500.0], np.float32)
    ctx = f32(rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)))
    clip = f32(rng.standard_normal((1, 257, jcfg.clip_dim)))
    jrun = lambda: np.asarray(jwan.wan_dit_forward(
        jt, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        clip_fea=jnp.asarray(clip), y=jnp.asarray(y), policy=J_FP32))
    run = lambda p: twan.wan_dit_forward(
        p, tcfg, torch.from_numpy(x), torch.from_numpy(t),
        torch.from_numpy(ctx), clip_fea=torch.from_numpy(clip),
        y=torch.from_numpy(y), policy=T_FP32).numpy()
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    traced = jrun()
    codes = {"jax": [], "torch": []}
    for mod, side in ((jq, "jax"), (tq, "torch")):
        def record(a, _orig=mod.quantize_activations, _side=side):
            out = _orig(a)
            codes[_side].append(np.asarray(out[0]))
            return out
        monkeypatch.setattr(mod, "quantize_activations", record)
    with jax.disable_jit():
        eager = jrun()
    got = run(tt)
    monkeypatch.undo()
    assert [c.shape for c in codes["torch"]] == [c.shape
                                                 for c in codes["jax"]]
    n_codes = sum(c.size for c in codes["jax"])
    flipped = sum(int((a != b).sum())
                  for a, b in zip(codes["torch"], codes["jax"]))
    assert n_codes == 911360 and flipped < 1e-3 * n_codes, flipped
    assert rel(got, eager) < 2e-3 and rel(got, traced) < 2e-3
    base = run(tbase)
    assert rel(got, base) > 1e-3


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "int6"])
def test_lora_gradients_through_dense_match_jax(kind):
    """d loss / d down and d loss / d up through ``dense`` (the adapter
    merged into a dense leaf for bf16 is not differentiable by design, so
    the bf16 case attaches the unmerged terms to the dense leaf directly),
    against ``jax.grad`` of JAX's ``dense``: to 1e-5 relative."""
    tree, lora = _base(kind)
    a = lora["blocks/ffn/fc1"]
    leaf = jax.tree_util.tree_map(lambda t: t[0], tree["blocks"]["ffn"]["fc1"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 6, 128)).astype(np.float32)
    g = rng.standard_normal((3, 6, 256)).astype(np.float32)
    down, up = a["down"][0], a["up"][0]

    def jloss(d, u):
        p = dict(_jnp(leaf), lora_down=d, lora_up=u,
                 lora_scale=jnp.float32(0.5))
        return jnp.sum(JP.dense(p, jnp.asarray(x)).astype(jnp.float32)
                       * jnp.asarray(g))

    jd, ju = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(down),
                                             jnp.asarray(up))
    td = torch.from_numpy(down).requires_grad_()
    tu = torch.from_numpy(up).requires_grad_()
    p = dict({k: tensor_from_numpy(v) for k, v in leaf.items()},
             lora_down=td, lora_up=tu, lora_scale=torch.tensor(0.5))
    (TP.dense(p, torch.from_numpy(x)).float()
     * torch.from_numpy(g)).sum().backward()
    for got, want in ((td.grad, jd), (tu.grad, ju)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 1e-5


def test_save_load_roundtrip_and_jax_files(tmp_path):
    """``save_lora`` -> ``load_lora`` returns the adapters bit for bit; the
    JAX package reads the port's file and the port reads the JAX
    package's."""
    _, lora = _base("int8")
    tl = lora_from_jax(lora)
    tl["blocks/self_attn/q"]["down"] = tl["blocks/self_attn/q"][
        "down"].to(torch.bfloat16)
    path = str(tmp_path / "port.safetensors")
    tlora.save_lora(path, tl)
    back = tlora.load_lora(path)
    assert list(back) == list(tl)
    for k in tl:
        for leaf in ("down", "up"):
            assert back[k][leaf].dtype == tl[k][leaf].dtype
            assert torch.equal(back[k][leaf], tl[k][leaf])
    from_port = jlora.load_lora(path)
    np.testing.assert_array_equal(
        np.asarray(from_port["blocks/ffn/fc2"]["up"]),
        lora["blocks/ffn/fc2"]["up"])
    jpath = str(tmp_path / "jax.safetensors")
    jlora.save_lora(jpath, lora)
    from_jax = tlora.load_lora(jpath)
    for k in lora:
        for leaf in ("down", "up"):
            np.testing.assert_array_equal(from_jax[k][leaf].numpy(),
                                          lora[k][leaf])


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_export_reference_lora_matches_jax(scale):
    """The reference's state dict: the same names (LongCat's mapped to the
    reference's modules, stacked adapters unrolled per layer), the same
    transposed fp32 values and ``alpha``."""
    lora = {"blocks/qkv": {"down": np.ones((2, 8, 4), np.float32),
                           "up": np.full((2, 4, 24), 0.5, np.float32)},
            "final/linear": {"down": np.arange(32, dtype=np.float32
                                               ).reshape(8, 4),
                             "up": np.ones((4, 6), np.float32)},
            "w1": {"down": np.ones((8, 4), np.float32),
                   "up": np.ones((4, 8), np.float32)}}
    _, wan_lora = _base("bf16")
    lora.update(wan_lora)
    want = jlora.export_reference_lora(lora, scale=scale)
    got = tlora.export_reference_lora(lora_from_jax(lora), scale=scale)
    assert list(got) == list(want)
    assert "blocks.1.attn.qkv.lora_down.weight" in got
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape
        np.testing.assert_array_equal(got[k].numpy(), w)
