"""The port's checkpoint converters, LoRA merges and converted loaders
(``worldforge_tpu_torch/io/convert_*.py``, ``io/checkpoints.py``,
``models/longcat/dit.py::merge_lora``) against the JAX package's, on the
CPU.

Each test writes a synthetic checkpoint in the upstream key layout with its
own inverse writer: random values with the shapes of the JAX ``init_*``
tree (``jax.eval_shape``; no zero leaf, so a swapped or dropped leaf
shows), written as bf16, fp16 or fp32 safetensors. The JAX converter reads
the file with the JAX reader and its tree goes through
``io/from_jax.py::*_params_from_jax``; the port's converter reads the same
file with the port's reader. The two trees must be equal bit for bit (same
structure, dtypes and bits). The SVD checkpoints are written from the
frozen manifests (``tests/fixtures/svd_*_manifest.json``), the layout
contract itself.

The LoRA merges may sum ``down @ up`` in another order than the JAX CPU
dot, so a merged bf16 weight may differ by one ulp where the fp32 sum
lands on a rounding boundary: they are held to <= 1 bf16 ulp with at most
1% of the elements at 1 ulp (at these sizes none is: the merged trees are
equal). Each loader's converted branch assembles a small
pipeline from files on the CPU, and a forward of it equals the JAX
package's forward on the JAX converter's tree to 1e-4 relative (fp32
compute on both sides).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file

from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.io import convert_depthcrafter as jcdc
from worldforge_tpu.io import convert_encoders as jcenc
from worldforge_tpu.io import convert_longcat as jclc
from worldforge_tpu.io import convert_vggt as jcvggt
from worldforge_tpu.io import convert_wan as jcwan
from worldforge_tpu.io import convert_wav2vec2 as jcw2v
from worldforge_tpu.io.torch_load import load_state_dict as jload
from worldforge_tpu.models.depthcrafter import unet as junet
from worldforge_tpu.models.depthcrafter import vae as jsvae
from worldforge_tpu.models.encoders import clip_vision as jclip
from worldforge_tpu.models.encoders import umt5 as jumt5
from worldforge_tpu.models.encoders import wav2vec2 as jw2v
from worldforge_tpu.models.longcat import avatar as javt
from worldforge_tpu.models.longcat import dit as jlc
from worldforge_tpu.models.vggt import inference as jvinf
from worldforge_tpu.models.vggt import model as jvmodel
from worldforge_tpu.models.wan import dit as jdit
from worldforge_tpu.models.wan import vace as jvace
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io import checkpoints as tck
from worldforge_tpu_torch.io import convert_depthcrafter as tcdc
from worldforge_tpu_torch.io import convert_encoders as tcenc
from worldforge_tpu_torch.io import convert_longcat as tclc
from worldforge_tpu_torch.io import convert_vggt as tcvggt
from worldforge_tpu_torch.io import convert_wan as tcwan
from worldforge_tpu_torch.io import convert_wav2vec2 as tcw2v
from worldforge_tpu_torch.io import from_jax as FJ
from worldforge_tpu_torch.io.torch_load import load_state_dict as tload
from worldforge_tpu_torch.models.depthcrafter import unet as tunet
from worldforge_tpu_torch.models.encoders import clip_vision as tclip
from worldforge_tpu_torch.models.encoders import umt5 as tumt5
from worldforge_tpu_torch.models.encoders import wav2vec2 as tw2v
from worldforge_tpu_torch.models.longcat import avatar as tavt
from worldforge_tpu_torch.models.longcat import dit as tlc
from worldforge_tpu_torch.models.vggt import inference as tvinf
from worldforge_tpu_torch.models.vggt import model as tvmodel
from worldforge_tpu_torch.models.wan import dit as tdit
from worldforge_tpu_torch.models.wan import vae as tvae

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SOURCES = ("bfloat16", "float16", "float32")
TOL = 1e-4


# ------------------------------------------------------------ helpers


def _random_tree(abstract, rng, lead=0):
    """Random numpy values with the shapes of a JAX abstract tree: norm
    scales 1 + N(0, 0.1^2), 1-D leaves N(0, 0.1^2), the rest N(0, 1/fan_in)
    with fan_in the product of all but the last axis (after ``lead``
    stacked axes)."""
    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        shape = a.shape
        x = rng.standard_normal(shape).astype(np.float32)
        if name.endswith(("['scale']", "['gamma']")):
            return 1.0 + 0.1 * x
        core = shape[lead:]
        if len(core) <= 1:
            return 0.1 * x
        return (x / np.sqrt(float(np.prod(core[:-1])))).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, abstract)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _lin(sd, name, p):
    sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _ln(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _conv(sd, name, p):
    w = np.asarray(p["w"])                       # [*k, in, out]
    nd = w.ndim - 2
    sd[f"{name}.weight"] = np.ascontiguousarray(
        w.transpose((nd + 1, nd) + tuple(range(nd))))
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _patch3d(w, patch, cin):
    """dense [(pt ph pw c), out] -> Conv3d [out, c, pt, ph, pw]."""
    w = np.asarray(w).reshape(*patch, cin, -1)
    return np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2))


def _save(sd, path, source):
    """Write a numpy fp32 state dict as ``source`` safetensors."""
    dt = getattr(torch, source)
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)).to(dt)
               for k, v in sd.items()}, path)
    return path


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def _assert_same(got, want, path="tree"):
    """Same structure, dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), \
            (path, sorted(got) if isinstance(got, dict) else got,
             sorted(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert tuple(got.shape) == tuple(want.shape), path
        assert torch.equal(_bits(got), _bits(want)), path


def _j2t(tree):
    return FJ.tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _rel(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ------------------------------------------------------------ Wan DiT


def _wan_cfg(model_type):
    return dataclasses.replace(jdit.WanDiTConfig.tiny("i2v"),
                               model_type=model_type,
                               in_dim=16 if model_type == "t2v" else 36)


def _wan_tree(cfg, rng):
    return _random_tree(jax.eval_shape(
        lambda k: jdit.init_wan_dit(k, cfg, dtype=jnp.float32),
        jax.random.key(0)), rng)


def _wan_block_sd(sd, b, p):
    for a in ("self_attn", "cross_attn"):
        for k in ("q", "k", "v", "o", "k_img", "v_img"):
            if k in p[a]:
                _lin(sd, f"{b}.{a}.{k}", p[a][k])
        for k in ("norm_q", "norm_k", "norm_k_img"):
            if k in p[a]:
                _ln(sd, f"{b}.{a}.{k}", p[a][k])
    if p["norm3"]:
        _ln(sd, f"{b}.norm3", p["norm3"])
    _lin(sd, f"{b}.ffn.0", p["ffn"]["fc1"])
    _lin(sd, f"{b}.ffn.2", p["ffn"]["fc2"])
    sd[f"{b}.modulation"] = np.asarray(p["modulation"])


def wan_dit_sd(tree, cfg) -> dict:
    """The JAX Wan DiT tree -> the vendored WanModel state dict."""
    sd = {"patch_embedding.weight": _patch3d(
        tree["patch_embedding"]["w"], cfg.patch_size, cfg.in_dim),
        "patch_embedding.bias": np.asarray(tree["patch_embedding"]["b"])}
    _lin(sd, "text_embedding.0", tree["text_embedding"]["fc1"])
    _lin(sd, "text_embedding.2", tree["text_embedding"]["fc2"])
    _lin(sd, "time_embedding.0", tree["time_embedding"]["fc1"])
    _lin(sd, "time_embedding.2", tree["time_embedding"]["fc2"])
    _lin(sd, "time_projection.1", tree["time_projection"])
    for i in range(cfg.num_layers):
        _wan_block_sd(sd, f"blocks.{i}", _layer(tree["blocks"], i))
    _lin(sd, "head.head", tree["head"]["head"])
    sd["head.modulation"] = np.asarray(tree["head"]["modulation"])
    if "img_emb" in tree:
        e = tree["img_emb"]
        _ln(sd, "img_emb.proj.0", e["norm_in"])
        _lin(sd, "img_emb.proj.1", e["fc1"])
        _lin(sd, "img_emb.proj.3", e["fc2"])
        _ln(sd, "img_emb.proj.4", e["norm_out"])
        if "emb_pos" in e:
            sd["img_emb.emb_pos"] = np.asarray(e["emb_pos"])
    return sd


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("model_type", ["t2v", "i2v", "flf2v"])
def test_wan_dit_conversion_matches_jax(tmp_path, model_type, source):
    """t2v / i2v / flf2v (``k_img`` / ``v_img`` / ``norm_k_img``, flf2v's
    ``emb_pos``) from bf16, fp16 and fp32 files into the bf16 default:
    equal to the JAX converter's tree bit for bit; from fp32 into fp32 the
    tree written (the round trip)."""
    cfg = _wan_cfg(model_type)
    tree = _wan_tree(cfg, np.random.default_rng(1))
    path = _save(wan_dit_sd(tree, cfg), str(tmp_path / "dit.safetensors"),
                 source)
    tcfg = tdit.WanDiTConfig(**dataclasses.asdict(cfg))
    got = tcwan.convert_wan_dit(tload(path), tcfg, device="cpu")
    want = FJ.dit_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jcwan.convert_wan_dit(jload(path), cfg)))
    _assert_same(got, want)
    assert isinstance(got["blocks"], list)
    assert ("emb_pos" in got.get("img_emb", {})) == (model_type == "flf2v")
    if source == "float32":
        back = tcwan.convert_wan_dit(tload(path), tcfg, torch.float32,
                                     device="cpu")
        ref = FJ.dit_params_from_jax(tree)
        _assert_same(back, ref)


def test_vace_conversion_matches_jax(tmp_path):
    """VACE: the t2v trunk, the hint blocks (block 0 with ``before_proj``,
    all with ``after_proj``) and ``vace_patch_embedding``."""
    base = _wan_cfg("t2v")
    cfg = jvace.VaceConfig(base=base, vace_layers=(0, 1), vace_in_dim=8)
    tree = _random_tree(jax.eval_shape(
        lambda k: jvace.init_vace(k, cfg, dtype=jnp.float32),
        jax.random.key(0)), np.random.default_rng(2))
    sd = wan_dit_sd({k: v for k, v in tree.items()
                     if not k.startswith("vace")}, base)
    for n, blk in enumerate(tree["vace_blocks"]):
        _wan_block_sd(sd, f"vace_blocks.{n}", blk)
        _lin(sd, f"vace_blocks.{n}.after_proj", blk["after_proj"])
        if "before_proj" in blk:
            _lin(sd, f"vace_blocks.{n}.before_proj", blk["before_proj"])
    sd["vace_patch_embedding.weight"] = _patch3d(
        tree["vace_patch_embedding"]["w"], base.patch_size, cfg.vace_in_dim)
    sd["vace_patch_embedding.bias"] = np.asarray(
        tree["vace_patch_embedding"]["b"])
    path = _save(sd, str(tmp_path / "vace.safetensors"), "bfloat16")
    from worldforge_tpu_torch.models.wan.vace import VaceConfig
    tcfg = VaceConfig(base=tdit.WanDiTConfig(**dataclasses.asdict(base)),
                      vace_layers=(0, 1), vace_in_dim=8)
    got = tcwan.convert_vace(tload(path), tcfg, device="cpu")
    want = FJ.vace_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jcwan.convert_vace(jload(path), cfg)))
    _assert_same(got, want)
    assert "before_proj" in got["vace_blocks"][0]
    assert "before_proj" not in got["vace_blocks"][1]


# ------------------------------------------------------------ Wan VAE

TINY_VAE = dict(dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1)


def _vae_rms(sd, name, p):
    sd[f"{name}.gamma"] = np.asarray(p["gamma"]).reshape(-1, 1, 1, 1)


def _vae_res(sd, pre, p):
    _vae_rms(sd, f"{pre}.residual.0", p["norm1"])
    _conv(sd, f"{pre}.residual.2", p["conv1"])
    _vae_rms(sd, f"{pre}.residual.3", p["norm2"])
    _conv(sd, f"{pre}.residual.6", p["conv2"])
    if "shortcut" in p:
        _conv(sd, f"{pre}.shortcut", p["shortcut"])


def _vae_mid(sd, pre, p):
    _vae_res(sd, f"{pre}.0", p["res1"])
    _vae_rms(sd, f"{pre}.1.norm", p["attn"]["norm"])
    _conv(sd, f"{pre}.1.to_qkv", p["attn"]["qkv"])
    _conv(sd, f"{pre}.1.proj", p["attn"]["proj"])
    _vae_res(sd, f"{pre}.2", p["res2"])


def _vae_stages(sd, pre, stages, key):
    seq = 0
    for st in stages:
        for blk in st["blocks"]:
            _vae_res(sd, f"{pre}.{seq}", blk)
            seq += 1
        if key in st:
            _conv(sd, f"{pre}.{seq}.resample.1", st[key]["conv"])
            if "time_conv" in st[key]:
                _conv(sd, f"{pre}.{seq}.time_conv", st[key]["time_conv"])
            seq += 1


def wan_vae_sd(tree) -> dict:
    """A Wan VAE tree -> the ``WanVAE_`` state dict (``nn.Sequential``
    indices, RMS gammas as [C, 1, 1, 1])."""
    sd = {}
    enc, dec = tree["encoder"], tree["decoder"]
    _conv(sd, "encoder.conv1", enc["conv_in"])
    _vae_stages(sd, "encoder.downsamples", enc["stages"], "down")
    _vae_mid(sd, "encoder.middle", enc["mid"])
    _vae_rms(sd, "encoder.head.0", enc["norm_out"])
    _conv(sd, "encoder.head.2", enc["conv_out"])
    _conv(sd, "conv1", tree["conv1"])
    _conv(sd, "conv2", tree["conv2"])
    _conv(sd, "decoder.conv1", dec["conv_in"])
    _vae_mid(sd, "decoder.middle", dec["mid"])
    _vae_stages(sd, "decoder.upsamples", dec["stages"], "up")
    _vae_rms(sd, "decoder.head.0", dec["norm_out"])
    _conv(sd, "decoder.head.2", dec["conv_out"])
    return sd


def _tiny_vae_tree(seed=3):
    """The tiny VAE made with the port's init (the JAX init takes ~30 s
    here), as numpy."""
    p = tvae.init_wan_vae(TP.make_generator(seed),
                          tvae.WanVAEConfig(**TINY_VAE))
    return TP.tree_map(lambda t: t.numpy(), p)


@pytest.mark.parametrize("source", ["bfloat16", "float32"])
def test_wan_vae_conversion_matches_jax(tmp_path, source):
    """The VAE walks the ``nn.Sequential`` indices in JAX's order; as
    ``.pth``, the upstream format; fp32 sources round-trip."""
    tree = _tiny_vae_tree()
    sd = wan_vae_sd(tree)
    path = str(tmp_path / "vae.pth")
    torch.save({k: torch.from_numpy(v).to(getattr(torch, source))
                for k, v in sd.items()}, path)
    jcfg = jcwan.WanVAEConfig(**TINY_VAE)
    got = tcwan.convert_wan_vae(tload(path), tvae.WanVAEConfig(**TINY_VAE),
                                device="cpu")
    want = _j2t(jcwan.convert_wan_vae(jload(path), jcfg))
    _assert_same(got, want)
    if source == "float32":
        _assert_same(got, FJ.tree_from_numpy(tree))


# ------------------------------------------------------------ encoders


def umt5_sd(tree, cfg) -> dict:
    sd = {"shared.weight": np.asarray(tree["embed"]),
          "encoder.final_layer_norm.weight": np.asarray(
              tree["ln_f"]["scale"])}
    for i in range(cfg.num_layers):
        p = _layer(tree["blocks"], i)
        b = f"encoder.block.{i}.layer"
        sd[f"{b}.0.layer_norm.weight"] = np.asarray(p["ln1"]["scale"])
        for k in "qkvo":
            _lin(sd, f"{b}.0.SelfAttention.{k}", p[k])
        sd[f"{b}.0.SelfAttention.relative_attention_bias.weight"] = \
            np.asarray(p["rel_bias"])
        sd[f"{b}.1.layer_norm.weight"] = np.asarray(p["ln2"]["scale"])
        for k in ("wi_0", "wi_1", "wo"):
            _lin(sd, f"{b}.1.DenseReluDense.{k}", p[k])
    return sd


def clip_sd(tree, cfg, spelling="pre_layrnorm", proj=None) -> dict:
    pre = "vision_model"
    pw = np.asarray(tree["patch"]["w"]).reshape(
        cfg.patch_size, cfg.patch_size, 3, -1).transpose(3, 2, 0, 1)
    sd = {f"{pre}.embeddings.patch_embedding.weight":
          np.ascontiguousarray(pw),
          f"{pre}.embeddings.class_embedding":
          np.asarray(tree["cls"]).reshape(-1),
          f"{pre}.embeddings.position_embedding.weight":
          np.asarray(tree["pos"])[0]}
    _ln(sd, f"{pre}.{spelling}", tree["ln_pre"])
    for i in range(cfg.layers):
        p = _layer(tree["blocks"], i)
        b = f"{pre}.encoder.layers.{i}"
        _ln(sd, f"{b}.layer_norm1", p["ln1"])
        for k, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("o", "out_proj")):
            _lin(sd, f"{b}.self_attn.{n}", p[k])
        _ln(sd, f"{b}.layer_norm2", p["ln2"])
        _lin(sd, f"{b}.mlp.fc1", p["fc1"])
        _lin(sd, f"{b}.mlp.fc2", p["fc2"])
    _ln(sd, f"{pre}.post_layernorm", tree["ln_post"])
    if proj is not None:
        _lin(sd, "visual_projection", proj["proj"])
    return sd


def _umt5_tree(rng):
    cfg = jumt5.UMT5Config.tiny()
    return cfg, _random_tree(jax.eval_shape(
        lambda k: jumt5.init_umt5(k, cfg, dtype=jnp.float32),
        jax.random.key(0)), rng)


def _clip_tree(rng):
    cfg = jclip.CLIPVisionConfig.tiny()
    return cfg, _random_tree(jax.eval_shape(
        lambda k: jclip.init_clip_vision(k, cfg), jax.random.key(0)), rng)


@pytest.mark.parametrize("source", SOURCES)
def test_umt5_conversion_matches_jax(tmp_path, source):
    cfg, tree = _umt5_tree(np.random.default_rng(4))
    path = _save(umt5_sd(tree, cfg), str(tmp_path / "umt5.safetensors"),
                 source)
    got = tcenc.convert_umt5(tload(path), tumt5.UMT5Config.tiny(),
                             device="cpu")
    want = FJ.umt5_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jcenc.convert_umt5(jload(path), cfg)))
    _assert_same(got, want)


@pytest.mark.parametrize("spelling", ["pre_layrnorm", "pre_layernorm"])
@pytest.mark.parametrize("source", ["float16", "float32"])
def test_clip_conversion_matches_jax(tmp_path, spelling, source):
    """Both spellings of the pre-LayerNorm, the patch conv transposed to a
    (ph, pw, c) dense."""
    cfg, tree = _clip_tree(np.random.default_rng(5))
    path = _save(clip_sd(tree, cfg, spelling),
                 str(tmp_path / "clip.safetensors"), source)
    got = tcenc.convert_clip_vision(tload(path),
                                    tclip.CLIPVisionConfig.tiny(),
                                    device="cpu")
    want = FJ.clip_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jcenc.convert_clip_vision(jload(path), cfg)))
    _assert_same(got, want)
    if source == "float32":
        _assert_same(got, FJ.clip_params_from_jax(tree))


# ------------------------------------------------------------ LongCat

LC_KW = dict(in_channels=4, out_channels=4, hidden_size=64, depth=2,
             num_heads=2, caption_channels=32, adaln_tembed_dim=32,
             frequency_embedding_size=16)
LC_MAP = (("qkv", "attn.qkv"), ("attn_proj", "attn.proj"),
          ("x_q", "cross_attn.q_linear"), ("x_kv", "cross_attn.kv_linear"),
          ("x_proj", "cross_attn.proj"), ("w1", "ffn.w1"), ("w2", "ffn.w2"),
          ("w3", "ffn.w3"), ("adaln", "adaLN_modulation.1"))


def longcat_sd(tree, depth, avatar=None) -> dict:
    """The JAX LongCat (or avatar) tree -> ``longcat_video_dit.py``
    names."""
    sd = {"x_embedder.proj.weight": _patch3d(tree["x_embedder"]["w"],
                                             (1, 2, 2), LC_KW["in_channels"]),
          "x_embedder.proj.bias": np.asarray(tree["x_embedder"]["b"])}
    _lin(sd, "t_embedder.mlp.0", tree["t_embedder"]["fc1"])
    _lin(sd, "t_embedder.mlp.2", tree["t_embedder"]["fc2"])
    _lin(sd, "y_embedder.y_proj.0", tree["y_embedder"]["fc1"])
    _lin(sd, "y_embedder.y_proj.2", tree["y_embedder"]["fc2"])
    _lin(sd, "final_layer.adaLN_modulation.1", tree["final"]["adaln"])
    _lin(sd, "final_layer.linear", tree["final"]["linear"])
    for i in range(depth):
        p, b = _layer(tree["blocks"], i), f"blocks.{i}"
        for key, name in LC_MAP:
            _lin(sd, f"{b}.{name}", p[key])
        for key, name in (("q_norm", "attn.q_norm"),
                          ("k_norm", "attn.k_norm"),
                          ("x_q_norm", "cross_attn.q_norm"),
                          ("x_k_norm", "cross_attn.k_norm"),
                          ("pre_crs_norm", "pre_crs_attn_norm")):
            _ln(sd, f"{b}.{name}", p[key])
        if avatar is None:
            continue
        a = f"{b}.audio_cross_attn"
        _lin(sd, f"{b}.audio_adaLN_modulation.1", p["audio_adaln"])
        _ln(sd, f"{b}.pre_video_crs_attn_norm", p["pre_video_norm"])
        for key, name in (("a_q", "q_linear"), ("a_kv", "kv_linear"),
                          ("a_proj", "proj")):
            _lin(sd, f"{a}.{name}", p[key])
        _ln(sd, f"{a}.q_norm", p["a_q_norm"])
        _ln(sd, f"{a}.k_norm", p["a_k_norm"])
        if avatar.audio_prenorm:
            _ln(sd, f"{b}.pre_audio_crs_attn_norm", p["pre_audio_norm"])
    if avatar is not None:
        for k in ("proj1", "proj1_vf", "proj2", "proj3"):
            _lin(sd, f"audio_proj.{k}", tree["audio_proj"][k])
        _ln(sd, "audio_proj.norm", tree["audio_proj"]["norm"])
    return sd


def _lc_tree(rng):
    cfg = jlc.LongCatDiTConfig(**LC_KW)
    return cfg, _random_tree(jax.eval_shape(
        lambda k: jlc.init_longcat_dit(k, cfg, dtype=jnp.float32),
        jax.random.key(0)), rng)


@pytest.mark.parametrize("source", SOURCES)
def test_longcat_conversion_matches_jax(tmp_path, source):
    cfg, tree = _lc_tree(np.random.default_rng(6))
    path = _save(longcat_sd(tree, cfg.depth),
                 str(tmp_path / "lc.safetensors"), source)
    got = tclc.convert_longcat_dit(tload(path),
                                   tlc.LongCatDiTConfig(**LC_KW),
                                   device="cpu")
    want = FJ.longcat_dit_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jclc.convert_longcat_dit(jload(path), cfg)))
    _assert_same(got, want)


AUDIO_KW = dict(audio_blocks=2, audio_channels=8, intermediate_dim=16,
                output_dim=8, context_tokens=4)


def _avatar_cfgs(prenorm):
    jcfg = javt.AvatarConfig(base=jlc.LongCatDiTConfig(**LC_KW),
                             audio_prenorm=prenorm, **AUDIO_KW)
    tcfg = tavt.AvatarConfig(base=tlc.LongCatDiTConfig(**LC_KW),
                             audio_prenorm=prenorm, **AUDIO_KW)
    return jcfg, tcfg


@pytest.mark.parametrize("prenorm", [False, True])
def test_avatar_conversion_matches_jax(tmp_path, prenorm):
    """Both ``audio_prenorm`` branches: the LayerNorm from the checkpoint,
    or an inert one where the reference has ``nn.Identity``."""
    jcfg, tcfg = _avatar_cfgs(prenorm)
    tree = _random_tree(jax.eval_shape(
        lambda k: javt.init_avatar_dit(k, jcfg, dtype=jnp.float32),
        jax.random.key(0)), np.random.default_rng(7))
    path = _save(longcat_sd(tree, jcfg.base.depth, jcfg),
                 str(tmp_path / "avatar.safetensors"), "bfloat16")
    got = tclc.convert_avatar_dit(tload(path), tcfg, device="cpu")
    want = FJ.avatar_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jclc.convert_avatar_dit(jload(path), jcfg)))
    _assert_same(got, want)
    inert = got["blocks"][0]["pre_audio_norm"]
    assert bool((inert["scale"] == 1).all()) != prenorm


# ------------------------------------------------------------ wav2vec2


def wav2vec2_sd(tree, cfg, spelling) -> dict:
    sd = {}
    fe = "feature_extractor.conv_layers"
    for i, layer in enumerate(tree["convs"]):
        sd[f"{fe}.{i}.conv.weight"] = np.ascontiguousarray(
            np.asarray(layer["conv"]["w"]).transpose(2, 1, 0))
        if "b" in layer["conv"]:
            sd[f"{fe}.{i}.conv.bias"] = np.asarray(layer["conv"]["b"])
        if "norm" in layer:
            _ln(sd, f"{fe}.0.layer_norm", layer["norm"])
    _ln(sd, "feature_projection.layer_norm", tree["fp_norm"])
    _lin(sd, "feature_projection.projection", tree["fp_proj"])
    v = np.asarray(tree["pos_conv"]["w"]).transpose(2, 1, 0)  # [o, i/g, k]
    g = np.sqrt((v.astype(np.float64) ** 2).sum((0, 1), keepdims=True)) \
        * (1.0 + 0.5 * np.random.default_rng(8).random((1, 1, v.shape[2])))
    pos = "encoder.pos_conv_embed.conv"
    gk, vk = {"weight_g": ("weight_g", "weight_v"),
              "parametrizations": ("parametrizations.weight.original0",
                                   "parametrizations.weight.original1")
              }[spelling]
    sd[f"{pos}.{gk}"] = g.astype(np.float32)
    sd[f"{pos}.{vk}"] = np.ascontiguousarray(v)
    sd[f"{pos}.bias"] = np.asarray(tree["pos_conv"]["b"])
    _ln(sd, "encoder.layer_norm", tree["enc_norm"])
    for i, p in enumerate(tree["layers"]):
        lp = f"encoder.layers.{i}"
        for k, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("o", "out_proj")):
            _lin(sd, f"{lp}.attention.{n}", p[k])
        _ln(sd, f"{lp}.layer_norm", p["ln"])
        _lin(sd, f"{lp}.feed_forward.intermediate_dense", p["ff1"])
        _lin(sd, f"{lp}.feed_forward.output_dense", p["ff2"])
        _ln(sd, f"{lp}.final_layer_norm", p["final_ln"])
    return sd


def _w2v_tree(rng):
    cfg = jw2v.Wav2Vec2Config.tiny()
    return cfg, _random_tree(jax.eval_shape(
        lambda k: jw2v.init_wav2vec2(k, cfg), jax.random.key(0)), rng)


@pytest.mark.parametrize("spelling", ["weight_g", "parametrizations"])
def test_wav2vec2_conversion_matches_jax(tmp_path, spelling):
    """The weight-normed positional conv resolved in float64 then cast, from
    either key spelling."""
    cfg, tree = _w2v_tree(np.random.default_rng(9))
    path = str(tmp_path / "w2v.safetensors")
    np_save_file(wav2vec2_sd(tree, cfg, spelling), path)
    got = tcw2v.convert_wav2vec2(tload(path), tw2v.Wav2Vec2Config.tiny(),
                                 device="cpu")
    want = FJ.wav2vec2_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jcw2v.convert_wav2vec2(jload(path), cfg)))
    _assert_same(got, want)
    assert not torch.equal(got["pos_conv"]["w"],
                           torch.from_numpy(tree["pos_conv"]["w"]))


# ------------------------------------------------------------ VGGT


def _vit_sd(sd, pre, p, qk_norm=False):
    _ln(sd, f"{pre}.norm1", p["norm1"])
    _lin(sd, f"{pre}.attn.qkv", p["qkv"])
    _lin(sd, f"{pre}.attn.proj", p["proj"])
    sd[f"{pre}.ls1.gamma"] = np.asarray(p["ls1"]["gamma"])
    _ln(sd, f"{pre}.norm2", p["norm2"])
    _lin(sd, f"{pre}.mlp.fc1", p["fc1"])
    _lin(sd, f"{pre}.mlp.fc2", p["fc2"])
    sd[f"{pre}.ls2.gamma"] = np.asarray(p["ls2"]["gamma"])
    if qk_norm:
        _ln(sd, f"{pre}.attn.q_norm", p["q_norm"])
        _ln(sd, f"{pre}.attn.k_norm", p["k_norm"])


def _dpt_sd(sd, pre, h):
    def dconv(name, p):                     # flipped HWIO -> [in, out, k, k]
        w = np.asarray(p["w"])[::-1, ::-1]
        sd[f"{name}.weight"] = np.ascontiguousarray(w.transpose(2, 3, 0, 1))
        sd[f"{name}.bias"] = np.asarray(p["b"])
    _ln(sd, f"{pre}.norm", h["norm"])
    for i, p in enumerate(h["projects"]):
        _conv(sd, f"{pre}.projects.{i}", p)
    dconv(f"{pre}.resize_layers.0", h["resize0"])
    dconv(f"{pre}.resize_layers.1", h["resize1"])
    _conv(sd, f"{pre}.resize_layers.3", h["resize3"])
    for i, p in zip((1, 2, 3, 4), h["layer_rn"]):
        _conv(sd, f"{pre}.scratch.layer{i}_rn", p)
    _conv(sd, f"{pre}.scratch.output_conv1", h["out_conv1"])
    _conv(sd, f"{pre}.scratch.output_conv2.0", h["out_conv2a"])
    _conv(sd, f"{pre}.scratch.output_conv2.2", h["out_conv2b"])
    for i in range(1, 5):
        rn, r = f"{pre}.scratch.refinenet{i}", h[f"refine{i}"]
        if i < 4:                            # refinenet4 has no unit 1
            _conv(sd, f"{rn}.resConfUnit1.conv1", r["rcu1_conv1"])
            _conv(sd, f"{rn}.resConfUnit1.conv2", r["rcu1_conv2"])
        _conv(sd, f"{rn}.resConfUnit2.conv1", r["rcu2_conv1"])
        _conv(sd, f"{rn}.resConfUnit2.conv2", r["rcu2_conv2"])
        _conv(sd, f"{rn}.out_conv", r["out"])


def vggt_sd(tree, cfg) -> dict:
    sd = {}
    agg, bb = tree["aggregator"], tree["aggregator"]["backbone"]
    pe = "aggregator.patch_embed"
    ps = cfg.patch_size
    sd[f"{pe}.patch_embed.proj.weight"] = np.ascontiguousarray(
        np.asarray(bb["patch"]["w"]).reshape(ps, ps, 3, -1).transpose(
            3, 2, 0, 1))
    sd[f"{pe}.patch_embed.proj.bias"] = np.asarray(bb["patch"]["b"])
    for k, n in (("cls", "cls_token"), ("registers", "register_tokens"),
                 ("pos", "pos_embed")):
        sd[f"{pe}.{n}"] = np.asarray(bb[k])
    for i, p in enumerate(bb["blocks"]):
        _vit_sd(sd, f"{pe}.blocks.{i}", p)
    _ln(sd, f"{pe}.norm", bb["norm"])
    sd["aggregator.camera_token"] = np.asarray(agg["camera_token"])
    sd["aggregator.register_token"] = np.asarray(agg["register_token"])
    for kind in ("frame_blocks", "global_blocks"):
        for i in range(cfg.depth):
            _vit_sd(sd, f"aggregator.{kind}.{i}", _layer(agg[kind], i), True)
    ch, cam = "camera_head", tree["camera_head"]
    for i, p in enumerate(cam["trunk"]):
        _vit_sd(sd, f"{ch}.trunk.{i}", p)
    _ln(sd, f"{ch}.token_norm", cam["token_norm"])
    _ln(sd, f"{ch}.trunk_norm", cam["trunk_norm"])
    sd[f"{ch}.empty_pose_tokens"] = np.asarray(cam["empty_pose"])
    for k, n in (("embed_pose", "embed_pose"),
                 ("mod", "poseLN_modulation.1"),
                 ("branch_fc1", "pose_branch.fc1"),
                 ("branch_fc2", "pose_branch.fc2")):
        _lin(sd, f"{ch}.{n}", cam[k])
    for head in ("depth_head", "point_head"):
        if head in tree:
            _dpt_sd(sd, head, tree[head])
    return sd


def _vggt_tree(rng, point=True):
    cfg = jvmodel.VGGTConfig.tiny()
    return cfg, _random_tree(jax.eval_shape(
        lambda k: jvinf.init_vggt_full(k, cfg, enable_point=point),
        jax.random.key(0)), rng)


def test_vggt_conversion_matches_jax(tmp_path):
    """Aggregator, camera head, depth and point heads; the resize deconvs
    flipped as JAX flips them; ``track_head.*`` keys left alone."""
    cfg, tree = _vggt_tree(np.random.default_rng(10))
    for head in ("depth_head", "point_head"):   # not in the checkpoint
        r4 = tree[head]["refine4"]
        for k in ("rcu1_conv1", "rcu1_conv2"):
            r4[k] = jax.tree_util.tree_map(np.zeros_like, r4[k])
    sd = vggt_sd(tree, cfg)
    path = _save(sd, str(tmp_path / "vggt.safetensors"), "float32")
    tcfg = tvmodel.VGGTConfig.tiny()
    got = tcvggt.load_converted_vggt(path, tcfg, device="cpu")
    want = FJ.vggt_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jcvggt.load_converted_vggt(path, cfg)))
    _assert_same(got, want)
    assert "point_head" in got
    _assert_same(got, FJ.vggt_params_from_jax(tree))
    sd["track_head.tracker.fmap_norm.weight"] = np.ones(4, np.float32)
    tracked = tcvggt.convert_vggt(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
        device="cpu")
    assert "track_head" not in tracked
    _assert_same(tracked, got)


# ------------------------------------------------------------ SVD


def _manifest_sd(fixture, seed):
    with open(os.path.join(FIX, fixture)) as f:
        manifest = json.load(f)
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) * 0.1
            for k, s in manifest.items()}


@pytest.mark.parametrize("which", ["unet", "vae"])
def test_svd_conversion_matches_jax(tmp_path, which):
    """The SVD UNet and VAE written from the frozen manifests (every name
    and torch shape of the layout contract): the trees equal JAX's bit for
    bit, and their shapes equal the tiny configs' inits."""
    fixture = f"svd_{which}_manifest.json"
    sd = _manifest_sd(fixture, 11)
    path = _save(sd, str(tmp_path / f"{which}.safetensors"), "float32")
    if which == "unet":
        got = tcdc.convert_svd_unet(tload(path), tunet.SVDUNetConfig.tiny(),
                                    device="cpu")
        want = jcdc.convert_svd_unet(jload(path),
                                     junet.SVDUNetConfig.tiny())
        shapes = jax.eval_shape(lambda k: junet.init_svd_unet(
            k, junet.SVDUNetConfig.tiny()), jax.random.key(0))
    else:
        from worldforge_tpu_torch.models.depthcrafter import vae as tv
        got = tcdc.convert_svd_vae(tload(path), tv.SVDVAEConfig.tiny(),
                                   device="cpu")
        want = jcdc.convert_svd_vae(jload(path), jsvae.SVDVAEConfig.tiny())
        shapes = jax.eval_shape(lambda k: jsvae.init_svd_vae(
            k, jsvae.SVDVAEConfig.tiny()), jax.random.key(0))
    _assert_same(got, _j2t(want))
    assert jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes) == \
        TP.tree_map(lambda t: tuple(t.shape), got)


def test_svd_layout_drift_raises_as_jax():
    """A missing key and an unconsumed key raise JAX's ``ValueError``, with
    its message."""
    sd = _manifest_sd("svd_unet_manifest.json", 12)
    cfg_j, cfg_t = junet.SVDUNetConfig.tiny(), tunet.SVDUNetConfig.tiny()
    t = {k: torch.from_numpy(v) for k, v in sd.items()}

    def both(jsd, tsd):
        with pytest.raises(ValueError) as je:
            jcdc.convert_svd_unet(jsd, cfg_j)
        with pytest.raises(ValueError) as te:
            tcdc.convert_svd_unet(tsd, cfg_t, device="cpu")
        assert str(te.value) == str(je.value)
        return str(te.value)

    key = "mid_block.attentions.0.proj_in.weight"
    msg = both({k: v for k, v in sd.items() if k != key},
               {k: v for k, v in t.items() if k != key})
    assert "missing key" in msg and "proj_in" in msg
    extra = "a_new_upstream_module.weight"
    msg = both({**sd, extra: np.zeros(3, np.float32)},
               {**t, extra: torch.zeros(3)})
    assert "never consumed" in msg and extra in msg
    vsd = _manifest_sd("svd_vae_manifest.json", 13)
    vsd["decoder.extra.weight"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError) as je:
        jcdc.convert_svd_vae(vsd, jsvae.SVDVAEConfig.tiny())
    from worldforge_tpu_torch.models.depthcrafter import vae as tv
    with pytest.raises(ValueError) as te:
        tcdc.convert_svd_vae({k: torch.from_numpy(v)
                              for k, v in vsd.items()},
                             tv.SVDVAEConfig.tiny(), device="cpu")
    assert str(te.value) == str(je.value)
    tcdc.convert_svd_vae({k: torch.from_numpy(v) for k, v in vsd.items()},
                         tv.SVDVAEConfig.tiny(), strict=False,
                         device="cpu")


# ------------------------------------------------------------ LoRA

HY = "___lorahyphen___"


def _lora_sd(rng, tree, r=4):
    """Adapters in the ``lora_utils`` naming on every block target: plain
    ups, ``lora_up.blocks.N`` (n_seperate 2 and 3), the ``alpha_scale``
    buffer, a stored ``alpha`` and neither, hyphenated names, and two
    adapters with no block leaf."""
    sd = {}

    def name(path):
        return "lora" + HY + path.replace(".", HY)

    for i in range(LC_KW["depth"]):
        p = _layer(tree["blocks"], i)
        for j, (key, sub) in enumerate(LC_MAP):
            din, dout = np.asarray(p[key]["w"]).shape
            n = {"attn.qkv": 3, "cross_attn.kv_linear": 2}.get(sub, 1)
            nm = name(f"blocks.{i}.{sub}") if j % 2 else f"blocks.{i}.{sub}"
            sd[f"{nm}.lora_down.weight"] = rng.standard_normal(
                (n * r, din)).astype(np.float32) * 0.3
            if n == 1:
                sd[f"{nm}.lora_up.weight"] = rng.standard_normal(
                    (dout, r)).astype(np.float32) * 0.3
            else:
                for b in range(n):
                    sd[f"{nm}.lora_up.blocks.{b}.weight"] = \
                        rng.standard_normal((dout // n, r)).astype(
                            np.float32) * 0.3
            if j % 3 == 0:
                sd[f"{nm}.alpha_scale"] = np.array(8.0 / r, np.float32)
            elif j % 3 == 1:
                sd[f"{nm}.alpha"] = np.array(16.0, np.float32)
    for nm in (name("final_layer.linear"), "blocks.0.attn.unmapped"):
        sd[f"{nm}.lora_down.weight"] = np.ones((r, 8), np.float32)
        sd[f"{nm}.lora_up.weight"] = np.ones((8, r), np.float32)
    return sd


def _ulp_diff(got, want):
    """|got - want| in bf16 ulps (of want), as a float tensor."""
    g, w = got.float(), want.float()
    ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133),
                      2.0 ** (torch.floor(torch.log2(w.abs())) - 7))
    return (g - w).abs() / ulp


def _assert_within_one_ulp(got, want, share):
    """Trees equal in structure and dtype, bf16 leaves within 1 ulp of
    JAX's with at most ``share`` of their elements off, others equal."""
    off = total = 0
    stack = [(got, want)]
    while stack:
        g, w = stack.pop()
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            stack += [(g[k], w[k]) for k in w]
        elif isinstance(w, list):
            stack += list(zip(g, w))
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            if g.dtype == torch.bfloat16:
                d = _ulp_diff(g, w)
                assert float(d.max()) <= 1.0
                off += int((d > 0).sum())
                total += d.numel()
            else:
                assert torch.equal(g, w)
    assert off <= share * total, (off, total)
    return off / total


@pytest.mark.parametrize("source", ["bfloat16", "float32"])
def test_lora_conversion_and_stacked_merge_match_jax(tmp_path, capsys,
                                                     source):
    """``convert_longcat_lora``: the same adapters as JAX (plain and
    block-diagonal ups, both alpha rules, the hyphen rewriting) exactly;
    ``merge_lora_stacked`` into a bf16 tree within 1 bf16 ulp of JAX's,
    and the same printed line for the adapters with no block leaf."""
    jcfg, tree = _lc_tree(np.random.default_rng(14))
    path = _save(_lora_sd(np.random.default_rng(15), tree),
                 str(tmp_path / "lora.safetensors"), source)
    tl = tclc.convert_longcat_lora(tload(path), multiplier=0.7)
    jl = jclc.convert_longcat_lora(jload(path), multiplier=0.7)
    assert sorted(tl) == sorted(jl)
    assert "final_layer.linear" in tl and "blocks.1.attn.qkv" in tl
    for k in jl:
        for part in ("down", "up"):
            _assert_same(tl[k][part], torch.from_numpy(
                np.array(jl[k][part])))
        assert tl[k]["alpha"] == jl[k]["alpha"]
        assert tl[k]["multiplier"] == jl[k]["multiplier"] == 0.7
    assert tl["blocks.0.attn.qkv"]["up"].shape == (12, 192)

    jparams = jclc.convert_longcat_dit(jload(_save(
        longcat_sd(tree, jcfg.depth), str(tmp_path / "lc.safetensors"),
        "bfloat16")), jcfg)
    tparams = FJ.longcat_dit_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams))
    capsys.readouterr()
    want = FJ.longcat_dit_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jclc.merge_lora_stacked(jparams, jl)))
    jprint = capsys.readouterr().out
    got = tclc.merge_lora_stacked(tparams, tl)
    assert capsys.readouterr().out == jprint
    assert "2 adapter(s)" in jprint and "final_layer.linear" in jprint
    _assert_within_one_ulp(got, want, share=0.01)
    assert not torch.equal(got["blocks"][1]["qkv"]["w"],
                           tparams["blocks"][1]["qkv"]["w"])
    assert got["x_embedder"]["w"] is tparams["x_embedder"]["w"]


def test_merge_and_unmerge_lora_match_jax():
    """The path-keyed ``merge_lora`` / ``unmerge_lora``: a top-level dense
    and JAX's stacked block path (every layer)."""
    jcfg = jlc.LongCatDiTConfig(**LC_KW)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16),
        _random_tree(jax.eval_shape(
            lambda k: jlc.init_longcat_dit(k, jcfg, dtype=jnp.float32),
            jax.random.key(0)), np.random.default_rng(16)))
    tp = FJ.longcat_dit_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp))
    rng = np.random.default_rng(17)

    def adapter(din, dout, r=4, **kw):
        return {"down": rng.standard_normal((din, r)).astype(np.float32),
                "up": rng.standard_normal((r, dout)).astype(np.float32),
                **kw}

    lora = {"final/linear": adapter(64, 16, alpha=2.0, multiplier=0.5),
            "blocks/w1": adapter(64, 256, alpha=8.0)}
    jl = {k: {**v, "down": jnp.asarray(v["down"]),
              "up": jnp.asarray(v["up"])} for k, v in lora.items()}
    tl = {k: {**v, "down": torch.from_numpy(v["down"]),
              "up": torch.from_numpy(v["up"])} for k, v in lora.items()}
    for jfn, tfn in ((jlc.merge_lora, tlc.merge_lora),
                     (jlc.unmerge_lora, tlc.unmerge_lora)):
        want = FJ.longcat_dit_params_from_jax(jax.tree_util.tree_map(
            np.asarray, jfn(jp, jl, scale=0.8)))
        _assert_within_one_ulp(tfn(tp, tl, scale=0.8), want, share=0.01)
    every = tlc.merge_lora(tp, {"blocks/w1": tl["blocks/w1"]})
    for blk, old in zip(every["blocks"], tp["blocks"]):
        assert not torch.equal(blk["w1"]["w"], old["w1"]["w"])
        assert blk["w3"]["w"] is old["w3"]["w"]


# ------------------------------------------------------------ loaders


def _write_encoders(root, rng, clip_spelling="pre_layrnorm"):
    """Tiny UMT5 and CLIP checkpoints in ``text_encoder/`` and
    ``image_encoder/``; returns the JAX configs and trees."""
    ucfg, utree = _umt5_tree(rng)
    os.makedirs(os.path.join(root, "text_encoder"))
    _save(umt5_sd(utree, ucfg), os.path.join(
        root, "text_encoder", "model.safetensors"), "bfloat16")
    ccfg, ctree = _clip_tree(rng)
    os.makedirs(os.path.join(root, "image_encoder"))
    _save(clip_sd(ctree, ccfg, clip_spelling),
          os.path.join(root, "image_encoder", "model.safetensors"),
          "float32")
    return ucfg, ccfg


def _write_sharded(sd, d, source, n=3):
    """``sd`` as ``n`` safetensors shards with an index, as upstream."""
    os.makedirs(d)
    names = sorted(sd)
    wm = {}
    for i in range(n):
        part = names[i::n]
        f = f"diffusion_pytorch_model-{i + 1:05d}-of-{n:05d}.safetensors"
        _save({k: sd[k] for k in part}, os.path.join(d, f), source)
        wm.update({k: f for k in part})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as fh:
        json.dump({"weight_map": wm}, fh)


def _write_vae(root, name="vae"):
    os.makedirs(os.path.join(root, name))
    tree = _tiny_vae_tree()
    torch.save({k: torch.from_numpy(v) for k, v in wan_vae_sd(tree).items()},
               os.path.join(root, name, "Wan2.1_VAE.pth"))


def _dit_inputs(rng, cin, cout, text_len, text_dim):
    x = rng.standard_normal((1, cout, 3, 8, 8)).astype(np.float32)
    y = rng.standard_normal((1, cin - cout, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, text_len, text_dim)).astype(np.float32)
    return x, y, ctx


def test_load_wan_pipeline_from_files_matches_jax(tmp_path):
    """``load_wan_pipeline(models_dir)`` on a small i2v set (sharded DiT
    with an index, ``.pth`` VAE, UMT5, CLIP): the DiT forward, the UMT5
    encode of token ids and the CLIP encode of an image against the JAX
    functions on the JAX converters' trees, to 1e-4; the tokenizer is not
    built until a prompt is encoded."""
    rng = np.random.default_rng(18)
    root = str(tmp_path)
    cfg = _wan_cfg("i2v")
    _write_sharded(wan_dit_sd(_wan_tree(cfg, rng), cfg),
                   os.path.join(root, "transformer"), "bfloat16")
    _write_vae(root)
    ucfg, ccfg = _write_encoders(root, rng, "pre_layernorm")
    tcfg = tdit.WanDiTConfig(**dataclasses.asdict(cfg))
    pipe, enc_t, enc_i = tck.load_wan_pipeline(
        root, device="cpu", dit_cfg=tcfg,
        vae_cfg=tvae.WanVAEConfig(**TINY_VAE),
        umt5_cfg=tumt5.UMT5Config.tiny(),
        clip_cfg=tclip.CLIPVisionConfig.tiny(), policy=T_FP32)
    assert pipe.dit_params["blocks"][0]["ffn"]["fc1"]["w"].dtype == \
        torch.float32
    jdp = jcwan.convert_wan_dit(jload(os.path.join(root, "transformer")),
                                cfg, jnp.float32)
    x, y, ctx = _dit_inputs(rng, cfg.in_dim, cfg.out_dim, cfg.text_len,
                            cfg.text_dim)
    clip = rng.standard_normal((1, 257, cfg.clip_dim)).astype(np.float32)
    t = np.array([500.0], np.float32)
    want = jdit.wan_dit_forward(jdp, cfg, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(ctx), clip_fea=jnp.asarray(clip),
                                y=jnp.asarray(y), policy=J_FP32)
    got = tdit.wan_dit_forward(pipe.dit_params, tcfg, torch.from_numpy(x),
                               torch.from_numpy(t), torch.from_numpy(ctx),
                               clip_fea=torch.from_numpy(clip),
                               y=torch.from_numpy(y), policy=T_FP32)
    assert _rel(got, want) < TOL
    _assert_same(pipe.vae_params, _j2t(jcwan.convert_wan_vae(
        jload(os.path.join(root, "vae")), jcwan.WanVAEConfig(**TINY_VAE))))
    ids = rng.integers(0, ucfg.vocab_size, (1, 12))
    mask = np.ones((1, 12), np.int32)
    mask[0, 7:] = 0
    jup = jcenc.convert_umt5(jload(os.path.join(root, "text_encoder")),
                             ucfg)
    tdir = tload(os.path.join(root, "text_encoder"))
    assert _rel(tumt5.umt5_encode(
        tcenc.convert_umt5(tdir, enc_t.cfg, torch.float32, "cpu"),
        enc_t.cfg, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.float32), jumt5.umt5_encode(
        jcenc.convert_umt5(jload(os.path.join(root, "text_encoder")), ucfg,
                           jnp.float32), ucfg, jnp.asarray(ids),
        jnp.asarray(mask), jnp.float32)) < TOL
    # the loader's bf16 encoder, bf16 matmuls on both sides: bf16 noise
    assert _rel(enc_t.encode_ids(ids, mask), jumt5.umt5_encode(
        jup, ucfg, jnp.asarray(ids), jnp.asarray(mask))) < 2e-2
    assert enc_t._tokenizer is None
    img = rng.random((30, 40, 3)).astype(np.float32)
    jcp = jcenc.convert_clip_vision(
        jload(os.path.join(root, "image_encoder")), ccfg)
    assert _rel(enc_i(img), jclip.clip_vision_hidden(
        jcp, ccfg, jnp.asarray(jclip.preprocess_clip(
            img, ccfg.image_size)))) < TOL


def test_load_longcat_pipeline_with_distill_lora_matches_jax(tmp_path):
    """``load_longcat_pipeline(dir, use_distill=True)``: the DiT with the
    distill LoRA from ``lora/cfg_step_lora.safetensors`` merged; its
    forward against the JAX forward on JAX's converted, merged tree;
    without ``use_distill`` the weights are the converted ones."""
    rng = np.random.default_rng(19)
    root = str(tmp_path)
    jcfg, tree = _lc_tree(rng)
    os.makedirs(os.path.join(root, "dit"))
    _save(longcat_sd(tree, jcfg.depth),
          os.path.join(root, "dit", "model.safetensors"), "float32")
    os.makedirs(os.path.join(root, "lora"))
    lora_path = _save(_lora_sd(rng, tree), os.path.join(
        root, "lora", "cfg_step_lora.safetensors"), "float32")
    _write_vae(root)
    _write_encoders(root, rng)
    tcfg = tlc.LongCatDiTConfig(**LC_KW)
    kw = dict(device="cpu", dit_cfg=tcfg,
              vae_cfg=tvae.WanVAEConfig(**TINY_VAE),
              umt5_cfg=tumt5.UMT5Config.tiny(), policy=T_FP32)
    pipe, _ = tck.load_longcat_pipeline(root, use_distill=True, **kw)
    plain, _ = tck.load_longcat_pipeline(root, **kw)
    jp = jclc.convert_longcat_dit(jload(os.path.join(root, "dit")), jcfg,
                                  jnp.float32)
    _assert_same(plain.dit_params, FJ.longcat_dit_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    jm = jclc.merge_lora_stacked(
        jp, jclc.convert_longcat_lora(jload(lora_path)))
    x = rng.standard_normal((1, 4, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    t = np.full((1, 3), 400.0, np.float32)
    want = jlc.longcat_dit_forward(
        jm, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        encoder_attention_mask=jnp.ones((1, 6), jnp.int32), policy=J_FP32)
    got = tlc.longcat_dit_forward(
        pipe.dit_params, tcfg, torch.from_numpy(x), torch.from_numpy(t),
        torch.from_numpy(ctx),
        encoder_attention_mask=torch.ones((1, 6), dtype=torch.int32),
        policy=T_FP32)
    assert _rel(got, want) < TOL
    unmerged = tlc.longcat_dit_forward(
        plain.dit_params, tcfg, torch.from_numpy(x), torch.from_numpy(t),
        torch.from_numpy(ctx),
        encoder_attention_mask=torch.ones((1, 6), dtype=torch.int32),
        policy=T_FP32)
    assert _rel(unmerged, want) > 1e-2


def test_load_avatar_pipeline_from_files_matches_jax(tmp_path):
    """``load_avatar_pipeline(dir)``: the avatar DiT (bf16, as JAX
    converts it), wav2vec2 and the VAE from ``dit/``, ``wav2vec2/`` and
    ``vae/``; wav2vec2 and a DiT forward against JAX's on the JAX
    converters' trees to 1e-4; a missing directory fails as the JAX loader
    fails."""
    rng = np.random.default_rng(20)
    root = str(tmp_path)
    jcfg, tcfg = _avatar_cfgs(False)
    tree = _random_tree(jax.eval_shape(
        lambda k: javt.init_avatar_dit(k, jcfg, dtype=jnp.float32),
        jax.random.key(0)), rng)
    os.makedirs(os.path.join(root, "dit"))
    _save(longcat_sd(tree, jcfg.base.depth, jcfg),
          os.path.join(root, "dit", "model.safetensors"), "float32")
    wcfg, wtree = _w2v_tree(rng)
    os.makedirs(os.path.join(root, "wav2vec2"))
    np_save_file(wav2vec2_sd(wtree, wcfg, "parametrizations"),
                 os.path.join(root, "wav2vec2", "model.safetensors"))
    _write_vae(root)
    _write_encoders(root, rng)
    pipe, enc_t, enc_a = tck.load_avatar_pipeline(
        root, device="cpu", dit_cfg=tcfg,
        vae_cfg=tvae.WanVAEConfig(**TINY_VAE),
        w2v_cfg=tw2v.Wav2Vec2Config.tiny(),
        umt5_cfg=tumt5.UMT5Config.tiny())
    jp = jclc.convert_avatar_dit(jload(os.path.join(root, "dit")), jcfg)
    _assert_same(pipe.dit_params, FJ.avatar_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    jw = jcw2v.convert_wav2vec2(jload(os.path.join(root, "wav2vec2")), wcfg)
    wav = rng.standard_normal((1, 1600)).astype(np.float32)
    wins = enc_a(torch.from_numpy(wav), 5)
    from worldforge_tpu.pipelines import avatar as jpavt
    jwins = jpavt.encode_audio_windows(jw, wcfg, jnp.asarray(wav), 5,
                                       window=jcfg.audio_window)
    assert _rel(wins, jwins) < TOL
    x = rng.standard_normal((1, 4, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    t = np.full((1, 3), 400.0, np.float32)
    audio = rng.standard_normal((1, 9, 5, 2, 8)).astype(np.float32)
    # the loader's tree is JAX's bit for bit (above); the forward runs on
    # the same checkpoint converted to fp32 on both sides, the fp32 policy
    # taking fp32 weights
    want = javt.avatar_dit_forward(
        jclc.convert_avatar_dit(jload(os.path.join(root, "dit")), jcfg,
                                jnp.float32),
        jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        jnp.asarray(audio), encoder_attention_mask=jnp.ones((1, 6),
                                                            jnp.int32),
        policy=J_FP32)
    got = tavt.avatar_dit_forward(
        tclc.convert_avatar_dit(tload(os.path.join(root, "dit")), tcfg,
                                torch.float32, "cpu"),
        tcfg, torch.from_numpy(x), torch.from_numpy(t),
        torch.from_numpy(ctx), torch.from_numpy(audio),
        encoder_attention_mask=torch.ones((1, 6), dtype=torch.int32),
        policy=T_FP32)
    assert _rel(got, want) < TOL
    with pytest.raises(FileNotFoundError):
        jcwan.load_state_dict(os.path.join(str(tmp_path / "nowhere"), "dit"))
    with pytest.raises(FileNotFoundError):
        tck.load_avatar_pipeline(str(tmp_path / "nowhere"), device="cpu")


def test_load_depthcrafter_from_files_matches_jax(tmp_path, monkeypatch):
    """``load_converted_depthcrafter`` on the manifests' UNet and VAE and a
    CLIP with its ``visual_projection``: one UNet forward and the CLIP
    frame embeds against JAX's on the JAX converters' trees to 1e-4; then
    ``estimate_depth(checkpoint=dir)`` (the configs patched to the tiny
    ones) returns depth in [0, 1] at the 64-multiple size."""
    rng = np.random.default_rng(21)
    root = str(tmp_path)
    for which in ("unet", "vae"):
        os.makedirs(os.path.join(root, which))
        _save(_manifest_sd(f"svd_{which}_manifest.json", 22),
              os.path.join(root, which, "model.safetensors"), "float32")
    ccfg, ctree = _clip_tree(rng)
    ucfg = junet.SVDUNetConfig.tiny()
    proj = {"proj": {"w": rng.standard_normal(
        (ccfg.width, ucfg.cross_attention_dim)).astype(np.float32) * 0.2}}
    os.makedirs(os.path.join(root, "image_encoder"))
    _save(clip_sd(ctree, ccfg, proj=proj),
          os.path.join(root, "image_encoder", "model.safetensors"),
          "float32")
    from worldforge_tpu_torch.models.depthcrafter import vae as tv
    pipe = tcdc.load_converted_depthcrafter(
        root, device="cpu", unet_cfg=tunet.SVDUNetConfig.tiny(),
        vae_cfg=tv.SVDVAEConfig.tiny(),
        clip_cfg=tclip.CLIPVisionConfig.tiny())
    ju = jcdc.convert_svd_unet(jload(os.path.join(root, "unet")), ucfg)
    x = rng.standard_normal((1, 3, 8, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((1, 3, 1, ucfg.cross_attention_dim)).astype(
        np.float32)
    ids = np.array([[7.0, 127.0, 0.02]], np.float32)
    want = jax.jit(lambda p, a, c, i: junet.svd_unet_forward(
        p, ucfg, a, 1.5, c, i))(ju, jnp.asarray(x), jnp.asarray(ctx),
                                jnp.asarray(ids))
    got = tunet.svd_unet_forward(pipe.unet_params, pipe.unet_cfg,
                                 torch.from_numpy(x), 1.5,
                                 torch.from_numpy(ctx), torch.from_numpy(ids))
    assert _rel(got, want) < TOL
    frames = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 40, 30)).astype(
        np.float32))
    jcp = jcenc.convert_clip_vision(
        jload(os.path.join(root, "image_encoder")), ccfg)
    px = np.concatenate([jclip.preprocess_clip(f, ccfg.image_size) for f in
                         ((frames.numpy() + 1) / 2).transpose(0, 2, 3, 1)])
    jemb = jclip.clip_vision_image_embeds(jcp, proj, ccfg, jnp.asarray(px))
    assert _rel(pipe.encode_frames_clip(frames), jemb) < TOL

    from worldforge_tpu_torch.models.depthcrafter import inference as tinf
    monkeypatch.setattr(tunet.SVDUNetConfig, "svd",
                        classmethod(lambda cls: cls.tiny()))
    monkeypatch.setattr(tv.SVDVAEConfig, "svd",
                        classmethod(lambda cls: cls.tiny()))
    monkeypatch.setattr(tclip.CLIPVisionConfig, "vit_h_14",
                        classmethod(lambda cls: cls.tiny()))
    depth = tinf.estimate_depth(
        rng.random((3, 60, 70, 3)).astype(np.float32), checkpoint=root,
        num_inference_steps=1, device="cpu")
    assert depth.shape == (3, 64, 64)
    assert float(depth.min()) == 0.0 and float(depth.max()) == 1.0
