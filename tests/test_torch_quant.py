"""The port's quantization (``ops/quant.py``, the quantized ``dense``, the
layerwise W8A8 / W4A8 / W6A8 builds) against the JAX package's, on the CPU.

The same seeded numpy arrays go through both modules. Codes, scales and
packed bytes must be equal; the int8 products agree to 1e-6 relative; a
tree quantized by JAX and carried over by ``io/from_jax.py`` equals the
port's quantization of the same fp32 tree leaf for leaf; the port's
layerwise builds equal ``quantize_tree`` of the plain init bit for bit; the
quantized forwards of the Wan, LongCat, avatar and UMT5 models match JAX
under the fp32 policy. Also the fp32-policy repair of ``dense`` (bf16
weights under fp32 activations promote, as JAX's ``x @ w``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldforge_tpu.core import params as JP
from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.models.encoders import umt5 as jumt5
from worldforge_tpu.models.longcat import avatar as javt
from worldforge_tpu.models.longcat import dit as jlc
from worldforge_tpu.models.wan import dit as jwan
from worldforge_tpu.ops import quant as jq
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io.from_jax import (avatar_params_from_jax,
                                              dit_params_from_jax,
                                              longcat_dit_params_from_jax,
                                              tensor_from_numpy,
                                              umt5_params_from_jax,
                                              vace_params_from_jax)
from worldforge_tpu_torch.models.encoders import umt5 as tumt5
from worldforge_tpu_torch.models.longcat import avatar as tavt
from worldforge_tpu_torch.models.longcat import dit as tlc
from worldforge_tpu_torch.models.wan import dit as twan
from worldforge_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

KEY = functools.partial(jax.random.key, impl="rbg")
# the int8 products and their rescale are the same arithmetic on both
# sides; the fp32 products around them sum in another order
TOL_DENSE = 1e-6


def _np(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.float().numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_trees_equal(got, want, path=""):
    """Same keys (JAX's tree maps sort them), list lengths, dtypes, shapes
    and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (
            path, list(got) if isinstance(got, dict) else got, list(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        assert torch.equal(got, want), path


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _nptree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ codes


WEIGHTS = {
    # name: (shape, dtype, int4 group, int6 group)
    "square": ((256, 64), np.float32, 128, 64),
    "stacked": ((3, 512, 24), np.float32, 128, 128),
    "fallback": ((20, 24), np.float32, 128, 128),   # no whole groups
    "bf16": ((256, 40), "bfloat16", 64, 32),
}


def _weight(name):
    shape, dtype, g4, g6 = WEIGHTS[name]
    w = np.random.default_rng(len(name)).standard_normal(shape)
    w = (0.05 * w).astype(np.float32)
    w[..., 0, 0] = 0.0                   # ties and a zero
    w[..., 1, :] = 0.0                   # an all-zero row
    if dtype == "bfloat16":
        w = np.asarray(jnp.asarray(w, jnp.bfloat16))
    return w, g4, g6


@pytest.mark.parametrize("name", list(WEIGHTS))
def test_codes_scales_and_bytes_equal(name):
    """int8 / int4 / int6 codes, scales and packed bytes, the unpacked
    codes, the dequantized weights and the requantized int8 weights: all
    exactly equal."""
    w, g4, g6 = _weight(name)
    tw = tensor_from_numpy(w)
    for jf, tf, kw in ((jq.quantize_weight, tq.quantize_weight, {}),
                       (jq.quantize_weight_int4, tq.quantize_weight_int4,
                        dict(group=g4)),
                       (jq.quantize_weight_int6, tq.quantize_weight_int6,
                        dict(group=g6))):
        jc, js = jf(jnp.asarray(w), **kw)
        tc, ts = tf(tw, **kw)
        assert str(tc.dtype).split(".")[-1] == str(jc.dtype), (tc.dtype,
                                                              jc.dtype)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if w.shape[-2] == 20:      # the fallback is one group per column
        assert tq.quantize_weight_int4(tw)[1].shape[-2] == 1
    p = {"w": w, "b": np.linspace(-1, 1, w.shape[-1], dtype=np.float32)}
    for jf, tf, unpack, deq, req in (
            (jq.quantize_dense_int4, tq.quantize_dense_int4, "_unpack_int4",
             "dequantize_int4", "_requantize_int4_to_int8"),
            (jq.quantize_dense_int6, tq.quantize_dense_int6, "_unpack_int6",
             "dequantize_int6", "_requantize_int6_to_int8")):
        g = g4 if "int4" in unpack else g6
        jd = jf(_jnp(p), group=g)
        td = tf({k: tensor_from_numpy(v) for k, v in p.items()}, group=g)
        _assert_trees_equal(td, {k: tensor_from_numpy(np.asarray(v))
                                 for k, v in jd.items()})
        packed = td["w4"] if "w4" in td else td["w6"]
        np.testing.assert_array_equal(
            getattr(tq, unpack)(packed).numpy(),
            np.asarray(getattr(jq, unpack)(jnp.asarray(packed.numpy()))))
        for fn in (deq, req):
            np.testing.assert_array_equal(
                _np(getattr(tq, fn)(td)), _np(getattr(jq, fn)(jd)))


# ------------------------------------------------------------ products


def _dense_pair(kind, k, n, bias, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    p = {"w": w}
    if bias:
        p["b"] = rng.standard_normal(n).astype(np.float32)
    quant = {"w8": jq.quantize_dense, "w4": functools.partial(
        jq.quantize_dense_int4, group=32), "w4_legacy": functools.partial(
        jq.quantize_dense_int4, group=32), "w6": functools.partial(
        jq.quantize_dense_int6, group=32)}[kind]
    jd = quant(_jnp(p))
    if kind == "w4_legacy":
        jd = {key: v for key, v in jd.items() if key != "scale8"}
    td = {key: tensor_from_numpy(np.asarray(v)) for key, v in jd.items()}
    return jd, td


@pytest.mark.parametrize("kind", ["w8", "w8_pre", "w4", "w4_legacy", "w6"])
@pytest.mark.parametrize("lead", [(1,), (3, 7), (2, 33)])
def test_quantized_products_match_jax(kind, lead):
    """``dense_q8`` / ``dense_q8_pre`` / ``dense_q4`` (with and without
    ``scale8``) / ``dense_q6`` and the ``dense`` dispatch on the same
    inputs: to 1e-6 relative; the int32 sums of the int8 product exactly
    equal to JAX's ``preferred_element_type=int32`` dot."""
    k, n = 128, 48
    jd, td = _dense_pair(kind.replace("_pre", ""), k, n, bias=lead != (1,),
                         seed=len(lead))
    x = np.random.default_rng(5).standard_normal(lead + (k,)).astype(
        np.float32)
    x[..., 3] = 0.0
    tx = torch.from_numpy(x)
    if kind == "w8_pre":
        jx8, jsx = jq.quantize_activations(jnp.asarray(x))
        tx8, tsx = tq.quantize_activations(tx)
        np.testing.assert_array_equal(tx8.numpy(), np.asarray(jx8))
        np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
        acc = jax.lax.dot_general(jx8, jd["w8"], (((x.ndim - 1,), (0,)),
                                                  ((), ())),
                                  preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(
            tq.int8_matmul(tx8, td["w8"]).numpy(), np.asarray(acc))
        want = jq.dense_q8_pre(jd, jx8, jsx)
        got = tq.dense_q8_pre(td, tx8, tsx)
    else:
        fn = {"w8": "dense_q8", "w4": "dense_q4", "w4_legacy": "dense_q4",
              "w6": "dense_q6"}[kind]
        want = getattr(jq, fn)(jd, jnp.asarray(x))
        got = getattr(tq, fn)(td, tx)
        assert got.dtype == torch.float32
        assert _rel(TP.dense(td, tx), JP.dense(jd, jnp.asarray(x))) \
            <= TOL_DENSE
        xb = tx.to(torch.bfloat16)
        got_b = TP.dense(td, xb, compute_dtype=torch.float32)
        want_b = JP.dense(jd, jnp.asarray(x, jnp.bfloat16),
                          compute_dtype=jnp.float32)
        assert got_b.dtype == torch.float32 and _rel(got_b, want_b) \
            <= TOL_DENSE
        assert TP.dense(td, xb).dtype == torch.bfloat16
    assert _rel(got, want) <= TOL_DENSE


def test_int8_matmul_shapes_that_the_card_pads():
    """The shapes the card's int8 product pads (rows <= 16, K or N not a
    multiple of 8) give the exact int32 sums here too."""
    rng = np.random.default_rng(0)
    for m, k, n in ((1, 64, 24), (16, 64, 24), (17, 12, 20), (5, 7, 3)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k), np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n), np.int8))
        np.testing.assert_array_equal(tq.int8_matmul(a, b).numpy(),
                                      a.numpy().astype(np.int64)
                                      @ b.numpy().astype(np.int64))
    with pytest.raises(ValueError):
        tq.quantize_weight_int4(torch.zeros(5, 4))
    with pytest.raises(ValueError):
        tq.quantize_weight_int6(torch.zeros(6, 4))


# ------------------------------------------------------------ trees


AVATAR_BASE = dict(in_channels=4, out_channels=4, hidden_size=64, depth=2,
                   num_heads=2, caption_channels=32, adaln_tembed_dim=32,
                   frequency_embedding_size=16)
AVATAR_AUDIO = dict(audio_blocks=2, audio_channels=8, intermediate_dim=16,
                    output_dim=8, context_tokens=4)


def _randomize_zero_leaves(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.size and not a.any():
            return (scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(f, tree)


@functools.lru_cache(maxsize=None)
def _jax_tree(model, dtype="float32"):
    """A tiny JAX init (fp32 unless asked) with its zero leaves randomised,
    as numpy, and its from_jax converter."""
    dt = getattr(jnp, dtype)
    if model == "wan":
        p = jwan.init_wan_dit(KEY(0), jwan.WanDiTConfig.tiny("i2v"), dt)
        conv = dit_params_from_jax
    elif model == "vace":
        from worldforge_tpu.models.wan import vace as jvace
        cfg = jvace.VaceConfig(base=jwan.WanDiTConfig.tiny("t2v"),
                               vace_layers=(0,), vace_in_dim=8)
        p = jvace.init_vace(KEY(4), cfg, dt)
        conv = vace_params_from_jax
    elif model == "longcat":
        p = jlc.init_longcat_dit(KEY(1), jlc.LongCatDiTConfig.tiny(), dt)
        conv = longcat_dit_params_from_jax
    elif model == "avatar":
        cfg = javt.AvatarConfig(base=jlc.LongCatDiTConfig(**AVATAR_BASE),
                                **AVATAR_AUDIO)
        p = javt.init_avatar_dit(KEY(2), cfg, dt)
        conv = avatar_params_from_jax
    else:
        p = jumt5.init_umt5(KEY(3), jumt5.UMT5Config.tiny(), dt)
        conv = umt5_params_from_jax
    return _randomize_zero_leaves(_nptree(p), 1), conv


def _umt5_pred(path):
    return path.split("/")[-1] in tumt5.UMT5_INT8_KEYS


RECIPES = {
    "w8": {},
    "ffn_int4": dict(int4_keys=("fc1", "fc2", "w1", "w2", "w3", "wi_0",
                                "wi_1", "wo"), int4_group=32),
    "all_int4": dict(int4_keys=("*",)),
    "int6_ffn_int4": dict(int6_keys=("fc1", "fc2", "w1", "w2", "w3"),
                          int4_keys=("*",), int6_group=32),
    "no_downcast": dict(downcast_adaln=False),
}


@pytest.mark.parametrize("recipe", list(RECIPES))
@pytest.mark.parametrize("model", ["wan", "vace", "longcat", "avatar",
                                   "umt5"])
def test_quantize_tree_matches_jax(model, recipe):
    """``quantize_tree`` picks the same leaves with the same formats (the
    int4 exclusions of the conditioning embeddings, the bf16 adaLN
    downcast, the head / time / final islands left alone), and the JAX
    tree carried over equals the port's quantization of the same fp32
    tree, bit for bit, layer by layer."""
    tree, conv = _jax_tree(model)
    kw = dict(RECIPES[recipe])
    if model == "umt5":
        kw["predicate"] = _umt5_pred
    got = tq.quantize_tree(conv(tree), **kw)
    want = conv(_nptree(jq.quantize_tree(_jnp(tree), **kw)))
    _assert_trees_equal(got, want)
    blk = got["blocks"][0]
    if model in ("longcat", "avatar"):
        assert blk["adaln"]["w"].dtype == (
            torch.float32 if recipe == "no_downcast" else torch.bfloat16)
        assert got["final"]["adaln"]["w"].dtype == torch.float32
        assert "w" in got["t_embedder"]["fc1"]
    if model in ("wan", "vace"):
        assert "w" in got["head"]["head"] and "w" in got["time_projection"]
    if model == "wan" and recipe == "all_int4":
        assert "w4" in blk["self_attn"]["q"]
        assert "w8" in got["text_embedding"]["fc1"]
        assert "w8" in got["img_emb"]["fc1"]
    if model == "avatar" and recipe == "all_int4":
        assert "w4" in blk["a_q"]
    if model == "umt5":
        assert all(tq.is_quantized(blk[k]) for k in tumt5.UMT5_INT8_KEYS)


def _layer_tree_equal(a, b):
    _assert_trees_equal(a, b)


@pytest.mark.parametrize("build", [
    "wan_int8", "wan_w4", "wan_int6_int4", "longcat_int8", "longcat_w4",
    "umt5_int8"])
def test_layerwise_builds_equal_quantize_tree(build):
    """Each layerwise build from a generator equals ``quantize_tree`` of the
    plain init from a generator with the same seed, bit for bit (the
    layerwise draws run in the plain init's order)."""
    gen = lambda: torch.Generator().manual_seed(3)
    wcfg, lcfg = twan.WanDiTConfig.tiny("i2v"), tlc.LongCatDiTConfig.tiny()
    ucfg = tumt5.UMT5Config.tiny()
    got, want = {
        "wan_int8": lambda: (twan.init_wan_dit_int8(gen(), wcfg),
                             tq.quantize_tree(twan.init_wan_dit(gen(), wcfg))),
        "wan_w4": lambda: (twan.init_wan_dit_w4(gen(), wcfg, int4_group=32),
                           tq.quantize_tree(twan.init_wan_dit(gen(), wcfg),
                                            int4_keys=("fc1", "fc2"),
                                            int4_group=32)),
        "wan_int6_int4": lambda: (
            twan.init_wan_dit_w4(gen(), wcfg, int4_keys=("*",),
                                 int6_keys=("fc1", "fc2")),
            tq.quantize_tree(twan.init_wan_dit(gen(), wcfg),
                             int4_keys=("*",), int6_keys=("fc1", "fc2"))),
        "longcat_int8": lambda: (
            tlc.init_longcat_dit_int8(gen(), lcfg),
            tq.quantize_tree(tlc.init_longcat_dit(gen(), lcfg))),
        "longcat_w4": lambda: (
            tlc.init_longcat_dit_w4(gen(), lcfg),
            tq.quantize_tree(tlc.init_longcat_dit(gen(), lcfg),
                             int4_keys=("*",))),
        "umt5_int8": lambda: (
            tumt5.init_umt5_int8(gen(), ucfg),
            dict(tq.quantize_tree(tumt5.init_umt5(gen(), ucfg),
                                  predicate=_umt5_pred))),
    }[build]()
    _assert_trees_equal(got, want)
    if build == "umt5_int8":
        assert got["embed"].dtype == torch.bfloat16
    if build.startswith("wan"):
        assert (tq.is_quantized(got["blocks"][1]["ffn"]["fc1"])
                and "w" in got["patch_embedding"])


def test_layerwise_without_transform_is_the_plain_init():
    gen = lambda: torch.Generator().manual_seed(5)
    _assert_trees_equal(
        twan.init_wan_dit_layerwise(gen(), twan.WanDiTConfig.tiny("t2v")),
        twan.init_wan_dit(gen(), twan.WanDiTConfig.tiny("t2v")))
    _assert_trees_equal(
        tlc.init_longcat_dit_layerwise(gen(), tlc.LongCatDiTConfig.tiny()),
        tlc.init_longcat_dit(gen(), tlc.LongCatDiTConfig.tiny()))


# ------------------------------------------------------------ forwards

# Measured on this CPU: the quantized forwards below agree with JAX to
# 2.1e-7 - 1.5e-6 relative (the Wan block 2.2e-7, the Wan DiT 3.3e-7 -
# 3.9e-7, LongCat 2.1e-7 / 2.4e-7 and 1.5e-6 with bf16 weights, the avatar
# 3.4e-7, UMT5 2.5e-7 / 6.1e-7), and no activation code flipped (the Wan
# block's recorded): only the fp32 sums around the int8 products differ.
TOL_FORWARD = 1e-5


def _wan_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    return dict(
        x=f32(rng.standard_normal((1, cfg.out_dim, 3, 8, 8))),
        y=f32(rng.standard_normal((1, cfg.in_dim - cfg.out_dim, 3, 8, 8))),
        t=np.array([700.0], np.float32),
        ctx=f32(rng.standard_normal((1, cfg.text_len, cfg.text_dim))),
        clip=f32(rng.standard_normal((1, 257, cfg.clip_dim))))


def _quantized_pair(model, recipe):
    tree, conv = _jax_tree(model)
    jt = jq.quantize_tree(_jnp(tree), **RECIPES[recipe])
    return jt, conv(_nptree(jt))


def test_quantized_wan_layer_fast_path_matches_jax(monkeypatch):
    """One W8A8 Wan block (q / k / v on one activation quantization): the
    block's output within the forward tolerance, and the activation codes
    of that quantization, recorded on both sides, equal (none flipped)."""
    jt, tt = _quantized_pair("wan", "w8")
    jcfg, tcfg = jwan.WanDiTConfig.tiny("i2v"), twan.WanDiTConfig.tiny("i2v")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 64, jcfg.dim)).astype(np.float32)
    e0 = (0.1 * rng.standard_normal((1, 6, jcfg.dim))).astype(np.float32)
    ctx = rng.standard_normal((1, 24, jcfg.dim)).astype(np.float32)
    from worldforge_tpu.ops import rope as jrope
    from worldforge_tpu_torch.ops import rope as trope
    codes = {}
    for mod, side in ((jq, "jax"), (twan, "torch")):
        def record(a, _orig=mod.quantize_activations, _side=side):
            out = _orig(a)
            codes.setdefault(_side, np.asarray(out[0]))
            return out
        monkeypatch.setattr(mod, "quantize_activations", record)
    jc, js = jrope.rope_cos_sin(4, 4, 4, jcfg.head_dim)
    tc, ts = trope.rope_cos_sin(4, 4, 4, tcfg.head_dim)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jt["blocks"])
    want = jwan.wan_dit_layer_forward(
        jlayer, jcfg, jnp.asarray(x), jnp.asarray(e0), jnp.asarray(ctx),
        jc, js, img_ctx_len=8, policy=J_FP32)
    got = twan.wan_dit_layer_forward(
        tt["blocks"][0], tcfg, torch.from_numpy(x), torch.from_numpy(e0),
        torch.from_numpy(ctx), tc, ts, img_ctx_len=8, policy=T_FP32)
    assert _rel(got, want) < TOL_FORWARD
    assert codes["torch"].shape == codes["jax"].shape == (1, 64, jcfg.dim)
    assert int((codes["torch"] != codes["jax"]).sum()) == 0


@pytest.mark.parametrize("recipe", ["w8", "ffn_int4", "int6_ffn_int4"])
def test_quantized_wan_dit_matches_jax(recipe):
    jt, tt = _quantized_pair("wan", recipe)
    jcfg, tcfg = jwan.WanDiTConfig.tiny("i2v"), twan.WanDiTConfig.tiny("i2v")
    i = _wan_inputs(jcfg)
    want = jwan.wan_dit_forward(
        jt, jcfg, jnp.asarray(i["x"]), jnp.asarray(i["t"]),
        jnp.asarray(i["ctx"]), clip_fea=jnp.asarray(i["clip"]),
        y=jnp.asarray(i["y"]), policy=J_FP32)
    got = twan.wan_dit_forward(
        tt, tcfg, torch.from_numpy(i["x"]), torch.from_numpy(i["t"]),
        torch.from_numpy(i["ctx"]), clip_fea=torch.from_numpy(i["clip"]),
        y=torch.from_numpy(i["y"]), policy=T_FP32)
    assert _rel(got, want) < TOL_FORWARD


def _longcat_inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    mask = np.zeros((1, 8), np.int32)
    mask[:, :5] = 1
    return dict(
        x=rng.standard_normal((1, cfg.in_channels, 3, 8, 8)).astype(
            np.float32),
        t=np.array([[0.0, 600.0, 600.0]], np.float32),
        ctx=rng.standard_normal((1, 8, cfg.caption_channels)).astype(
            np.float32), mask=mask)


@pytest.mark.parametrize("recipe", ["w8", "all_int4", "bf16_adaln"])
def test_quantized_longcat_matches_jax(recipe):
    """LongCat W8A8 and all-int4 under the fp32 policy (the adaLN weights
    in bf16 take ``dense``'s hi / lo split); and the bf16 tree with bf16
    adaLN weights (``quantize_tree`` with no leaf matched), whose fp32
    activations met bf16 weights in ``dense`` before its repair."""
    if recipe == "bf16_adaln":
        tree, conv = _jax_tree("longcat", "bfloat16")
        jt = jq.quantize_tree(_jnp(tree), predicate=lambda p: False)
        tt = conv(_nptree(jt))
        assert tt["blocks"][0]["adaln"]["w"].dtype == torch.bfloat16
        assert tt["blocks"][0]["qkv"]["w"].dtype == torch.bfloat16
    else:
        jt, tt = _quantized_pair("longcat", recipe)
    jcfg, tcfg = jlc.LongCatDiTConfig.tiny(), tlc.LongCatDiTConfig.tiny()
    i = _longcat_inputs(jcfg)
    want = jlc.longcat_dit_forward(
        jt, jcfg, jnp.asarray(i["x"]), jnp.asarray(i["t"]),
        jnp.asarray(i["ctx"]), encoder_attention_mask=jnp.asarray(i["mask"]),
        num_cond_latents=1, policy=J_FP32)
    got = tlc.longcat_dit_forward(
        tt, tcfg, torch.from_numpy(i["x"]), torch.from_numpy(i["t"]),
        torch.from_numpy(i["ctx"]),
        encoder_attention_mask=torch.from_numpy(i["mask"]),
        num_cond_latents=1, policy=T_FP32)
    assert _rel(got, want) < TOL_FORWARD


def test_quantized_avatar_matches_jax():
    jt, tt = _quantized_pair("avatar", "w8")
    jcfg = javt.AvatarConfig(base=jlc.LongCatDiTConfig(**AVATAR_BASE),
                             **AVATAR_AUDIO)
    tcfg = tavt.AvatarConfig(base=tlc.LongCatDiTConfig(**AVATAR_BASE),
                             **AVATAR_AUDIO)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 6, 32)).astype(np.float32)
    audio = rng.standard_normal((1, 9, 5, 2, 8)).astype(np.float32)
    t = np.array([[0.0, 600.0, 600.0]], np.float32)
    want = javt.avatar_dit_forward(
        jt, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        jnp.asarray(audio), num_cond_latents=1, policy=J_FP32)
    got = tavt.avatar_dit_forward(
        tt, tcfg, torch.from_numpy(x), torch.from_numpy(t),
        torch.from_numpy(ctx), torch.from_numpy(audio), num_cond_latents=1,
        policy=T_FP32)
    assert _rel(got, want) < TOL_FORWARD


@pytest.mark.parametrize("what", ["int8", "bf16_fp32_compute"])
def test_umt5_matches_jax(what):
    """UMT5 int8 (``init_umt5_int8``'s predicate) with fp32 compute, and the
    bf16 encoder with ``compute_dtype=float32``, which raised a dtype
    mismatch in ``dense`` before its repair."""
    if what == "int8":
        tree, conv = _jax_tree("umt5")
        jt = jq.quantize_tree(_jnp(tree), predicate=_umt5_pred)
    else:
        tree, conv = _jax_tree("umt5", "bfloat16")
        jt = _jnp(tree)
    tt = conv(_nptree(jt))
    cfg = jumt5.UMT5Config.tiny()
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, (2, 12))
    mask = (np.arange(12)[None] < np.array([[12], [7]])).astype(np.int32)
    want = jumt5.umt5_encode(jt, cfg, jnp.asarray(ids), jnp.asarray(mask),
                             compute_dtype=jnp.float32)
    got = tumt5.umt5_encode(tt, tumt5.UMT5Config.tiny(),
                            torch.from_numpy(ids), torch.from_numpy(mask),
                            compute_dtype=torch.float32)
    assert _rel(got, want) < TOL_FORWARD
    assert not got[1, 7:].any()


# ------------------------------------------------------------ dense repair


@pytest.mark.parametrize("xdt,wdt", [("float32", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_dense_promotes_mixed_dtypes_like_jax(xdt, wdt):
    """No compute dtype and x, w of two dtypes: the product in the promoted
    dtype (fp32 here), as JAX's ``x @ w``; to 1e-6 relative."""
    rng = np.random.default_rng(7)
    x = np.asarray(jnp.asarray(rng.standard_normal((5, 64)), xdt))
    w = np.asarray(jnp.asarray(0.1 * rng.standard_normal((64, 24)), wdt))
    b = np.asarray(jnp.asarray(rng.standard_normal(24), wdt))
    want = JP.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                    jnp.asarray(x))
    got = TP.dense({"w": tensor_from_numpy(w), "b": tensor_from_numpy(b)},
                   tensor_from_numpy(x))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert _rel(got, want) <= TOL_DENSE


# ------------------------------------------------------------ generate

# The quantized generate sits on a noise floor of its own: the activation
# codes flip on last-bit fp32 differences (the VAE encode, the attention
# sums), and 8 guided steps amplify the flips. Measured on this CPU: the
# port's W4A8 latents move 7.2e-3 (rel max) when the input image moves by
# 1e-7 relative, where the fp32 generate's move 1.1e-6; against JAX they
# differ by 8.9e-3 (7.9e-3 rel L2). The bound is the card-vs-CPU bound of
# chip_smoke.py's small generate.
TOL_W4A8_GENERATE = 2e-2


def _w4a8_generate_setup(monkeypatch):
    """The tiny guided Wan generate with FLF (8 steps, CFG, IRR, the fuse,
    DSG; fp32 convs) on a W4A8 tree (FFN int4 in groups of 32, W8A8
    elsewhere) quantized on each side from one fp32 tree. Returns
    (run_jax, run_torch, sel): ``run_jax()`` and ``run_torch(tree)``
    generate the latents, ``tree`` "w4a8" or "fp32"; ``sel`` collects the
    channel sets FLF hands back, by side."""
    from tests.test_torch_pipeline import (DIT_KW, GUIDE, _inputs, _noise,
                                           _to_jax, fp32_conv3d)
    from worldforge_tpu.models.wan import vae as jvae
    from worldforge_tpu.pipelines import wan_i2v as jwan_i2v
    from worldforge_tpu.sampling.guidance import GuidanceConfig as JGuide
    from worldforge_tpu_torch.models.wan import vae as tvae
    from worldforge_tpu_torch.pipelines.wan_i2v import WanI2VPipeline
    from worldforge_tpu_torch.sampling import guidance as tguidance
    from worldforge_tpu_torch.sampling.guidance import GuidanceConfig

    tdp = twan.init_wan_dit(torch.Generator().manual_seed(0),
                            twan.WanDiTConfig(**DIT_KW), dtype=torch.float32)
    head = tdp["head"]["head"]
    head["w"] = 0.02 * torch.randn(head["w"].shape,
                                   generator=torch.Generator().manual_seed(9))
    tvp = tvae.init_wan_vae(torch.Generator().manual_seed(1),
                            tvae.WanVAEConfig.tiny())
    jdp = {k: _to_jax(v) for k, v in tdp.items() if k != "blocks"}
    jdp["blocks"] = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[_to_jax(b) for b in tdp["blocks"]])
    w4 = dict(int4_keys=("fc1", "fc2"), int4_group=32)
    trees = {"w4a8": tq.quantize_tree(tdp, **w4), "fp32": tdp}
    assert "w4" in trees["w4a8"]["blocks"][0]["ffn"]["fc1"]
    jpipe = jwan_i2v.WanI2VPipeline(
        dit_params=jq.quantize_tree(jdp, **w4),
        dit_cfg=jwan.WanDiTConfig(**DIT_KW), vae_params=_to_jax(tvp),
        vae_cfg=jvae.WanVAEConfig.tiny(), policy=J_FP32)

    monkeypatch.setattr(jvae, "_CONV3D_MODE", "3d")
    monkeypatch.setattr(tvae, "conv3d_causal", fp32_conv3d)
    sel = {"jax": []}
    side = ["torch"]
    for mod, name in ((jwan_i2v, "jax"), (tguidance, None)):
        def wrapped(pred, ref, step, cfg, _orig=mod.flf_select, _s=name):
            out = _orig(pred, ref, step, cfg)
            sel[_s or side[0]].append((step, list(out)))
            return out
        monkeypatch.setattr(mod, "flf_select", wrapped)
    x = _inputs(frames=9, hw=64)
    g = dict(GUIDE, guide_steps=8, resample_round=8, use_flf=True)
    kw = dict(height=64, width=64, num_frames=9, num_inference_steps=8,
              guidance_scale=4.0, output_type="latent")

    def run_jax():
        return np.asarray(jpipe.generate(
            jax.random.key(0), jnp.asarray(x["image"]), jnp.asarray(x["pe"]),
            jnp.asarray(x["ne"]), jnp.asarray(x["ie"]),
            video_ref=jnp.asarray(x["ref"]), mask=jnp.asarray(x["mask"]),
            guidance=JGuide(**g), noise_fn=_noise(11), **kw))

    def run_torch(tree, label=None):
        side[0] = label or tree
        sel.setdefault(side[0], [])
        pipe = WanI2VPipeline(
            dit_params=trees[tree], dit_cfg=twan.WanDiTConfig(**DIT_KW),
            vae_params=tvp, vae_cfg=tvae.WanVAEConfig.tiny(), policy=T_FP32)
        return pipe.generate(
            None, x["image"], x["pe"], x["ne"], x["ie"],
            video_ref=x["ref"], mask=x["mask"], guidance=GuidanceConfig(**g),
            noise_fn=_noise(11), **kw).numpy()

    return run_jax, run_torch, sel


@pytest.fixture(scope="module")
def w4a8_runs():
    """The W4A8 guided generates both tests below hold, each computed once
    for the module: JAX's (its activation codes recorded call by call
    through an ordered ``io_callback`` inside its jitted DiT step), the
    port's on the W4A8 tree (its codes recorded), on the fp32 tree, and on
    the W4A8 tree fed JAX's codes and scales in place of its own
    quantization; with the channel sets FLF handed back on each run."""
    from jax.experimental import io_callback

    from worldforge_tpu_torch.models.wan import dit as tdit_mod

    with pytest.MonkeyPatch.context() as mp:
        run_jax, run_torch, sel = _w4a8_generate_setup(mp)
        jcodes = []
        jquant = jq.quantize_activations

        def jrecord(x):
            x8, sx = jquant(x)
            io_callback(lambda a, b: jcodes.append((np.asarray(a),
                                                    np.asarray(b))),
                        None, x8, sx, ordered=True)
            return x8, sx

        mp.setattr(jq, "quantize_activations", jrecord)
        want = run_jax()

        tquant = tq.quantize_activations
        tcodes = []

        def trecord(x):
            x8, sx = tquant(x)
            tcodes.append((x8.numpy().copy(), sx.numpy().copy()))
            return x8, sx

        for mod in (tq, tdit_mod):
            mp.setattr(mod, "quantize_activations", trecord)
        got = run_torch("w4a8", "torch")
        for mod in (tq, tdit_mod):
            mp.setattr(mod, "quantize_activations", tquant)
        fp32 = run_torch("fp32")

        fed = iter(jcodes)
        fed_shapes_ok = []

        def tfeed(x):
            x8, sx = next(fed)
            fed_shapes_ok.append(x8.shape == tuple(x.shape))
            return torch.from_numpy(x8.copy()), torch.from_numpy(sx.copy())

        for mod in (tq, tdit_mod):
            mp.setattr(mod, "quantize_activations", tfeed)
        same = run_torch("w4a8", "fed")
        left = next(fed, None)
    return dict(want=want, got=got, fp32=fp32, same=same, sel=sel,
                jcodes=jcodes, tcodes=tcodes, fed_all=left is None,
                fed_shapes_ok=all(fed_shapes_ok))


def test_w4a8_guided_generate_with_flf_matches_jax(w4a8_runs):
    """The tiny guided Wan generate with FLF (8 steps, CFG, IRR, the fuse,
    DSG; fp32 convs) on a W4A8 tree (FFN int4 in groups of 32, W8A8
    elsewhere) quantized on each side from one fp32 tree: the channel sets
    FLF hands back equal at every step, the latents within
    ``TOL_W4A8_GENERATE`` of JAX's, and the port's drift from its own fp32
    generate within the JAX quality test's 0.04
    (``tests/test_int4_quality.py``)."""
    r = w4a8_runs
    want, got, fp32, sel = r["want"], r["got"], r["fp32"], r["sel"]
    assert got.shape == want.shape == (1, 4, 3, 8, 8)
    assert _rel(got, want) < TOL_W4A8_GENERATE
    assert sel["torch"] == sel["jax"] == sel["fp32"]
    assert [s for s, _ in sel["torch"]] == list(range(8))
    assert any(c for _, c in sel["torch"])
    drift = _rel(got, fp32)
    assert 0.0 < drift < 0.04, drift


# Where the W4A8 generate's gap comes from. Both sides' activation codes
# are recorded call by call (the JAX side through an ordered io_callback
# inside its jitted DiT step; 96 quantizations a step, 3,078,144 codes);
# the port's codes that differ from JAX's are counted step by step; then
# the port runs again fed JAX's codes and scales in place of its own
# quantization. Measured on this CPU: no code differs at step 0 (4,932
# per-token scales differ in their last bits), then 3,710 / 12,366 /
# 16,569 / 18,144 / 22,281 / 25,769 / 35,805 codes at steps 1-7, by up to
# 5 codes once the latents have drifted; fed JAX's codes the latents sit
# 1.3e-6 (rel max; 9.9e-7 rel L2) from JAX's, the level of the unguided
# quantized forwards (1.5e-6 measured, held to TOL_FORWARD), with the FLF
# sets equal. So the 8.9e-3 gap is the flipped codes, not a port fault.


def test_w4a8_generate_gap_is_flipped_activation_codes(w4a8_runs):
    """ROADMAP Queue C item 3: the W4A8 generate's gap to JAX is activation
    codes that flip on last-bit fp32 differences. No code differs at the
    first step (its inputs are equal), some do at later steps, and fed
    JAX's codes and scales the port's generate comes within the unguided
    quantized forwards' gate ``TOL_FORWARD`` of JAX's."""
    r = w4a8_runs
    want, got, same = r["want"], r["got"], r["same"]
    jcodes, tcodes = r["jcodes"], r["tcodes"]
    assert len(tcodes) == len(jcodes) and len(jcodes) % 8 == 0
    per_step = len(jcodes) // 8
    flips = [0] * 8
    for i, ((a, _), (b, _)) in enumerate(zip(tcodes, jcodes)):
        assert a.shape == b.shape
        flips[i // per_step] += int((a != b).sum())
    assert flips[0] == 0 and sum(flips) > 0, flips
    assert _rel(got, want) < TOL_W4A8_GENERATE

    assert r["fed_shapes_ok"] and r["fed_all"]
    assert r["sel"]["fed"] == r["sel"]["jax"]
    assert _rel(same, want) < TOL_FORWARD, (_rel(same, want), flips)
