"""The port stands alone: no module of ``worldforge_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points run
on the card unless the caller asks for the CPU."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "worldforge_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]


def test_isolation_covers_the_port_modules():
    """The JAX-import check walks every module of the package, the FLF,
    LongCat guided, warp, encoder, DepthCrafter, Wan facade, avatar,
    checkpoint, quantization, LoRA, training and runtime modules among
    them."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for rel in ("ops/farneback.py", "ops/flow.py",
                "sampling/channel_select.py", "sampling/guidance.py",
                "sampling/engine.py", "pipelines/longcat.py",
                "models/longcat/dit.py", "cli/run_longcat.py",
                "warp/geometry.py", "warp/cameras.py", "warp/splat.py",
                "warp/cracks.py", "warp/vggt_warp.py",
                "models/vggt/utils.py", "models/vggt/vit.py",
                "models/vggt/model.py", "models/vggt/heads.py",
                "models/vggt/inference.py", "cli/run_warp.py",
                "models/encoders/umt5.py", "models/encoders/clip_vision.py",
                "io/from_jax.py", "ops/sampling.py",
                "sampling/euler_edm.py", "models/depthcrafter/unet.py",
                "models/depthcrafter/vae.py",
                "models/depthcrafter/inference.py",
                "pipelines/depthcrafter.py", "warp/edge_filter.py",
                "warp/dc_warp.py", "warp/pcd.py",
                "cli/warp_depthcrafter.py", "sampling/dpm.py",
                "pipelines/wan_t2v.py", "models/wan/vace.py",
                "pipelines/wan_vace.py", "io/vace_processor.py",
                "models/encoders/wav2vec2.py", "models/longcat/avatar.py",
                "pipelines/avatar.py", "io/checkpoints.py",
                "cli/run_avatar.py", "io/torch_load.py",
                "io/convert_wan.py", "io/convert_encoders.py",
                "io/convert_longcat.py", "io/convert_wav2vec2.py",
                "io/convert_vggt.py", "io/convert_depthcrafter.py",
                "ops/quant.py", "training/lora.py", "training/__init__.py",
                "training/step.py", "runtime/__init__.py",
                "runtime/step_graph.py", "runtime/layouts.py",
                "runtime/streaming.py", "runtime/subproc.py",
                "core/consts.py"):
        assert f"worldforge_tpu_torch/{rel}" in names, rel


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "flax", "worldforge_tpu"}, roots


def test_no_safetensors_and_no_module_level_transformers():
    """The port reads safetensors itself: no module imports
    ``safetensors``; ``transformers`` (the UMT5 tokenizer) is imported only
    inside the call that first encodes a prompt."""
    for path in PORT_FILES:
        assert "safetensors" not in set(_imported_roots(path)), path
        tree = ast.parse(path.read_text(), filename=str(path))
        top = {n.split(".")[0] for node in tree.body
               if isinstance(node, (ast.Import, ast.ImportFrom))
               for n in ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])}
        assert "transformers" not in top, path


def test_checkpoint_layer_imports_and_loads_without_them(tmp_path):
    """In a fresh interpreter: importing every checkpoint module, reading a
    safetensors file and assembling a UMT5 text encoder from one (the
    loaders' path) import neither ``safetensors`` nor ``transformers``."""
    import subprocess
    import sys
    from safetensors.torch import save_file
    from worldforge_tpu_torch.models.encoders.umt5 import (UMT5Config,
                                                           init_umt5)
    cfg = UMT5Config.tiny()
    p = init_umt5(torch.Generator().manual_seed(0), cfg)
    sd = {"shared.weight": p["embed"],
          "encoder.final_layer_norm.weight": p["ln_f"]["scale"]}
    for i, blk in enumerate(p["blocks"]):
        b = f"encoder.block.{i}.layer"
        sd[f"{b}.0.layer_norm.weight"] = blk["ln1"]["scale"]
        for k in "qkvo":
            sd[f"{b}.0.SelfAttention.{k}.weight"] = blk[k]["w"].t()
        sd[f"{b}.0.SelfAttention.relative_attention_bias.weight"] = \
            blk["rel_bias"]
        sd[f"{b}.1.layer_norm.weight"] = blk["ln2"]["scale"]
        for k in ("wi_0", "wi_1", "wo"):
            sd[f"{b}.1.DenseReluDense.{k}.weight"] = blk[k]["w"].t()
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(tmp_path / "umt5.safetensors"))
    code = (
        "import sys, torch\n"
        "import worldforge_tpu_torch.io.checkpoints\n"
        "from worldforge_tpu_torch.io import (convert_depthcrafter, "
        "convert_encoders, convert_longcat, convert_vggt, convert_wan, "
        "convert_wav2vec2, torch_load)\n"
        "from worldforge_tpu_torch.models.encoders.umt5 import UMT5Config\n"
        f"enc = convert_encoders.load_umt5_encoder({str(tmp_path)!r}, "
        "'no-tokenizer', cfg=UMT5Config.tiny(), device='cpu')\n"
        "out = enc.encode_ids(torch.zeros((1, 4), dtype=torch.long), "
        "torch.ones((1, 4), dtype=torch.int32))\n"
        "assert out.shape == (1, 4, 32), out.shape\n"
        "bad = {'safetensors', 'transformers'} & set(sys.modules)\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_port_has_kernels_and_plain_versions():
    from worldforge_tpu_torch.ops import (conv3d, flash_attention,
                                          fused_norm, rope)
    for wrapper, plain in (
            (flash_attention.flash_attention,
             flash_attention.flash_attention_plain),
            (rope.apply_rope_qk, rope.apply_rope_qk_plain),
            (fused_norm.modulated_layer_norm,
             fused_norm.modulated_layer_norm_ref),
            (conv3d.conv3d_causal, conv3d.conv3d_causal_plain),
            (conv3d.conv2d_3x3, conv3d.conv2d_3x3_plain)):
        assert isinstance(wrapper.launches, int) and callable(plain)
    csrc = ROOT / "worldforge_tpu_torch" / "csrc"
    assert (csrc / "flash_attention.cu").exists()
    assert (csrc / "conv3d.cu").exists()


def test_default_device_is_the_card(monkeypatch):
    from worldforge_tpu_torch.core.dtypes import resolve_device
    from worldforge_tpu_torch.io.checkpoints import load_wan_pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_wan_pipeline()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_launch_counters_stay_zero():
    """CPU tensors take the plain versions; the counters count kernel
    launches only."""
    from worldforge_tpu_torch.ops import fused_norm
    before = fused_norm.modulated_layer_norm.launches
    fused_norm.modulated_layer_norm(torch.zeros(1, 2, 8), torch.zeros(1, 1, 8),
                                    torch.zeros(1, 1, 8))
    assert fused_norm.modulated_layer_norm.launches == before


def test_cpu_calls_leave_the_by_shape_counters_alone():
    """Kernels 1 and 4 also count their launches by instantiation and by
    shape; a CPU call launches nothing and adds to none of them."""
    from worldforge_tpu_torch.ops import conv3d, flash_attention as fa
    counters = (fa.flash_attention, conv3d.conv2d_3x3)
    before = [(fn.launches, dict(fn.launches_by_shape)) for fn in counters]
    by_inst = dict(fa.flash_attention.launches_by_instantiation)
    q = torch.zeros(1, 3, 1, 64)
    fa.flash_attention(q, q, q)
    conv3d.conv2d_3x3(torch.zeros(2, 4, 5, 3), torch.zeros(3, 3, 3, 8))
    assert [(fn.launches, fn.launches_by_shape) for fn in counters] == before
    assert fa.flash_attention.launches_by_instantiation == by_inst


def test_random_init_pipeline_on_cpu():
    from worldforge_tpu_torch.io.checkpoints import load_wan_pipeline
    pipe, enc_t, enc_i = load_wan_pipeline(random_init=True, device="cpu")
    assert pipe.device == torch.device("cpu")
    assert enc_t("a prompt").shape == (1, 512, 4096)
    torch.testing.assert_close(enc_t("a prompt"), enc_t("a prompt"))
    import numpy as np
    assert enc_i(np.zeros((4, 4, 3), np.uint8)).shape == (1, 257, 1280)
    assert pipe.dit_params["head"]["head"]["w"].abs().sum() > 0
    # a models directory takes the converted branch; a missing one fails
    # as the JAX loader's does (its reader cannot open <dir>/transformer)
    with pytest.raises(FileNotFoundError):
        load_wan_pipeline("/nonexistent", device="cpu")


def test_builders_put_leaves_on_the_generators_device(monkeypatch):
    """The quantized builders make every leaf on ``gen.device``: the card
    for a card generator, the CPU only for a CPU one. A stand-in generator
    on the meta device (``P.uniform`` / ``P.normal`` replaced for the call)
    shows that no leaf falls back to the CPU."""
    from worldforge_tpu_torch.core import params as P
    from worldforge_tpu_torch.models.encoders import umt5
    from worldforge_tpu_torch.models.longcat import dit as ldit
    from worldforge_tpu_torch.models.wan import dit as wdit
    builds = (
        lambda g: wdit.init_wan_dit_int8(g, wdit.WanDiTConfig.tiny("i2v")),
        lambda g: wdit.init_wan_dit_w4(g, wdit.WanDiTConfig.tiny("i2v"),
                                       int6_keys=("fc1",)),
        lambda g: ldit.init_longcat_dit_w4(g, ldit.LongCatDiTConfig.tiny()),
        lambda g: ldit.init_longcat_dit_int8(g, ldit.LongCatDiTConfig.tiny()),
        lambda g: umt5.init_umt5_int8(g, umt5.UMT5Config.tiny()))

    def devices(tree):
        out = set()
        P.tree_map(lambda t: out.add(t.device.type), tree)
        return out

    for build in builds:
        assert devices(build(torch.Generator().manual_seed(0))) == {"cpu"}

    class MetaGen:
        device = torch.device("meta")

    monkeypatch.setattr(P, "uniform", lambda gen, shape, limit: torch.empty(
        shape, device=gen.device))
    monkeypatch.setattr(P, "normal", lambda gen, shape, std=1.0: torch.empty(
        shape, device=gen.device))
    for build in builds:
        assert devices(build(MetaGen())) == {"meta"}
