"""The port's training (``training/step.py``, ``make_lora_train_step``) and
the gradients of its kernels' functions against the JAX package, on the CPU.

The JAX side runs ``jax.value_and_grad`` under its CPU dispatch, as
``tests/test_training.py`` runs it: attention through ``sdpa_reference``,
RoPE through ``apply_rope``, the adaLN prologue through the plain layer
norm, ``bsa_sparse`` through ``_bsa_reference`` and its gathered-form
backward. The port takes its kernels' plain versions on CPU tensors, and
autograd differentiates them (``bsa_sparse`` recomputes the gathered form).
Inputs, sigma and the noise come from numpy seeds and go to both sides; the
JAX inits' all-zero leaves (the Wan head, biases, ...) are randomised on
both sides first, since a zero there blocks or hides gradients and Adam
turns sub-ulp differences into +-lr steps.

Gates (fp32 under ``FP32_POLICY``): a gradient sums more terms than a
forward, so the gates are one order looser than the 1e-4 forward gate:
ops' gradients 1e-5 relative L2 (fp32 sums in another order), losses
1e-5 relative, DiT gradients and parameters after 3 AdamW steps 1e-4
relative L2 per leaf. A DiT gradient leaf is held to 1e-4 of its own norm
plus 1e-7 of the whole gradient's (``FLOOR_DIT_GRAD``): some leaves' true
gradients are residues of sums that nearly cancel (the cross-attention
key bias before its RMS norm: 7e-5 against a whole gradient of 1.7), and
their error is the fp32 rounding of those sums, not of the residue.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from worldforge_tpu.core.dtypes import FP32_POLICY as J_FP32
from worldforge_tpu.models.longcat import dit as jlc
from worldforge_tpu.models.wan import dit as jwan
from worldforge_tpu.ops.attention import attention as jattention
from worldforge_tpu.ops import bsa as jbsa
from worldforge_tpu.ops import fused_norm as jnorm
from worldforge_tpu.ops import rope as jrope
from worldforge_tpu.training import lora as jlora
from worldforge_tpu.training import step as jstep
from worldforge_tpu_torch.core import params as TP
from worldforge_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from worldforge_tpu_torch.io.convert_longcat import (convert_longcat_lora,
                                                     merge_lora_stacked)
from worldforge_tpu_torch.io.from_jax import (dit_params_from_jax,
                                              longcat_dit_params_from_jax,
                                              lora_from_jax,
                                              tensor_from_numpy)
from worldforge_tpu_torch.models.longcat import dit as tlc
from worldforge_tpu_torch.models.wan import dit as twan
from worldforge_tpu_torch.ops import bsa as tbsa
from worldforge_tpu_torch.ops import flash_attention as tfa
from worldforge_tpu_torch.ops import fused_norm as tnorm
from worldforge_tpu_torch.ops import rope as trope
from worldforge_tpu_torch.training import lora as tlora
from worldforge_tpu_torch.training import step as tstep

torch.set_num_threads(2)

KEY = functools.partial(jax.random.key, impl="rbg")
TOL_OP_GRAD = 1e-5
TOL_LOSS = 1e-5
TOL_DIT_GRAD = 1e-4
FLOOR_DIT_GRAD = 1e-7
TOL_PARAMS = 1e-4
LR, WD = 1e-3, 1e-4


def _rel_l2(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _assert_leaves_close(got_tree, want_tree, tol, what, floor=0.0):
    """Each leaf within ``tol`` of its own L2 norm plus ``floor`` of the
    whole tree's."""
    got, want = _flat(got_tree), _flat(want_tree)
    assert sorted(got) == sorted(want), what
    norm = lambda t: float(np.linalg.norm(np.asarray(
        t.detach() if isinstance(t, torch.Tensor) else t, np.float64)))
    total = np.sqrt(sum(norm(w) ** 2 for w in want.values()))
    for p, w in want.items():
        err = _rel_l2(got[p], w) * max(norm(w), 1e-30)
        assert err <= tol * norm(w) + floor * total, (what, p, err, norm(w))


def _randomize_zero_leaves(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.size and not a.any():
            return (scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map(f, tree)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


# ------------------------------------------------------------ ops


@pytest.mark.parametrize("b,sq,sk,kv_lens", [
    (2, 37, 53, None),
    (2, 37, 53, (53, 20)),         # Sq != Sk, a ragged key length
    (2, 40, 40, (40, 17)),
])
def test_flash_attention_grad_matches_jax(rng, b, sq, sk, kv_lens):
    """dq / dk / dv of the port's attention (autograd of the kernel's plain
    version on the CPU) against ``jax.grad`` of JAX's ``attention``; keys
    past ``kv_lens`` get exactly zero dk / dv."""
    h, d = 2, 16
    q, k, v = [rng.standard_normal(s).astype(np.float32) for s in
               ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))]
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    kl = None if kv_lens is None else np.asarray(kv_lens, np.int32)

    def jloss(q_, k_, v_):
        o = jattention(q_, k_, v_, kv_lens=None if kl is None
                            else jnp.asarray(kl))
        return jnp.sum(o * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = tfa.flash_attention(*leaves, kv_lens=None if kl is None
                            else torch.from_numpy(kl))
    (o * torch.from_numpy(g)).sum().backward()
    for t, w in zip(leaves, want):
        assert _rel_l2(t.grad, w) < TOL_OP_GRAD
    if kl is not None:
        for i, n in enumerate(kl):
            assert not leaves[1].grad[i, n:].any()
            assert not leaves[2].grad[i, n:].any()


def test_flash_attention_kv_len_zero_grads_are_zero(rng):
    """A row with kv_len = 0 outputs zeros (the kernel's contract), so its
    dq, dk and dv are zero, where JAX's ``sdpa_reference`` (the mean of V)
    gives that row's V a gradient: the forward's departure, pinned; the
    other row matches JAX."""
    b, sq, sk, h, d = 2, 24, 31, 2, 16
    q, k, v = [rng.standard_normal(s).astype(np.float32) for s in
               ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d))]
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    kl = np.asarray([31, 0], np.int32)
    want = jax.grad(lambda *a: jnp.sum(jattention(
        *a, kv_lens=jnp.asarray(kl)) * g), argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = tfa.flash_attention(*leaves, kv_lens=torch.from_numpy(kl))
    (o * torch.from_numpy(g)).sum().backward()
    assert not o[1].any()
    for t, w in zip(leaves, want):
        assert bool(torch.isfinite(t.grad).all())
        assert not t.grad[1].any()
        assert _rel_l2(t.grad[0], w[0]) < TOL_OP_GRAD
    assert np.abs(np.asarray(want[2][1])).max() > 0.0


def test_backward_kernels_raise_without_an_instantiation():
    """No fallback: kernel 1's backward takes bf16 with head dim 64 or 128
    and raises on anything else before it launches; the RoPE and LayerNorm
    backward wrappers raise on tensors that are not on the card."""
    for dtype, d in ((torch.float32, 128), (torch.bfloat16, 80),
                     (torch.float32, 64)):
        q = torch.zeros((1, 8, 2, d), dtype=dtype)
        m = torch.zeros((1, 2, 8))
        with pytest.raises(ValueError, match="no instantiation"):
            tfa.flash_attention_backward(q, q, q, q, q, m, m, None, 0.1)
    x = torch.zeros((1, 8, 2, 64))
    cos = torch.zeros((8, 32))
    with pytest.raises(ValueError, match="device"):
        trope.apply_rope_qk_backward(x, x, cos, cos, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tnorm.modulated_layer_norm_backward(
            torch.zeros((1, 8, 64)), torch.zeros((1, 1, 64)),
            torch.zeros((1, 8, 64)))


@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("float32", "float32"), ("float32", "bfloat16")])
def test_rope_grad_matches_jax(rng, in_dtype, out_dtype):
    """The gradient of ``apply_rope_qk`` (the rotation by -theta), with fp32
    q / k in and fp32 or bf16 out as the LongCat DiT calls it: the gradient
    arrives in the output dtype and leaves in the input's."""
    s_grid, h, d = (2, 3, 4), 3, 24
    s = int(np.prod(s_grid))
    q, k = [rng.standard_normal((2, s, h, d)).astype(np.float32)
            for _ in range(2)]
    gq, gk = [np.asarray(jnp.asarray(rng.standard_normal((2, s, h, d)),
                                     out_dtype)) for _ in range(2)]
    jcos, jsin = jrope.rope_cos_sin(*s_grid, d)
    odt = getattr(jnp, out_dtype)

    def jloss(q_, k_):
        qo, ko = jrope.apply_rope_qk(q_, k_, jcos, jsin, out_dtype=odt)
        return (jnp.sum(qo.astype(jnp.float32) * gq.astype(jnp.float32))
                + jnp.sum(ko.astype(jnp.float32) * gk.astype(jnp.float32)))

    want = jax.grad(jloss, argnums=(0, 1))(q, k)
    cos, sin = trope.rope_cos_sin(*s_grid, d)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k)]
    qo, ko = trope.apply_rope_qk(*leaves, cos, sin,
                                 out_dtype=getattr(torch, out_dtype))
    torch.autograd.backward([qo, ko], [tensor_from_numpy(gq),
                                       tensor_from_numpy(gk)])
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.float32
        assert _rel_l2(t.grad, w) < TOL_OP_GRAD


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_modulated_layer_norm_grad_matches_jax(rng, out_dtype):
    """dx, dsc and dsh of the adaLN prologue against ``jax.grad`` of JAX's
    ``modulated_layer_norm_ref``, per (batch, channel) for the modulation."""
    x = (3.0 * rng.standard_normal((2, 33, 64)) + 0.5).astype(np.float32)
    sc, sh = [(0.1 * rng.standard_normal((2, 1, 64))).astype(np.float32)
              for _ in range(2)]
    g = np.asarray(jnp.asarray(rng.standard_normal((2, 33, 64)), out_dtype))
    odt = getattr(jnp, out_dtype)
    want = jax.grad(lambda *a: jnp.sum(jnorm.modulated_layer_norm_ref(
        *a, out_dtype=odt).astype(jnp.float32) * g.astype(jnp.float32)),
        argnums=(0, 1, 2))(x, sc, sh)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, sc, sh)]
    y = tnorm.modulated_layer_norm(*leaves,
                                   out_dtype=getattr(torch, out_dtype))
    y.backward(tensor_from_numpy(g))
    for t, w in zip(leaves, want):
        assert _rel_l2(t.grad, w) < TOL_OP_GRAD


def test_bsa_sparse_grad_matches_jax(rng):
    """``bsa_sparse`` at the tiny refine shape (4 chunks of 128, sparsity
    0.5): the output and dq / dk / dv against ``jax.grad`` of JAX's
    ``bsa_sparse`` (``_bsa_reference`` forward, ``_bsa_gathered``
    backward). The selection is hard and carries no gradient."""
    bh, s, d = 3, 512, 32
    q, k, v = [rng.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3)]
    g = rng.standard_normal((bh, s, d)).astype(np.float32)
    meta = (1.0 / np.sqrt(d), "reference", False, 0.5, None)
    jo, vjp = jax.vjp(lambda *a: jbsa.bsa_sparse(*a, meta), q, k, v)
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = tbsa.bsa_sparse(*leaves, scale=1.0 / np.sqrt(d), sparsity=0.5)
    o.backward(torch.from_numpy(g))
    assert _rel_l2(o, jo) < TOL_OP_GRAD
    for t, w in zip(leaves, want):
        assert _rel_l2(t.grad, w) < TOL_OP_GRAD


# ------------------------------------------------------------ models

WAN_GRID = (3, 8, 8)


@functools.lru_cache(maxsize=None)
def _wan_tree(model_type, seed=0):
    cfg = jwan.WanDiTConfig.tiny(model_type)
    p = jwan.init_wan_dit(KEY(seed), cfg, dtype=jnp.float32)
    return cfg, _randomize_zero_leaves(_np(p), seed + 100)


def _wan_batch(cfg, seed, b=2):
    rng = np.random.default_rng(seed)
    batch = {
        "x0": rng.standard_normal((b, cfg.out_dim) + WAN_GRID),
        "context": rng.standard_normal((b, cfg.text_len, cfg.text_dim)),
    }
    if cfg.model_type == "i2v":
        batch["y"] = rng.standard_normal((b, cfg.in_dim - cfg.out_dim)
                                         + WAN_GRID)
        batch["clip_fea"] = rng.standard_normal((b, 257, cfg.clip_dim))
    return {k: v.astype(np.float32) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _longcat_tree(seed=0):
    cfg = jlc.LongCatDiTConfig.tiny()
    p = jlc.init_longcat_dit(KEY(seed), cfg, dtype=jnp.float32)
    return cfg, _randomize_zero_leaves(_np(p), seed + 100)


def _longcat_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((1, cfg.in_channels, 3, 4, 4)).astype(
                np.float32),
            "context": rng.standard_normal((1, 6, cfg.caption_channels))
            .astype(np.float32)}


def _jwan_fwd(params, cfg, x, t, ctx, *, y=None, clip_fea=None, mesh=None,
              remat=True):
    return jwan.wan_dit_forward(params, cfg, x, t, ctx, y=y,
                                clip_fea=clip_fea, policy=J_FP32,
                                remat=remat, mesh=mesh)


def _twan_fwd(params, cfg, x, t, ctx, *, y=None, clip_fea=None, mesh=None,
              remat=True):
    return twan.wan_dit_forward(params, cfg, x, t, ctx, y=y,
                                clip_fea=clip_fea, policy=T_FP32,
                                remat=remat, mesh=mesh)


def _jlc_fwd(params, cfg, x, t, ctx, *, y=None, clip_fea=None, mesh=None,
             remat=True):
    tv = jnp.broadcast_to(t[:, None], (t.shape[0], x.shape[2]))
    return jlc.longcat_dit_forward(params, cfg, x, tv, ctx, policy=J_FP32,
                                   remat=remat, mesh=mesh)


def _tlc_fwd(params, cfg, x, t, ctx, *, y=None, clip_fea=None, mesh=None,
             remat=True):
    tv = t[:, None].expand(t.shape[0], x.shape[2])
    return tlc.longcat_dit_forward(params, cfg, x, tv, ctx, policy=T_FP32,
                                   remat=remat, mesh=mesh)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(tree):
    return TP.tree_map(lambda t: t.grad, tree)


@pytest.mark.parametrize("model", ["wan", "longcat"])
def test_remat_matches_no_remat(model):
    """``remat=True`` (each block recomputed in the backward) gives the
    output of ``remat=False`` bit for bit, and the same gradients."""
    if model == "wan":
        cfg, jp = _wan_tree("i2v")
        tcfg = twan.WanDiTConfig.tiny("i2v")
        batch = _torch_batch(_wan_batch(cfg, 3, b=1))
        fwd, conv = _twan_fwd, dit_params_from_jax
        extra = dict(y=batch["y"], clip_fea=batch["clip_fea"])
    else:
        cfg, jp = _longcat_tree()
        tcfg = tlc.LongCatDiTConfig.tiny()
        batch = _torch_batch(_longcat_batch(cfg, 3))
        fwd, conv = _tlc_fwd, longcat_dit_params_from_jax
        extra = {}
    outs, grads = [], []
    for remat in (False, True):
        params = conv(jp)
        tstep.trainable_leaves(params)
        t = torch.tensor([421.0])
        out = fwd(params, tcfg, batch["x0"], t, batch["context"],
                  remat=remat, **extra)
        (out * out).mean().backward()
        outs.append(out.detach())
        grads.append(_flat(_grads(params)))
    assert torch.equal(outs[0], outs[1])
    assert sorted(grads[0]) == sorted(grads[1])
    for path, g in grads[0].items():
        assert torch.equal(g, grads[1][path]), path


def _jax_draws(key, b, shape):
    """The sigma and noise JAX's train steps draw from ``key``."""
    k_sig, k_eps = jax.random.split(key)
    sigma = jax.random.uniform(k_sig, (b,), jnp.float32, minval=1e-3,
                               maxval=1.0)
    return np.asarray(sigma), np.asarray(
        jax.random.normal(k_eps, shape, jnp.float32))


@pytest.mark.parametrize("model_type", ["i2v", "t2v"])
def test_flow_match_loss_and_grads_match_jax(model_type):
    """``flow_match_loss`` and its gradient on the tiny Wan configs (i2v
    with ``y`` and ``clip_fea``): the loss within 1e-5 and every gradient
    leaf within 1e-4 relative L2 of JAX's, carried over by
    ``dit_params_from_jax`` as the parameters are."""
    cfg, jp = _wan_tree(model_type)
    batch = _wan_batch(cfg, 5)
    sigma, noise = _jax_draws(KEY(7), 2, batch["x0"].shape)

    def jloss(p):
        return jstep.flow_match_loss(
            p, cfg, batch["x0"], noise, sigma, batch["context"],
            y=batch.get("y"), clip_fea=batch.get("clip_fea"),
            forward_fn=_jwan_fwd)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(_np(jp))
    params = dit_params_from_jax(jp)
    tstep.trainable_leaves(params)
    tb = _torch_batch(batch)
    loss = tstep.flow_match_loss(
        params, twan.WanDiTConfig.tiny(model_type), tb["x0"],
        torch.from_numpy(noise), torch.from_numpy(sigma), tb["context"],
        y=tb.get("y"), clip_fea=tb.get("clip_fea"), forward_fn=_twan_fwd)
    loss.backward()
    assert abs(float(loss) - float(jl)) <= TOL_LOSS * abs(float(jl))
    _assert_leaves_close(_grads(params), dit_params_from_jax(_np(jg)),
                         TOL_DIT_GRAD, "grads", floor=FLOOR_DIT_GRAD)


@pytest.mark.parametrize("model", ["wan", "longcat"])
def test_make_train_step_matches_optax(model):
    """3 AdamW steps (lr 1e-3, weight decay 1e-4; ``torch.optim.AdamW``
    with optax's defaults) of ``make_train_step`` from one init, fed JAX's
    sigma and noise of each step: losses within 1e-5 of the optax run's,
    every parameter within 1e-4 relative L2 after the 3 steps."""
    if model == "wan":
        cfg, jp = _wan_tree("i2v", seed=1)
        batch = _wan_batch(cfg, 6)
        jfwd, tfwd, conv = _jwan_fwd, _twan_fwd, dit_params_from_jax
        tcfg = twan.WanDiTConfig.tiny("i2v")
    else:
        cfg, jp = _longcat_tree(seed=1)
        batch = _longcat_batch(cfg, 6)
        jfwd, tfwd, conv = _jlc_fwd, _tlc_fwd, longcat_dit_params_from_jax
        tcfg = tlc.LongCatDiTConfig.tiny()
    opt = optax.adamw(LR, weight_decay=WD)
    jstate = _np(jp)
    jopt = opt.init(jstate)
    jrun = jax.jit(jstep.make_train_step(cfg, opt, forward_fn=jfwd))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlosses = []
    for i in range(3):
        jstate, jopt, loss = jrun(jstate, jopt, jbatch, KEY(30 + i))
        jlosses.append(float(loss))

    params = conv(jp)
    topt = torch.optim.AdamW(tstep.trainable_leaves(params), lr=LR,
                             weight_decay=WD)
    step = tstep.make_train_step(tcfg, topt, forward_fn=tfwd)
    tb = _torch_batch(batch)
    for i in range(3):
        sigma, noise = _jax_draws(KEY(30 + i), batch["x0"].shape[0],
                                  batch["x0"].shape)
        loss = step(params, tb, sigma=torch.from_numpy(sigma),
                    noise=torch.from_numpy(noise))
        assert abs(float(loss) - jlosses[i]) <= TOL_LOSS * abs(jlosses[i])
    _assert_leaves_close(params, conv(_np(jstate)), TOL_PARAMS, "params")


def test_train_step_decreases_loss():
    """The JAX tests' property on the port's own defaults (the Wan forward
    under the default bf16-compute policy, remat on): the loss falls at
    every step on an overfit batch (the same sigma and noise each step),
    and by more than 3% over 6 steps."""
    cfg = twan.WanDiTConfig.tiny("t2v")
    params = twan.init_wan_dit(torch.Generator().manual_seed(0), cfg,
                               dtype=torch.float32)
    opt = torch.optim.AdamW(tstep.trainable_leaves(params), lr=1e-3,
                            weight_decay=WD)
    step = tstep.make_train_step(cfg, opt)
    batch = _torch_batch(_wan_batch(jwan.WanDiTConfig.tiny("t2v"), 0))
    losses = [float(step(params, batch, torch.Generator().manual_seed(42)))
              for _ in range(6)]
    assert np.isfinite(losses).all(), losses
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < losses[0] * 0.97, losses


def test_make_train_step_takes_no_mesh():
    """``make_train_step`` and ``make_lora_train_step`` take a mesh (the
    multi-rank steps are held against JAX in
    ``tests/test_torch_parallel_models.py``): on a one-rank gloo mesh a
    step gives the mesh-free step's loss and parameters bit for bit."""
    import socket

    import torch.distributed as dist

    from worldforge_tpu_torch.core.mesh import init_process_group, make_mesh
    cfg = twan.WanDiTConfig.tiny("t2v")
    batch = _torch_batch(_wan_batch(jwan.WanDiTConfig.tiny("t2v"), 0))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_process_group("cpu", rank=0, world_size=1,
                       init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_mesh(1, 1, 1, device="cpu")
        runs = []
        for m in (None, mesh):
            params = twan.init_wan_dit(torch.Generator().manual_seed(0), cfg,
                                       dtype=torch.float32)
            opt = torch.optim.AdamW(tstep.trainable_leaves(params), lr=LR,
                                    weight_decay=WD)
            loss = tstep.make_train_step(cfg, opt, mesh=m)(
                params, batch, torch.Generator().manual_seed(1))
            lora = tlora.init_lora(torch.Generator().manual_seed(2), params,
                                   rank=2)
            lopt = torch.optim.AdamW(tstep.trainable_leaves(lora), lr=LR)
            lloss = tlora.make_lora_train_step(cfg, lopt, params, mesh=m)(
                lora, batch, torch.Generator().manual_seed(3))
            runs.append((loss, _flat(params), lloss, _flat(lora)))
    finally:
        dist.destroy_process_group()
    (l0, p0, ll0, a0), (l1, p1, ll1, a1) = runs
    assert torch.equal(l0, l1) and torch.equal(ll0, ll1)
    for flat0, flat1 in ((p0, p1), (a0, a1)):
        assert sorted(flat0) == sorted(flat1)
        for k in flat0:
            assert torch.equal(flat0[k], flat1[k]), k


# ------------------------------------------------------------ LoRA


def test_make_lora_train_step_matches_jax():
    """3 AdamW steps (lr 1e-3, weight decay 1e-4) of
    ``make_lora_train_step`` on the tiny Wan i2v from adapters of JAX's
    ``init_lora`` whose zero ``up`` is randomised (the zero-leaf rule; from
    a zero start a leaf is Adam's per-element normalised steps alone),
    fed JAX's sigma and noise: losses within 1e-5 of JAX's (which merges
    the adapters where the port keeps them unmerged: the same function up
    to fp32 rounding), adapters within 1e-4 relative L2; the base
    bit-unchanged. With ``up`` at zero (JAX's init) the first forward
    equals the base forward exactly."""
    cfg, jp = _wan_tree("i2v", seed=2)
    tcfg = twan.WanDiTConfig.tiny("i2v")
    batch = _wan_batch(cfg, 8)
    j0 = _np(jlora.init_lora(KEY(3), _np(jp), rank=4))
    jl = _randomize_zero_leaves(j0, 5, scale=0.05)
    opt = optax.adamw(LR, weight_decay=WD)
    jrun = jax.jit(jlora.make_lora_train_step(cfg, opt, _np(jp),
                                              forward_fn=_jwan_fwd))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jopt, jlosses = jl, opt.init(jl), []
    for i in range(3):
        jstate, jopt, loss = jrun(jstate, jopt, jbatch, KEY(40 + i))
        jlosses.append(float(loss))

    base = dit_params_from_jax(jp)
    before = {p: t.clone() for p, t in _flat(base).items()}
    tb = _torch_batch(batch)
    t0 = torch.tensor([500.0, 500.0])
    extra = dict(y=tb["y"], clip_fea=tb["clip_fea"])
    with torch.no_grad():
        plain = _twan_fwd(base, tcfg, tb["x0"], t0, tb["context"], **extra)
        attached = _twan_fwd(tlora._with_lora(base, lora_from_jax(j0), 1.0,
                                              merge=False),
                             tcfg, tb["x0"], t0, tb["context"], **extra)
    assert torch.equal(plain, attached)

    lora = lora_from_jax(jl)
    topt = torch.optim.AdamW(tstep.trainable_leaves(lora), lr=LR,
                             weight_decay=WD)
    step = tlora.make_lora_train_step(tcfg, topt, base, forward_fn=_twan_fwd)
    for i in range(3):
        sigma, noise = _jax_draws(KEY(40 + i), 2, batch["x0"].shape)
        loss = step(lora, tb, sigma=torch.from_numpy(sigma),
                    noise=torch.from_numpy(noise))
        assert abs(float(loss) - jlosses[i]) <= TOL_LOSS * abs(jlosses[i])
    _assert_leaves_close(lora, lora_from_jax(_np(jstate)), TOL_PARAMS,
                         "adapters")
    for p, t in _flat(base).items():
        assert torch.equal(t, before[p]), p
        assert t.grad is None, p


def test_trained_lora_exports_and_merges_to_the_merged_forward():
    """LongCat adapters trained by ``make_lora_train_step`` through
    ``longcat_forward`` go through ``export_reference_lora`` (the
    reference's state-dict layout), ``convert_longcat_lora`` and
    ``merge_lora_stacked`` into the weights: that merged forward equals the
    forward over ``apply_lora``'s merge to 1e-6 relative, and the train
    step's unmerged forward to 1e-5."""
    cfg, jp = _longcat_tree(seed=3)
    tcfg = tlc.LongCatDiTConfig.tiny()
    base = longcat_dit_params_from_jax(jp)
    lora = {p: a for p, a in tlora.init_lora(
        torch.Generator().manual_seed(4), base, rank=4).items()
        if p.startswith("blocks/")}
    opt = torch.optim.AdamW(tstep.trainable_leaves(lora), lr=1e-2,
                            weight_decay=WD)
    step = tlora.make_lora_train_step(tcfg, opt, base,
                                      forward_fn=tstep.longcat_forward)
    tb = _torch_batch(_longcat_batch(cfg, 9))
    losses = [float(step(lora, tb, torch.Generator().manual_seed(i)))
              for i in range(2)]
    assert np.isfinite(losses).all()
    assert any(a["up"].abs().max() > 0 for a in lora.values())
    lora = {p: {k: v.detach() for k, v in a.items()} for p, a in lora.items()}
    scale = 0.7
    sd = tlora.export_reference_lora(lora, scale=scale)
    merged = merge_lora_stacked(base, convert_longcat_lora(sd))
    t = torch.tensor([600.0])
    with torch.no_grad():
        runs = [tstep.longcat_forward(p, tcfg, tb["x0"], t, tb["context"],
                                      remat=False)
                for p in (merged, tlora.apply_lora(base, lora, scale),
                          tlora._with_lora(base, lora, scale, merge=False))]
    assert _rel_l2(runs[0], runs[1]) < 1e-6
    assert _rel_l2(runs[0], runs[2]) < 1e-5
    assert _rel_l2(runs[0], tstep.longcat_forward(
        base, tcfg, tb["x0"], t, tb["context"], remat=False).detach()) > 1e-4
