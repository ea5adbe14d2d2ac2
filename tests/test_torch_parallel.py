"""The port's parallel layer (``core/mesh.py``, ``parallel/*``) against the
JAX package's ``shard_map`` on the CPU.

One spawn of gloo processes per world size (2 and 4) runs every check of
``tests/torch_parallel_workers.py`` on each rank; the JAX side runs the
same global inputs (numpy from a seed) on a mesh of that many of the 8
virtual CPU devices. Each rank's rows of a result are held against the same
rows of JAX's global result at 1e-5 relative (fp32): Ulysses (with
``kv_lens``, and on a (dp, sp) mesh), the sequence-local cross-attention,
ring attention, the two log-sum-exp merges (rows with no key on either
side included), block-sparse ring CP (at sparsity 0.875 every query chunk
selects one chunk, so the other ranks' counts are 0), the 2-D split's
attention, cross-attention and RoPE rows, and the FSDP chunks against
JAX's shards. Uneven token counts (which JAX's ``shard_map`` refuses) are
held against JAX's unsharded attention: the port pads them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.torch_parallel_workers import run_spawn
from worldforge_tpu.core.mesh import make_mesh as jmake_mesh
from worldforge_tpu.models.wan import dit as jwan
from worldforge_tpu.ops.attention import sdpa_reference
from worldforge_tpu.parallel import bsa_cp as jbsa_cp
from worldforge_tpu.parallel import cp2d as jcp2d
from worldforge_tpu.parallel import ring as jring
from worldforge_tpu.parallel import sharding as jsharding
from worldforge_tpu.parallel import ulysses as julysses
from worldforge_tpu_torch.parallel import cp2d as tcp2d
from worldforge_tpu_torch.parallel import sharding as tsharding

TOL = 1e-5
WORLDS = (2, 4)
H, D = 4, 16


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _mesh(world, dp=1, fsdp=1, sp=1):
    return jmake_mesh(dp, fsdp, sp, devices=jax.devices()[:world])


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _inputs(world):
    rng = np.random.default_rng(world)
    s = 8 * world
    q, k, v = _qkv(rng, (2, s, H, D))
    inp = {
        "ulysses": dict(q=q, k=k, v=v, kv_lens=np.array([s - 3, 5], np.int32),
                        mesh=(1, 1, world)),
        "ulysses_dp": dict(q=q, k=k, v=v, mesh=(2, 1, world // 2)),
    }
    qp, kp, vp = _qkv(rng, (1, s - 3, H, D))
    inp["ulysses_pad"] = dict(q=qp, k=kp, v=vp, mesh=(1, 1, world))
    kc, vc = _qkv(rng, (2, 6, H, D))[:2]
    inp["cross"] = dict(q=q, k=kc, v=vc, mesh=(1, 1, world))
    qr, kr, vr = _qkv(rng, (1, 16 * world, 2, D))
    inp["ring"] = dict(q=qr, k=kr * 3.0, v=vr, mesh=(1, 1, world))
    o = rng.standard_normal((2, 2, 6, 3, 4)).astype(np.float32)
    m = (rng.standard_normal((2, 2, 3, 6)) * 3).astype(np.float32)
    l = rng.uniform(0.5, 4, (2, 2, 3, 6)).astype(np.float32)
    # rows with no key on one side, and on both (m -1e30, l 0, out 0)
    m[1, :, 0, :2], l[1, :, 0, :2], o[1, :, :2, 0] = -1e30, 0.0, 0.0
    m[0, :, 1, 3], l[0, :, 1, 3] = -1e30, 0.0
    inp["merge"] = dict(o_a=o[0], m_a=m[0], l_a=l[0], o_b=o[1], m_b=m[1],
                        l_b=l[1], fo_a=o[0, :, :, 0], fm_a=m[0, :, 0],
                        fl_a=l[0, :, 0], fo_b=o[1, :, :, 0], fm_b=m[1, :, 0],
                        fl_b=l[1, :, 0])
    # 512 tokens = 4 chunks of (4, 4, 8), in two grids
    qb, kb, vb = _qkv(rng, (1, 512, 1, 64))
    for name, sparsity, cdf, g in (("bsa_cp", 0.5, None, (4, 8, 16)),
                                   ("bsa_cp_cdf", None, 0.6, (4, 8, 16)),
                                   ("bsa_cp_empty", 0.875, None, (8, 8, 8))):
        inp[name] = dict(q=qb, k=kb, v=vb, grid=g, sparsity=sparsity,
                         cdf=cdf, mesh=(1, 1, world))
    sph, spw = tcp2d.get_optimal_split(world)
    q2, k2, v2 = _qkv(rng, (1, 2, 4, 8, H, D))
    inp["cp2d"] = dict(q=q2, k=k2, v=v2, kc=kc[:1], vc=vc[:1],
                       sp_hw=(sph, spw))
    cfg = jwan.WanDiTConfig(in_dim=12, out_dim=4, dim=64, ffn_dim=128,
                            num_heads=4, num_layers=2, text_len=8,
                            text_dim=32, freq_dim=16, clip_dim=64)
    inp["fsdp"] = dict(params=jax.tree_util.tree_map(
        np.asarray, jwan.init_wan_dit(jax.random.key(0, impl="rbg"), cfg,
                                      dtype=jnp.float32)),
                       mesh=(1, world, 1))
    x = rng.standard_normal((2, 8 * world - 5, 2 * world, 8)).astype(
        np.float32)
    inp["exchanges"] = dict(x=x, order=rng.permutation(x.shape[1]),
                            mesh=(1, 1, world))
    return inp


FN = {"ulysses_dp": "ulysses", "ulysses_pad": "ulysses",
      "bsa_cp_cdf": "bsa_cp", "bsa_cp_empty": "bsa_cp"}


@pytest.fixture(scope="module", params=WORLDS)
def run(request):
    world = request.param
    inp = _inputs(world)
    ranks = run_spawn(world, [(n, FN.get(n, n), a) for n, a in inp.items()])
    return world, inp, ranks


def _check_rows(ranks, name, want, tol=TOL):
    for r in ranks:
        got = r[name]
        n = got["n_real"]
        rows = want[got["b0"]:got["b0"] + got["nb"]][:, got["index"][:n]]
        assert _rel(got["out"][:, :n], rows) < tol, (name, _rel(
            got["out"][:, :n], rows))


def _sharded(mesh, *arrays, spec=P("dp", "sp", None, None)):
    return [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
            for a in arrays]


def test_ulysses_matches_shard_map(run):
    world, inp, ranks = run
    for name in ("ulysses", "ulysses_dp"):
        a = inp[name]
        mesh = _mesh(world, *a["mesh"])
        q, k, v = _sharded(mesh, a["q"], a["k"], a["v"])
        kv = a.get("kv_lens")
        with mesh:
            want = jax.jit(lambda q, k, v: julysses.ulysses_attention(
                q, k, v, mesh=mesh,
                kv_lens=None if kv is None else jnp.asarray(kv)))(q, k, v)
        _check_rows(ranks, name, np.asarray(want))


def test_ulysses_pads_uneven_tokens(run):
    """S = 8 * world - 3 tokens: JAX's shard_map refuses the cut; the port
    pads the last rank and drops the pad rows after the exchange, so the
    result is JAX's unsharded attention."""
    _, inp, ranks = run
    a = inp["ulysses_pad"]
    want = sdpa_reference(*(jnp.asarray(a[n]) for n in "qkv"))
    assert any(r["ulysses_pad"]["n_real"] < len(r["ulysses_pad"]["index"])
               for r in ranks)
    _check_rows(ranks, "ulysses_pad", np.asarray(want))


def test_sequence_local_cross_attention_matches_shard_map(run):
    world, inp, ranks = run
    a = inp["cross"]
    mesh = _mesh(world, *a["mesh"])
    with mesh:
        want = jax.jit(lambda q, k, v: julysses.sequence_local_cross_attention(
            q, k, v, mesh=mesh))(*(jnp.asarray(a[n]) for n in "qkv"))
    _check_rows(ranks, "cross", np.asarray(want))


def test_ring_matches_shard_map(run):
    world, inp, ranks = run
    a = inp["ring"]
    mesh = _mesh(world, *a["mesh"])
    q, k, v = _sharded(mesh, a["q"], a["k"], a["v"],
                       spec=P(None, "sp", None, None))
    with mesh:
        want = jax.jit(lambda q, k, v: jring.ring_attention(
            q, k, v, mesh=mesh))(q, k, v)
    _check_rows(ranks, "ring", np.asarray(want))
    # forward only: an input that needs a gradient is refused
    assert all(r["ring"]["grad_refused"] for r in ranks)


def test_merges_match_jax(run):
    _, inp, ranks = run
    a = inp["merge"]
    jv = {k: jnp.asarray(v) for k, v in a.items() if k != "mesh"}
    want = jring._merge(*(jv[n] for n in ("o_a", "m_a", "l_a", "o_b", "m_b",
                                          "l_b")))
    wantf = jbsa_cp._merge_flat(*(jv[n] for n in ("fo_a", "fm_a", "fl_a",
                                                  "fo_b", "fm_b", "fl_b")))
    got = ranks[0]["merge"]
    for g, w in zip((got["out"], got["m"], got["l"]), want):
        assert np.isfinite(g).all() and _rel(g, w) < TOL
    for g, w in zip((got["fo"], got["fm"], got["fl"]), wantf):
        assert np.isfinite(g).all() and _rel(g, w) < TOL


@pytest.mark.parametrize("name", ["bsa_cp", "bsa_cp_cdf", "bsa_cp_empty"])
def test_bsa_cp_matches_shard_map(run, name):
    """Each rank holds whole chunks of BSA's chunk order; its rows are the
    rows of JAX's raster-order result at the raster indices it holds. At
    sparsity 0.875 each query chunk selects one key chunk, so its count is
    0 on every other rank: the merge must keep those rows (no NaN)."""
    world, inp, ranks = run
    a = inp[name]
    mesh = _mesh(world, *a["mesh"])
    g = tuple(a["grid"])
    want = jbsa_cp.bsa_attention_3d_cp(
        *(jnp.asarray(a[n]) for n in "qkv"), g, g, mesh=mesh,
        sparsity=a["sparsity"], cdf_threshold=a["cdf"], interpret=True)
    _check_rows(ranks, name, np.asarray(want), tol=2e-5)
    if name == "bsa_cp_empty":
        assert sum(r[name]["empty_rows"] for r in ranks) > 0
        assert all(np.isfinite(r[name]["out"]).all() for r in ranks)


def test_cp2d_matches_shard_map(run):
    world, inp, ranks = run
    a = inp["cp2d"]
    sph, spw = a["sp_hw"]
    mesh = jcp2d.make_mesh_2d(1, 1, sph, spw, devices=jax.devices()[:world])
    spec = P("dp", None, "sp_h", "sp_w", None, None)
    q, k, v = _sharded(mesh, a["q"], a["k"], a["v"], spec=spec)
    with mesh:
        want = np.asarray(jax.jit(lambda q, k, v: jcp2d.ulysses_attention_2d(
            q, k, v, mesh=mesh))(q, k, v))
        wantx = np.asarray(jax.jit(lambda q, k, v: jcp2d.cross_attention_2d(
            q, k, v, mesh=mesh))(q, jnp.asarray(a["kc"]),
                                 jnp.asarray(a["vc"])))
    hl, wl = a["q"].shape[2] // sph, a["q"].shape[3] // spw
    for r in ranks:
        got = r["cp2d"]
        blk = (slice(None), slice(None), slice(got["h0"], got["h0"] + hl),
               slice(got["w0"], got["w0"] + wl))
        assert _rel(got["self"], want[blk]) < TOL
        assert _rel(got["cross"], wantx[blk]) < TOL
        assert got["roundtrip"] and got["rope_rows_equal"]


def test_optimal_split_matches_jax():
    for n in range(1, 33):
        assert tcp2d.get_optimal_split(n) == jcp2d.get_optimal_split(n)


def test_fsdp_spec_matches_jax():
    shapes = [(128, 512), (512, 128), (7, 13), (4, 128, 512), (6, 6),
              (3, 64, 8), (), (12,), (1, 6, 64)]
    for shape in shapes:
        for size in (1, 2, 4):
            for skip in (0, 1):
                want = tuple(jsharding.fsdp_spec(shape, size, skip_axes=skip))
                assert tsharding.fsdp_spec(shape, size,
                                           skip_axes=skip) == want
    assert tsharding.activation_spec(4) == tuple(jsharding.activation_spec(4))


def test_fsdp_chunks_match_jax_shards(run):
    """Each rank's chunk of every leaf is JAX's shard on the device at its
    fsdp coordinate (a stacked block leaf's shard, unstacked); the gather
    gives the tree back bit for bit, and its backward (a reduce-scatter,
    averaged over the fsdp ranks, which all hold the same gradient) gives
    each rank its chunk of the gradient."""
    from worldforge_tpu_torch.core import params as TP
    from worldforge_tpu_torch.io.from_jax import dit_params_from_jax
    world, inp, ranks = run
    mesh = _mesh(world, 1, world, 1)
    sharded = jsharding.shard_params_fsdp(
        jax.tree_util.tree_map(jnp.asarray, inp["fsdp"]["params"]), mesh)
    n_sharded = 0
    for fc, r in enumerate(ranks):
        dev = mesh.devices[0, fc, 0]
        shard = jax.tree_util.tree_map(lambda a: np.asarray(
            [s.data for s in a.addressable_shards if s.device == dev][0]),
            sharded)
        want = []
        TP.tree_map(want.append, dit_params_from_jax(shard))
        got = r["fsdp"]
        assert len(want) == len(got["chunks"])
        for w, g in zip(want, got["chunks"]):
            np.testing.assert_array_equal(g, w.numpy())
        n_sharded = sum(a is not None for a in got["axes"])
        assert got["gathered_equal"]
        for g, w in zip(got["grads"], got["want_grads"]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert n_sharded > 0


def test_token_split_exchanges(run):
    """A permuted order with pad rows: split + gather and the Ulysses pair
    give the tensor back, the heads come out in the global order, and pad
    rows get no gradient."""
    _, _, ranks = run
    for r in ranks:
        assert r["exchanges"] == {"gather": True, "heads": True,
                                  "roundtrip": True, "grad": True}
