"""The port's dp×tp×sp×ep sharded transformer step
(``coinstac_dinunet_tpu_torch/parallel/sequence.py``) against the JAX
package's ``parallel/sequence.py`` on the same numpy inputs and weights.

JAX runs on the test platform's 8 forced CPU devices; the port on
``["cpu"] * n`` ranks, attention through the kernels' plain versions (head
dim 8).  JAX's tree carries float64 norms and biases under the platform's
x64 (so its logits come out float64); ``interop.tsp_params_from_jax`` casts
every leaf to float32, and the comparisons hold float32 tolerances:
logits within 1e-5 of JAX at one rank and within 2e-5 on a mesh (JAX's own
mesh-invariance tolerance), the MoE aux loss within a relative 1e-5, a
train step's loss and every updated leaf within 2e-5.  The MoE cases run at
``capacity_factor`` 0.5 and assert that tokens were dropped, so the
global capacity and buffer positions decide the result.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.parallel import sequence as jseq
from coinstac_dinunet_tpu_torch import interop
from coinstac_dinunet_tpu_torch.parallel import sequence as seq

fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

LOGITS_ONE_RANK_ATOL = 1e-5
MESH_ATOL = 2e-5
AUX_RTOL = 1e-5
SMALL = dict(num_features=8, d_model=32, num_heads=4, num_layers=2, max_len=64)
MOE = dict(num_experts=4, capacity_factor=0.5)


def _data(cfg, b=4, t=32, seed=0):
    """JAX's test recipe: a label-dependent sine under noise."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, cfg.num_classes, size=b).astype(np.int32)
    sig = np.sin(2 * np.pi * (y[:, None, None] + 1) * np.arange(t)[None, :, None] / t)
    x = (rng.normal(size=(b, t, cfg.num_features)) * 0.3 + sig).astype(np.float32)
    return x, y


def _configs(**kw):
    return jseq.TSPConfig(**{**SMALL, **kw}), seq.TSPConfig(**{**SMALL, **kw})


def _port_mesh(shape):
    return seq.build_tsp_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


def _port_params(jax_params, mesh):
    return seq.shard_tsp_params(interop.tsp_params_from_jax(jax_params, "cpu"), mesh)


def _jax_forward(params, x, y, cfg, shape):
    mesh = jseq.build_tsp_mesh(*shape)
    xs, _ = jseq.shard_tsp_batch(x, y, mesh)
    logits, aux = jax.jit(lambda p, xx: jseq.tsp_forward(p, xx, cfg, mesh))(
        jseq.shard_tsp_params(params, mesh), xs)
    return np.asarray(logits), float(aux)


def _port_forward(params, x, cfg, shape, stats=None):
    mesh = _port_mesh(shape)
    with torch.no_grad():
        logits, aux = seq.tsp_forward(_port_params(params, mesh), x, cfg, mesh, stats=stats)
    return logits.numpy(), float(aux)


@pytest.fixture(scope="module")
def dense():
    """JAX's parameters and batch, and its forward at one rank and on the
    dp2×tp2×sp2 mesh, causal and not (each compiled once)."""
    out = {}
    for causal in (False, True):
        jc, pc = _configs(causal=causal)
        params = jseq.init_tsp_params(jax.random.PRNGKey(0), jc)
        x, y = _data(jc)
        out[causal] = dict(jc=jc, pc=pc, params=params, x=x, y=y,
                           one=_jax_forward(params, x, y, jc, (1, 1, 1, 1)),
                           mesh=_jax_forward(params, x, y, jc, (2, 2, 2, 1)))
    return out


@pytest.mark.parametrize("causal", [False, True])
def test_tsp_forward_one_rank_matches_jax(dense, causal):
    case = dense[causal]
    logits, aux = _port_forward(case["params"], case["x"], case["pc"], (1, 1, 1, 1))
    np.testing.assert_allclose(logits, case["one"][0], rtol=0, atol=LOGITS_ONE_RANK_ATOL)
    assert aux == case["one"][1] == 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_tsp_forward_dense_mesh_matches_jax_and_one_rank(dense, causal):
    case = dense[causal]
    logits, _ = _port_forward(case["params"], case["x"], case["pc"], (2, 2, 2, 1))
    one, _ = _port_forward(case["params"], case["x"], case["pc"], (1, 1, 1, 1))
    np.testing.assert_allclose(logits, case["mesh"][0], rtol=0, atol=MESH_ATOL)
    np.testing.assert_allclose(logits, one, rtol=0, atol=MESH_ATOL)


@pytest.mark.parametrize("shape", [(1, 2, 2, 2), (2, 1, 2, 2)], ids=["tp2sp2ep2", "dp2sp2ep2"])
def test_tsp_forward_moe_drops_tokens_and_matches_jax(shape):
    jc, pc = _configs(causal=True, **MOE)
    params = jseq.init_tsp_params(jax.random.PRNGKey(2), jc)
    x, y = _data(jc, seed=2)
    want, want_aux = _jax_forward(params, x, y, jc, shape)
    stats = []
    got, aux = _port_forward(params, x, pc, shape, stats)
    one, one_aux = _port_forward(params, x, pc, (1, 1, 1, 1))
    # capacity 0.5 · 128 / 4 = 16 of each expert's tokens: some are dropped
    assert [s["capacity"] for s in stats] == [16, 16]
    assert all(float(s["dropped"]) > 0.1 for s in stats), stats
    np.testing.assert_allclose(got, want, rtol=0, atol=MESH_ATOL)
    np.testing.assert_allclose(got, one, rtol=0, atol=MESH_ATOL)
    assert aux > 0
    np.testing.assert_allclose(aux, want_aux, rtol=AUX_RTOL)
    np.testing.assert_allclose(aux, one_aux, rtol=AUX_RTOL)


def test_moe_drops_as_many_tokens_on_a_mesh_as_on_one_rank():
    """With capacity binding, the dp2×sp2 blocks keep at most ``C`` tokens
    an expert over the whole batch, and drop the same share per layer as
    one rank does (a per-block capacity would keep up to 4·C)."""
    _, pc = _configs(causal=False, **MOE)
    params = seq.init_tsp_params(torch.Generator().manual_seed(4), pc, device="cpu")
    x, _ = _data(pc, seed=4)
    mesh = _port_mesh((2, 1, 2, 1))
    stats = []
    with torch.no_grad():
        seq.tsp_forward(seq.shard_tsp_params(params, mesh), x, pc, mesh, stats=stats)
    n_tok = 4 * 32
    for s in stats:
        kept = round((1 - float(s["dropped"])) * n_tok)
        assert kept <= pc.num_experts * s["capacity"]
    one = []
    with torch.no_grad():
        m1 = _port_mesh((1, 1, 1, 1))
        seq.tsp_forward(seq.shard_tsp_params(params, m1), x, pc, m1, stats=one)
    assert [float(s["dropped"]) for s in stats] == [float(s["dropped"]) for s in one]


@pytest.fixture(scope="module")
def steps():
    """JAX's updated tree and loss after one step (lr 5e-2), dense on
    dp2×tp2×sp2 (causal) and MoE on tp2×sp2×ep2 at capacity 0.5."""
    out = {}
    for kind, shape, kw in (("dense", (2, 2, 2, 1), dict(causal=True)),
                            ("moe", (1, 2, 2, 2), dict(causal=True, **MOE))):
        jc, pc = _configs(**kw)
        params = jseq.init_tsp_params(jax.random.PRNGKey(5), jc)
        x, y = _data(jc, seed=5)
        mesh = jseq.build_tsp_mesh(*shape)
        step = jseq.make_tsp_train_step(jc, mesh, lr=5e-2, donate=False)
        xs, ys = jseq.shard_tsp_batch(x, y, mesh)
        new, loss = step(jseq.shard_tsp_params(params, mesh), xs, ys)
        out[kind] = dict(shape=shape, pc=pc, params=params, x=x, y=y, loss=float(loss),
                         new=jax.tree_util.tree_map(np.asarray, new))
    return out


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_tsp_train_step_matches_jax(steps, kind):
    case = steps[kind]
    mesh = _port_mesh(case["shape"])
    params = _port_params(case["params"], mesh)
    before = [t.clone() for t in seq.tensors(params)]
    step = seq.make_tsp_train_step(case["pc"], mesh, lr=5e-2, donate=False)
    new, loss = step(params, case["x"], case["y"])
    np.testing.assert_allclose(float(loss), case["loss"], rtol=0, atol=MESH_ATOL)
    got = jax.tree_util.tree_leaves(seq.gather_tsp_params(new))
    want = jax.tree_util.tree_leaves(case["new"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=MESH_ATOL)
    # donate=False leaves the caller's shards as they were
    for a, b in zip(seq.tensors(params), before):
        assert torch.equal(a, b)


def test_donated_step_updates_the_shards_in_place():
    _, pc = _configs(causal=True)
    mesh = _port_mesh((1, 2, 2, 1))
    params = seq.shard_tsp_params(
        seq.init_tsp_params(torch.Generator().manual_seed(6), pc, device="cpu"), mesh)
    x, y = _data(pc, seed=6)
    keep = seq.make_tsp_train_step(pc, mesh, lr=1e-2, donate=False)(params, x, y)[0]
    ids = [t.data_ptr() for t in seq.tensors(params)]
    new, _ = seq.make_tsp_train_step(pc, mesh, lr=1e-2, donate=True)(params, x, y)
    assert new is params and [t.data_ptr() for t in seq.tensors(new)] == ids
    for a, b in zip(seq.tensors(new), seq.tensors(keep)):
        assert torch.equal(a, b)


def test_port_tsp_steps_lower_the_loss():
    """30 SGD steps on dp2×tp2×sp2 (causal) lower the loss, as JAX's
    ``test_tsp_train_step_learns`` does on its mesh."""
    _, pc = _configs(causal=True, num_layers=1)
    mesh = _port_mesh((2, 2, 2, 1))
    params = seq.shard_tsp_params(
        seq.init_tsp_params(torch.Generator().manual_seed(1), pc, device="cpu"), mesh)
    x, y = seq.shard_tsp_batch(*_data(pc, b=8, t=16, seed=1), mesh)
    step = seq.make_tsp_train_step(pc, mesh, lr=5e-2)
    losses = [float(step(params, x, y)[1]) for _ in range(30)]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0] * 0.7, losses


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 2, 2, 1), (1, 2, 2, 2), (2, 1, 4, 1)])
def test_flash_calls_a_step(monkeypatch, shape):
    """K2, K3 and K4 each run ``L · dp · tp · sp²`` times a step, whatever
    ``ep`` is (attention is not replicated over the expert axis)."""
    calls = {"fwd": 0, "bwd": 0}

    def counting(t, cuda_fn, plain_fn):
        calls["fwd" if plain_fn is fa.flash_forward_plain else "bwd"] += 1
        return plain_fn

    monkeypatch.setattr(fa, "_dispatch", counting)
    _, pc = _configs(causal=True, **(MOE if shape[3] > 1 else {}))
    mesh = _port_mesh(shape)
    params = seq.shard_tsp_params(
        seq.init_tsp_params(torch.Generator().manual_seed(7), pc, device="cpu"), mesh)
    seq.make_tsp_train_step(pc, mesh)(params, *_data(pc, seed=7))
    dp, tp, sp, _ = shape
    want = pc.num_layers * dp * tp * sp * sp
    assert calls == {"fwd": want, "bwd": want}


@pytest.mark.parametrize("experts", [0, 4])
def test_shards_follow_the_param_specs(experts):
    """Each sharded leaf is held as ``_param_specs`` splits it, shard by
    shard on its rank's device; replicated leaves once on the first rank;
    gathering the shards gives the tree back bit for bit."""
    jc, pc = _configs(num_experts=experts)
    params = jseq.init_tsp_params(jax.random.PRNGKey(3), jc)
    mesh = _port_mesh((2, 2, 1, 2))
    sharded = seq.shard_tsp_params(interop.tsp_params_from_jax(params, "cpu"), mesh)
    layer = sharded["layers"][0]
    d, h, hd, ff, e = pc.d_model, pc.num_heads, pc.head_dim, pc.d_ff, experts
    assert [tuple(w.shape) for w in layer["wqkv"]] == [(3, d, h // 2, hd)] * 2
    assert [tuple(w.shape) for w in layer["wo"]] == [(h // 2, hd, d)] * 2
    if experts:
        for key, shape in (("w1e", (e // 2, d, ff // 2)), ("b1e", (e // 2, ff // 2)),
                           ("w2e", (e // 2, ff // 2, d))):  # [ep][tp]
            assert [[tuple(w.shape) for w in row] for row in layer[key]] == [[shape] * 2] * 2
        assert [tuple(b.shape) for b in layer["b2e"]] == [(e // 2, d)] * 2
        assert tuple(layer["wg"].shape) == (d, e)
    else:
        assert [tuple(w.shape) for w in layer["w1"]] == [(d, ff // 2)] * 2
        assert [tuple(b.shape) for b in layer["b1"]] == [(ff // 2,)] * 2
        assert [tuple(w.shape) for w in layer["w2"]] == [(ff // 2, d)] * 2
        assert tuple(layer["b2"].shape) == (d,)
    assert tuple(sharded["pos"].shape) == (pc.max_len, d)
    # every leaf its own storage: no shard is a view of the whole
    ptrs = [t.untyped_storage().data_ptr() for t in seq.tensors(sharded)]
    assert len(set(ptrs)) == len(ptrs)
    back = seq.gather_tsp_params(sharded)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))


def test_shards_live_on_their_ranks(monkeypatch):
    """Each shard is placed on the rank with its coordinates (0 on the
    other axes), replicated leaves on the first rank: recorded on a mesh
    whose ranks are labelled 0..3 over ``(dp, tp, sp, ep) = (1, 2, 1, 2)``."""
    _, pc = _configs(num_experts=4)
    params = seq.init_tsp_params(torch.Generator().manual_seed(8), pc, device="cpu")
    mesh = _port_mesh((1, 2, 1, 2))
    mesh.devices = np.arange(4).reshape(1, 2, 1, 2).astype(object)
    seen = []
    place = seq.placed
    monkeypatch.setattr(seq, "placed", lambda t, rank: (seen.append(int(rank)),
                                                        place(t, "cpu"))[1])
    sharded = seq.shard_tsp_params(params, mesh)
    assert len(seen) == len(seq.tensors(sharded))
    # in tree order: in_proj, pos, head, lnf (2 leaves), then the first layer
    assert seen[:5] == [0] * 5
    ranks, i = {}, 5
    for name, leaf in sharded["layers"][0].items():
        n = len(seq.tensors(leaf))
        ranks[name], i = seen[i:i + n], i + n
    assert ranks["wqkv"] == ranks["wo"] == [0, 2]                         # (0, t, 0, 0)
    assert ranks["w1e"] == ranks["b1e"] == ranks["w2e"] == [0, 2, 1, 3]  # (0, t, 0, e)
    assert ranks["b2e"] == [0, 1]                                          # (0, 0, 0, e)
    assert ranks["wg"] == [0] and ranks["ln1"] == [0, 0]  # replicated: the first rank


def test_interop_round_trip_and_float32():
    jc, _ = _configs(num_experts=4)
    params = jseq.init_tsp_params(jax.random.PRNGKey(9), jc)
    assert np.asarray(params["lnf"]["scale"]).dtype == np.float64  # the platform's x64
    port = interop.tsp_params_from_jax(params, "cpu")
    assert all(t.dtype == torch.float32 for t in seq.tensors(port))
    back = interop.tsp_params_to_jax(port)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, params))
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))


def test_init_matches_jax_shapes_and_scales():
    """The same tree, shapes and scales as JAX's draw (another generator,
    so other values)."""
    for experts in (0, 4):
        jc, pc = _configs(num_experts=experts, num_features=16, d_model=64, max_len=2048)
        want = jseq.init_tsp_params(jax.random.PRNGKey(0), jc)
        got = seq.gather_tsp_params(
            seq.init_tsp_params(torch.Generator().manual_seed(0), pc, device="cpu"))
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, want)))
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == np.float32
            if w.std() == 0:  # the norms' ones and the biases' zeros
                np.testing.assert_array_equal(g, w)
                continue
            # both zero-mean normals of one scale: within 5 sampling sigmas
            n = w.size
            assert abs(g.mean()) <= 5 * w.std() / np.sqrt(n)
            np.testing.assert_allclose(g.std(), w.std(), rtol=5 / np.sqrt(2 * n))


def test_config_defaults_and_refusals():
    cfg = seq.TSPConfig()
    want = jseq.TSPConfig()
    for key in ("num_features", "num_classes", "d_model", "num_heads", "num_layers", "d_ff",
                "max_len", "causal", "num_experts", "capacity_factor", "moe_aux_weight",
                "head_dim"):
        assert getattr(cfg, key) == getattr(want, key), key
    assert cfg.dtype is torch.float32
    with pytest.raises(ValueError, match="JAX package option"):
        seq.TSPConfig(attn_impl="pallas")
    with pytest.raises(ValueError, match="torch.dtype"):
        seq.TSPConfig(dtype=np.float32)


def test_mesh_axis_through_a_coordinate_of_the_other_axes():
    """``Mesh.axis`` of an N-D mesh: the ranks of one axis through the
    other axes' coordinates, in axis order (ranks labelled by position)."""
    def labelled(n, shape):
        arr = np.empty(n, dtype=object)
        arr[:] = [torch.device("cpu", i) for i in range(n)]
        return arr.reshape(shape)

    mesh = _port_mesh((2, 2, 2, 2))
    mesh.devices = labelled(16, (2, 2, 2, 2))

    def ranks(axis):
        return [d.index for d in axis.devices]

    assert ranks(mesh.axis("sp", (1, 0, 1))) == [9, 11]  # devices[1, 0, :, 1]
    assert ranks(mesh.axis("dp", (1, 1, 0))) == [6, 14]  # devices[:, 1, 1, 0]
    assert ranks(mesh.axis("ep", (0, 1, 1))) == [6, 7]
    with pytest.raises(ValueError, match="other 3 axes"):
        mesh.axis("sp", 1)
    grid = seq.build_mesh((2, 3), ("pp", "dp"), ["cpu"] * 6)
    grid.devices = labelled(6, (2, 3))
    assert ranks(grid.axis("dp", 1)) == [3, 4, 5]  # a 2-D mesh's row, as before
    assert ranks(grid.axis("pp", 2)) == [2, 5]


def test_mesh_building_and_refusals(monkeypatch):
    mesh = seq.build_tsp_mesh(2, 1, 2, 1, devices=["cpu"] * 5)
    assert mesh.shape == {"dp": 2, "tp": 1, "sp": 2, "ep": 1}
    assert [str(d) for d in mesh.axis("sp", (1, 0, 0)).devices] == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        seq.build_tsp_mesh(2, 2, 2, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        seq.build_tsp_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        seq.build_tsp_mesh(devices=["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        seq.init_tsp_params(torch.Generator(), seq.TSPConfig())
    # a sharded leaf must be split as the mesh splits it
    _, pc = _configs()
    whole = seq.init_tsp_params(torch.Generator().manual_seed(0), pc, device="cpu")
    m2 = _port_mesh((1, 2, 1, 1))
    with pytest.raises(ValueError, match="shard_tsp_params"):
        seq.tsp_forward(seq.shard_tsp_params(whole, _port_mesh((1, 1, 1, 1))),
                        _data(pc)[0], pc, m2)
    # one process only
    from coinstac_dinunet_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod.torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh_mod.torch.distributed, "get_rank", lambda: 0)
    monkeypatch.setattr(mesh_mod.torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1: the sharded "
                                                  "transformer steps across processes"):
        seq.build_tsp_mesh(devices=["cpu"])
