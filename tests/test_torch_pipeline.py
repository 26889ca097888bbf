"""The port's GPipe step (``coinstac_dinunet_tpu_torch/parallel/
pipeline.py``) against the JAX package's ``parallel/pipeline.py`` on the
same numpy inputs and weights.

JAX runs on the test platform's forced CPU devices (pp at most 2: its pp 4
step takes seconds to compile); the port on ``["cpu"] * n`` ranks with the
kernels' plain versions (head dim 8).  Tolerances: a step's loss and every
updated leaf within 2e-5 of JAX's (float32; JAX's tree carries float64
norms under the platform's x64, cast by ``interop.tsp_params_from_jax``),
and of the port's own pp 1 run for the pipeline invariances JAX's tests
state (its ``rtol`` 1e-5 on the loss).
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.parallel import pipeline as jpp
from coinstac_dinunet_tpu.parallel import sequence as jseq
from coinstac_dinunet_tpu_torch import interop
from coinstac_dinunet_tpu_torch.parallel import pipeline as pp
from coinstac_dinunet_tpu_torch.parallel import sequence as seq

fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

ATOL = 2e-5
LOSS_RTOL = 1e-5


def _configs(layers=2, **kw):
    kw = dict(num_features=8, num_classes=2, d_model=32, num_heads=4, num_layers=layers,
              max_len=64, causal=True, **kw)
    return jseq.TSPConfig(**kw), seq.TSPConfig(**kw)


def _data(cfg, b=8, t=16, seed=0):
    """JAX's test recipe: a label-dependent sine under noise."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, cfg.num_classes, size=b).astype(np.int32)
    sig = np.sin(2 * np.pi * (y[:, None, None] + 1) * np.arange(t)[None, :, None] / t)
    x = (rng.normal(size=(b, t, cfg.num_features)) * 0.3 + sig).astype(np.float32)
    return x, y


def _port_step(params, x, y, cfg, pp_size, dp, m, lr=1e-2, donate=False):
    """One port step from a whole stacked tree: (updated whole tree, loss)."""
    mesh = pp.build_pp_mesh(pp_size, dp, devices=["cpu"] * (pp_size * dp))
    step = pp.make_pp_train_step(cfg, mesh, lr=lr, num_microbatches=m, donate=donate)
    new, loss = step(pp.shard_pp_params(params, mesh), x, y)
    return pp.gather_pp_params(new), float(loss)


def _port_tree(seed, cfg):
    return pp.stack_layers(seq.init_tsp_params(torch.Generator().manual_seed(seed), cfg,
                                               device="cpu"))


def _close(got, want, atol=ATOL):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)


def test_pipeline_step_matches_jax():
    """pp2×dp2, M 2: loss and every updated leaf within 2e-5 of JAX's."""
    jc, pc = _configs()
    base = jpp.stack_layers(jseq.init_tsp_params(jax.random.PRNGKey(0), jc))
    x, y = _data(jc)
    mesh = jpp.build_pp_mesh(pp=2, dp=2)
    step = jpp.make_pp_train_step(jc, mesh, lr=1e-2, num_microbatches=2, donate=False)
    xs, ys = jpp.shard_pp_batch(x, y, mesh)
    want, want_loss = step(jpp.shard_pp_params(base, mesh), xs, ys)
    got, loss = _port_step(interop.tsp_params_from_jax(base, "cpu"), x, y, pc, 2, 2, 2)
    np.testing.assert_allclose(loss, float(want_loss), rtol=0, atol=ATOL)
    _close(got, jax.tree_util.tree_map(np.asarray, want))


def test_port_pp4_matches_pp1():
    """JAX's invariance at pp 4 × dp 2 against the unpipelined pp 1, M 4
    (port only: JAX's pp 4 compile is the slow part of its own test)."""
    _, pc = _configs(layers=4)
    base = _port_tree(0, pc)
    x, y = _data(pc)
    one, loss1 = _port_step(base, x, y, pc, 1, 1, 4)
    four, loss4 = _port_step(base, x, y, pc, 4, 2, 4)
    np.testing.assert_allclose(loss4, loss1, rtol=LOSS_RTOL)
    _close(four, one)


def test_port_microbatch_counts_give_one_step():
    """M 2 and M 4 on pp 2 give the same loss and update (a smaller
    bubble, the same math)."""
    _, pc = _configs()
    base = _port_tree(2, pc)
    x, y = _data(pc)
    two, loss2 = _port_step(base, x, y, pc, 2, 1, 2)
    four, loss4 = _port_step(base, x, y, pc, 2, 1, 4)
    np.testing.assert_allclose(loss2, loss4, rtol=LOSS_RTOL)
    _close(two, four)


def test_pipeline_equals_the_tsp_step_on_one_checkpoint():
    """The two scale-out steps share the block math and the parameter tree:
    pp 2 × dp 2 equals the dp2×tp2×sp2 step (dense, no aux loss)."""
    _, pc = _configs()
    params = seq.init_tsp_params(torch.Generator().manual_seed(3), pc, device="cpu")
    x, y = _data(pc, seed=3)
    got, loss = _port_step(pp.stack_layers(params), x, y, pc, 2, 2, 2)
    mesh = seq.build_tsp_mesh(2, 2, 2, devices=["cpu"] * 8)
    new, want_loss = seq.make_tsp_train_step(pc, mesh, lr=1e-2, donate=False)(
        seq.shard_tsp_params(params, mesh), x, y)
    np.testing.assert_allclose(loss, float(want_loss), rtol=0, atol=ATOL)
    want = seq.gather_tsp_params(new)
    _close(got, pp.stack_layers(want))


def test_port_pipeline_lowers_the_loss():
    """30 steps on pp 2 × dp 2 lower the loss, as JAX's
    ``test_pipeline_learns`` does."""
    _, pc = _configs()
    mesh = pp.build_pp_mesh(2, 2, devices=["cpu"] * 4)
    params = pp.shard_pp_params(_port_tree(1, pc), mesh)
    x, y = pp.shard_pp_batch(*_data(pc, seed=1), mesh)
    step = pp.make_pp_train_step(pc, mesh, lr=5e-2, num_microbatches=2)
    losses = [float(step(params, x, y)[1]) for _ in range(30)]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0] * 0.7, losses


@pytest.mark.parametrize("pp_size,dp,m", [(1, 1, 2), (2, 2, 2), (2, 1, 4), (4, 2, 4)])
def test_flash_calls_a_step(monkeypatch, pp_size, dp, m):
    """K2, K3 and K4 each run ``dp · M · L`` times a step: the bubble's
    slots are skipped."""
    calls = {"fwd": 0, "bwd": 0}

    def counting(t, cuda_fn, plain_fn):
        calls["fwd" if plain_fn is fa.flash_forward_plain else "bwd"] += 1
        return plain_fn

    monkeypatch.setattr(fa, "_dispatch", counting)
    _, pc = _configs(layers=4)
    _port_step(_port_tree(4, pc), *_data(pc), pc, pp_size, dp, m)
    assert calls == {"fwd": dp * m * 4, "bwd": dp * m * 4}


def test_each_stage_stores_its_layers(monkeypatch):
    """Rank ``(p, 0)`` holds layers ``[p·L/pp, (p+1)·L/pp)`` of every layer
    leaf and no rank the whole stack; the rest lies once on the first rank
    (recorded on a mesh whose two stages are labelled 0 and 1)."""
    _, pc = _configs(layers=4)
    base = _port_tree(5, pc)
    mesh = pp.build_pp_mesh(2, 1, devices=["cpu"] * 2)
    mesh.devices = np.arange(2).reshape(2, 1).astype(object)
    ranks = []
    place = pp.placed
    monkeypatch.setattr(pp, "placed", lambda t, rank: (ranks.append(int(rank)),
                                                       place(t, "cpu"))[1])
    sharded = pp.shard_pp_params(base, mesh)
    n_rest = len(seq.tensors({k: v for k, v in sharded.items() if k != "layers"}))
    n_layer_leaves = len(seq.tensors(base["layers"]))
    assert ranks == [0] * n_rest + [0, 1] * n_layer_leaves
    for key in ("wqkv", "wo", "w1", "b1", "w2", "b2"):
        shards = sharded["layers"][key]
        assert [s.shape[0] for s in shards] == [2, 2]
        np.testing.assert_array_equal(torch.cat(shards).numpy(), base["layers"][key].numpy())


def test_refusals():
    jc, pc = _configs(num_experts=2)
    mesh = pp.build_pp_mesh(2, 1, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="dense-FFN"):
        pp.make_pp_train_step(pc, mesh)
    _, pc = _configs()
    params = pp.shard_pp_params(_port_tree(6, pc), mesh)
    x, y = _data(pc, b=6)
    with pytest.raises(ValueError, match="microbatches"):
        pp.make_pp_train_step(pc, mesh, num_microbatches=4)(params, x, y)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        pp.build_pp_mesh(2, 2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="pp=4 must divide"):
        pp.shard_pp_params(_port_tree(6, pc), pp.build_pp_mesh(4, 1, devices=["cpu"] * 4))
