"""Tensor parallelism in the port's federated stack (``parallel/tp_mesh.py``,
``TPDense.ranks`` and ``SeqClassifier.ranks`` with ``tp_axis``): the
counterparts of ``tests/test_tp_mesh.py``, each also held to the JAX
package.  Setup and tolerances as ``tests/test_torch_seq_mesh.py``'s:
logits 1e-5, gradients ``2e-4 + 1e-3·|g|``, tp = 2 against tp = 1 2e-3 on
the logs, against the JAX ``MeshEngine`` at the same tp 1e-5; ``TPDense``
against a dense layer 1e-6 (one float32 product against another).
"""
import numpy as np
import pytest
import torch
from torch import nn

from coinstac_dinunet_tpu_torch.engine import MeshEngine
from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset
from coinstac_dinunet_tpu_torch.models.transformer import TPDense
from coinstac_dinunet_tpu_torch.parallel import powersgd as port_psgd
from coinstac_dinunet_tpu_torch.parallel.mesh import RankAxis
from test_torch_seq_mesh import (  # noqa: F401 — the module fixture
    GRAD_TOL, JAX_ATOL, SEQ_ARGS, SP_ATOL, assert_logs_close, fill_sites, jax_engine,
    jax_model_and_params, port_engine, port_model, port_rank_grads, seq_weights, start_q,
)


def test_tpdense_matches_dense_and_its_rank_slices():
    """``TPDense`` is a dense layer (the flax ``TPDense``'s function on the
    same kernel), and its column (grouped) and row forms over 2 ranks
    assemble the same output."""
    import jax.numpy as jnp
    from coinstac_dinunet_tpu.models.transformer import TPDense as JaxTPDense

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 12)).astype(np.float32))
    for mode, groups in (("col", 1), ("col", 3), ("row", 1)):
        m = TPDense(12, 12, mode=mode, groups=groups)
        with torch.no_grad():
            m.bias.normal_()
        ref = nn.Linear(12, 12)
        ref.load_state_dict(m.state_dict())
        np.testing.assert_allclose(m(x).detach().numpy(), ref(x).detach().numpy(), atol=1e-6)
        params = {"params": {"kernel": m.weight.detach().numpy().T,
                             "bias": m.bias.detach().numpy()}}
        want = JaxTPDense(12, mode=mode, groups=groups).apply(params, jnp.asarray(x.numpy()))
        np.testing.assert_allclose(m(x).detach().numpy(), np.asarray(want), atol=1e-6)
        axis = RankAxis("tp", ["cpu"] * 2)
        if mode == "col":
            outs = m.ranks([x, x], axis)
            # rank r holds its column block of each group
            got = torch.cat([o.view(4, groups, -1) for o in outs], dim=2).reshape(4, 12)
        else:
            outs = m.ranks(list(x.chunk(2, dim=1)), axis)
            assert torch.equal(outs[0], outs[1])
            got = outs[0]
        np.testing.assert_allclose(got.detach().numpy(), ref(x).detach().numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="must divide the per-group features"):
        TPDense(12, 12, groups=3).ranks([x] * 3, RankAxis("tp", ["cpu"] * 3))
    with pytest.raises(ValueError, match="unknown TPDense mode"):
        TPDense(4, 4, mode="diagonal")


def test_tp_model_matches_unsharded_and_the_flax_model():
    """``SeqClassifier.ranks`` over tp = 2 and 4 ranks (head sharding, the
    grouped qkv slice, the MLP column/row pair) computes the plain model's
    function and gradients, and the flax model's under ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from coinstac_dinunet_tpu.utils.jax_compat import shard_map

    B, T, F = 4, 32, 8
    x = np.random.default_rng(0).normal(size=(B, T, F)).astype(np.float32)
    for tp in (2, 4):
        jmodel, params = jax_model_and_params(64, x, tp_axis="tp")
        model = port_model(params, 64, F)
        xt = torch.from_numpy(x)
        model.zero_grad()
        plain = model(xt)
        (plain ** 2).sum().backward()
        gref = {k: p.grad.clone() for k, p in model.named_parameters()}
        out, gtp = port_rank_grads(model, [xt] * tp, tp_axis=RankAxis("tp", ["cpu"] * tp))
        np.testing.assert_allclose(out, plain.detach().numpy(), atol=1e-5)
        for k in gref:
            np.testing.assert_allclose(gtp[k].numpy(), gref[k].numpy(), err_msg=k, **GRAD_TOL)
        mesh = Mesh(np.array(jax.devices()[:tp]), ("tp",))
        jout = jax.jit(shard_map(lambda p, xx: jmodel.apply(p, xx), mesh=mesh,
                                 in_specs=(P(), P()), out_specs=P(),
                                 check_vma=False))(params, jnp.asarray(x))
        np.testing.assert_allclose(out, np.asarray(jout), atol=1e-5)

        def tp_grads(p, xx):
            g = jax.grad(lambda q: jnp.sum(jmodel.apply(q, xx) ** 2))(p)
            return jax.tree_util.tree_map(lambda a: jax.lax.pmean(a, "tp"), g)

        jg = jax.jit(shard_map(tp_grads, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                               check_vma=False))(params, jnp.asarray(x))
        for k, p in port_model(jg, 64, F).named_parameters():
            np.testing.assert_allclose(gtp[k].numpy(), p.detach().numpy(), err_msg=k,
                                       **GRAD_TOL)
    with pytest.raises(ValueError, match="must divide num_heads"):
        model.ranks([xt] * 8, tp_axis=RankAxis("tp", ["cpu"] * 8))


def test_mesh_engine_tp2_matches_tp1_and_the_jax_tp2_plane(tmp_path, seq_weights):
    e1 = port_engine(tmp_path, "tp1", seq_weights, tensor_parallel=1)
    e2 = port_engine(tmp_path, "tp2", seq_weights, ranks=2, tensor_parallel=2)
    assert e2._last_fed.mesh.shape == {"site": 2, "tp": 2}
    assert_logs_close(e2, e1, SP_ATOL)
    theirs = jax_engine(tmp_path, "jax_tp2", seq_weights, tensor_parallel=2)
    assert_logs_close(e2, theirs, JAX_ATOL)


def test_mesh_plane_tp_powersgd(tmp_path, seq_weights, monkeypatch):
    import jax.numpy as jnp
    from coinstac_dinunet_tpu.parallel import powersgd as jax_psgd

    monkeypatch.setattr(jax_psgd, "seeded_Q", lambda *a: jnp.asarray(start_q(*a)))
    monkeypatch.setattr(port_psgd, "seeded_Q", lambda *a: torch.from_numpy(start_q(*a)))
    extra = dict(epochs=3, agg_engine="powerSGD", start_powerSGD_iter=2,
                 matrix_approximation_rank=2)
    e1 = port_engine(tmp_path, "psgd_tp1", seq_weights, tensor_parallel=1, **extra)
    e2 = port_engine(tmp_path, "psgd_tp2", seq_weights, ranks=2, tensor_parallel=2, **extra)
    assert_logs_close(e2, e1, SP_ATOL, keys=("train_log", "validation_log"))
    theirs = jax_engine(tmp_path, "jax_psgd_tp2", seq_weights, tensor_parallel=2, **extra)
    assert_logs_close(e2, theirs, JAX_ATOL, keys=("train_log", "validation_log"))


def test_tp_requires_iteration_tp(tmp_path):
    from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer
    from test_torch_subprocess_engine import ARGS

    eng = MeshEngine(tmp_path, n_sites=2, trainer_cls=FSVTrainer, dataset_cls=FSVDataset,
                     device="cpu", devices=["cpu"] * 4, task_id="fsv",
                     **{**ARGS, "tensor_parallel": 2})
    fill_sites(eng, 10)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        eng.run()


def test_tp_and_sp_are_mutually_exclusive(tmp_path):
    """One intra-site axis: both raise when the fold builds its plane, and
    a ``devices_per_site`` that contradicts either raises too; the model
    refuses both axes at once."""
    for tag, extra, err in (("both", dict(sequence_parallel=2, tensor_parallel=2),
                             "mutually exclusive"),
                            ("sp_dps", dict(sequence_parallel=2, devices_per_site=3),
                             "conflicts with sequence_parallel"),
                            ("tp_dps", dict(tensor_parallel=2, devices_per_site=3),
                             "conflicts with tensor_parallel")):
        eng = MeshEngine(tmp_path / tag, n_sites=2, trainer_cls=SeqTrainer,
                         dataset_cls=SyntheticSeqDataset, device="cpu", devices=["cpu"] * 6,
                         **{**SEQ_ARGS, **extra})
        fill_sites(eng)
        with pytest.raises(ValueError, match=err):
            eng.run()
    model = SeqTrainer(cache=dict(SEQ_ARGS), device="cpu").init_nn().nn["seq_net"]
    axis = RankAxis("x", ["cpu"] * 2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        model.ranks([torch.zeros(1, 8, 8)] * 2, sp_axis=axis, tp_axis=axis)


def test_tp_rejects_rankdad():
    from coinstac_dinunet_tpu_torch.parallel.tp_mesh import TPMeshFederation

    t = SeqTrainer(cache=dict(SEQ_ARGS), device="cpu").init_nn()
    with pytest.raises(ValueError, match="not supported"):
        TPMeshFederation(t, 2, tp=2, agg_engine="rankDAD", devices=["cpu"] * 4)
