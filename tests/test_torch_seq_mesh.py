"""Sequence parallelism in the port's federated stack
(``parallel/seq_mesh.py``, ``SeqClassifier.ranks`` with ``sp_axis``): the
counterparts of ``tests/test_seq_mesh.py``, each also held to the JAX
package.

Both packages start from the same JAX-written transformer weights
(``pretrained_path``) on the same synthetic sequences; the port's ranks
are ``["cpu"] * n``.  Tolerances, each with its reason:

- the sp model against the plain one (port) and against the flax model
  under ``shard_map`` (JAX): logits 1e-5, gradients ``2e-4 + 1e-3·|g|``,
  the JAX package's own bound for the ``pmean``'d gradients;
- sp = 2 against sp = 1 through ``MeshEngine``: 2e-3 on the logs, the JAX
  package's bound; against the JAX ``MeshEngine`` at the same sp: 1e-5 on
  the logs (float32; the ring merges and sums in another order).
"""
import os

import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu_torch.engine import MeshEngine
from coinstac_dinunet_tpu_torch.interop import params_from_jax
from coinstac_dinunet_tpu_torch.models import SeqTrainer, SyntheticSeqDataset
from coinstac_dinunet_tpu_torch.models.transformer import SeqClassifier
from coinstac_dinunet_tpu_torch.parallel import powersgd as port_psgd
from coinstac_dinunet_tpu_torch.parallel.mesh import RankAxis

SEQ_ARGS = dict(
    task_id="seq", data_dir="data", split_ratio=[0.7, 0.15, 0.15],
    batch_size=4, epochs=2, validation_epochs=1, learning_rate=1e-3,
    seq_len=64, num_features=8, d_model=32, num_heads=4, num_layers=2,
    max_len=128, seed=11, pretrain_args={}, verbose=False, compute_dtype="float32",
)
LOGS = ("train_log", "validation_log", "test_metrics", "global_test_metrics")
MODEL = dict(d_model=32, num_heads=4, num_layers=2)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
SP_ATOL = 2e-3
JAX_ATOL = 1e-5


@pytest.fixture(scope="module")
def seq_weights(tmp_path_factory):
    """JAX-written transformer weights (float32 leaves) both packages
    start from."""
    import jax
    from coinstac_dinunet_tpu.models import SeqTrainer as JaxSeqTrainer

    path = tmp_path_factory.mktemp("seq_weights") / "init.ckpt"
    jt = JaxSeqTrainer(cache=dict(SEQ_ARGS, local_data_parallel=False, share_compiled=False))
    jt.init_nn()
    # the test platform runs JAX with x64 on: flax draws pos_embed in float64
    jt.train_state = jt.train_state.replace(params=jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jt.train_state.params))
    jt.save_checkpoint(full_path=str(path))
    return dict(pretrained_path=str(path), precision_bits=32)


def fill_sites(eng, per_site=12):
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(per_site):
            open(os.path.join(d, f"{s}_f{i}.txt"), "w").close()


def port_engine(tmp_path, tag, weights, ranks=1, **extra):
    eng = MeshEngine(tmp_path / tag, n_sites=2, trainer_cls=SeqTrainer,
                     dataset_cls=SyntheticSeqDataset, device="cpu",
                     devices=["cpu"] * (2 * ranks), **{**SEQ_ARGS, **weights, **extra})
    fill_sites(eng)
    eng.run()
    assert eng.success
    return eng


def jax_engine(tmp_path, tag, weights, **extra):
    from coinstac_dinunet_tpu.engine import MeshEngine as JaxMesh
    from coinstac_dinunet_tpu.models import SeqTrainer as JaxSeqTrainer
    from coinstac_dinunet_tpu.models import SyntheticSeqDataset as JaxSeqDataset

    eng = JaxMesh(tmp_path / tag, n_sites=2, trainer_cls=JaxSeqTrainer,
                  dataset_cls=JaxSeqDataset, local_data_parallel=False,
                  **{**SEQ_ARGS, **weights, **extra})
    fill_sites(eng)
    eng.run()
    assert eng.success
    return eng


def assert_logs_close(a, b, atol, keys=LOGS):
    for key in keys:
        x, y = np.asarray(a.cache[key], np.float64), np.asarray(b.cache[key], np.float64)
        assert x.shape == y.shape, (key, x, y)
        np.testing.assert_allclose(x, y, rtol=0, atol=atol + 1e-9, err_msg=key)


def start_q(seed, j, ncols, rank):
    return np.random.default_rng(int(seed) * 1000 + int(j)).normal(
        size=(int(ncols), int(rank))).astype(np.float32)


def jax_model_and_params(max_len, x, **axes):
    """The flax model (with ``axes``) and its float32 parameters."""
    import jax
    import jax.numpy as jnp
    from coinstac_dinunet_tpu.models.transformer import SeqClassifier as JaxSeqClassifier

    plain = JaxSeqClassifier(max_len=max_len, **MODEL)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    plain.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    return JaxSeqClassifier(max_len=max_len, **MODEL, **axes), params


def port_model(params, max_len, features):
    m = SeqClassifier(max_len=max_len, num_features=features, **MODEL)
    m.load_state_dict(params_from_jax(params, m))
    return m


def port_rank_grads(model, xs, **axes):
    """The logits on rank 0 and the gradient of the ranks' mean of
    ``Σ logits²`` (each rank's the same value: the ``pmean`` of the ranks'
    gradients)."""
    model.zero_grad()
    logits = model.ranks(xs, **axes)
    torch.stack([(lg ** 2).sum() for lg in logits]).mean().backward()
    return logits[0].detach().numpy(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_sp_model_matches_unsharded_and_the_flax_model():
    """``SeqClassifier.ranks`` over sp = 4 ranks computes the plain model's
    function and gradients, and the flax model's under ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from coinstac_dinunet_tpu.utils.jax_compat import shard_map

    B, T, F, n = 4, 64, 8, 4
    x = np.random.default_rng(0).normal(size=(B, T, F)).astype(np.float32)
    jmodel, params = jax_model_and_params(128, x, sp_axis="sp")
    model = port_model(params, 128, F)
    xt = torch.from_numpy(x)
    model.zero_grad()
    plain = model(xt)
    (plain ** 2).sum().backward()
    gref = {k: p.grad.clone() for k, p in model.named_parameters()}
    out, gsp = port_rank_grads(model, list(xt.chunk(n, dim=1)), sp_axis=RankAxis("sp", ["cpu"] * n))
    np.testing.assert_allclose(out, plain.detach().numpy(), atol=1e-5)
    for k in gref:
        np.testing.assert_allclose(gsp[k].numpy(), gref[k].numpy(), err_msg=k, **GRAD_TOL)

    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    jout = jax.jit(shard_map(lambda p, xx: jmodel.apply(p, xx), mesh=mesh,
                             in_specs=(P(), P(None, "sp", None)), out_specs=P(),
                             check_vma=False))(params, jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(jout), atol=1e-5)

    def sp_grads(p, xx):
        g = jax.grad(lambda q: jnp.sum(jmodel.apply(q, xx) ** 2))(p)
        return jax.tree_util.tree_map(lambda a: jax.lax.pmean(a, "sp"), g)

    jg = jax.jit(shard_map(sp_grads, mesh=mesh, in_specs=(P(), P(None, "sp", None)),
                           out_specs=P(), check_vma=False))(params, jnp.asarray(x))
    mine = port_model(jg, 128, F)  # the flax gradients in the port's layout
    for k, p in mine.named_parameters():
        np.testing.assert_allclose(gsp[k].numpy(), p.detach().numpy(), err_msg=k, **GRAD_TOL)
    with pytest.raises(ValueError, match="global sequence length"):
        model.ranks(list(torch.zeros(1, 160, F).chunk(2, dim=1)),
                    sp_axis=RankAxis("sp", ["cpu"] * 2))


def test_mesh_engine_sp2_matches_sp1_and_the_jax_sp2_plane(tmp_path, seq_weights):
    """``sequence_parallel`` 2 through ``MeshEngine``: the sp = 1 run's
    score trajectory, the JAX ``MeshEngine``'s at sp = 2, and a best
    checkpoint in the one parameter format."""
    e1 = port_engine(tmp_path, "sp1", seq_weights, sequence_parallel=1)
    e2 = port_engine(tmp_path, "sp2", seq_weights, ranks=2, sequence_parallel=2)
    assert e2._last_fed.mesh.shape == {"site": 2, "sp": 2}
    assert_logs_close(e2, e1, SP_ATOL)
    fold_dir = os.path.join(e2.remote_out_dir, "seq", "fold_0")
    best = [f for f in os.listdir(fold_dir) if f.startswith("best.")]
    assert best
    fresh = SeqTrainer(cache=dict(SEQ_ARGS), device="cpu").init_nn()
    fresh.load_checkpoint(full_path=os.path.join(fold_dir, best[0]))
    theirs = jax_engine(tmp_path, "jax_sp2", seq_weights, sequence_parallel=2)
    assert_logs_close(e2, theirs, JAX_ATOL)


def test_mesh_plane_sp_powersgd(tmp_path, seq_weights, monkeypatch):
    """PowerSGD's two exchanges over sp-reduced gradients: sp = 2 equals
    sp = 1 (warm-up and compressed rounds) and the JAX plane, both
    packages' start Qs injected."""
    import jax.numpy as jnp
    from coinstac_dinunet_tpu.parallel import powersgd as jax_psgd

    monkeypatch.setattr(jax_psgd, "seeded_Q", lambda *a: jnp.asarray(start_q(*a)))
    monkeypatch.setattr(port_psgd, "seeded_Q", lambda *a: torch.from_numpy(start_q(*a)))
    extra = dict(epochs=3, agg_engine="powerSGD", start_powerSGD_iter=2,
                 matrix_approximation_rank=2)
    e1 = port_engine(tmp_path, "psgd_sp1", seq_weights, sequence_parallel=1, **extra)
    e2 = port_engine(tmp_path, "psgd_sp2", seq_weights, ranks=2, sequence_parallel=2, **extra)
    assert e2._last_fed.rounds_done > 2 and e2._last_fed.comm_state
    assert_logs_close(e2, e1, SP_ATOL, keys=("train_log", "validation_log"))
    theirs = jax_engine(tmp_path, "jax_psgd_sp2", seq_weights, sequence_parallel=2, **extra)
    assert_logs_close(e2, theirs, JAX_ATOL, keys=("train_log", "validation_log"))


def test_sp_requires_iteration_sharded(tmp_path):
    """A trainer without sequence parallelism refuses it loudly, as the
    JAX package's does."""
    from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer
    from test_torch_subprocess_engine import ARGS

    eng = MeshEngine(tmp_path, n_sites=2, trainer_cls=FSVTrainer, dataset_cls=FSVDataset,
                     device="cpu", devices=["cpu"] * 4, task_id="fsv",
                     **{**ARGS, "sequence_parallel": 2})
    fill_sites(eng, 10)
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        eng.run()


def test_sp_rejects_rankdad():
    from coinstac_dinunet_tpu_torch.parallel.seq_mesh import SeqMeshFederation

    t = SeqTrainer(cache=dict(SEQ_ARGS), device="cpu").init_nn()
    with pytest.raises(ValueError, match="not supported"):
        SeqMeshFederation(t, 2, sp=2, agg_engine="rankDAD", devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="sp must be >= 1"):
        SeqMeshFederation(t, 2, sp=0, devices=["cpu"] * 4)
