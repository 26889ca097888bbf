"""The port's mesh plane (``parallel/mesh.py``) through ``MeshEngine``, the
site-sharded vectorized plane and ``device_prefetch(sharding=)``, against
the JAX package's ``MeshEngine`` and the port's file transport, on the CPU.

The counterparts of ``tests/test_mesh_engine.py``.  Both packages start
from the same JAX-written FSV weights (``pretrained_path``, dropout off) on
the same synthetic files; the port's ranks are ``["cpu"] * n``, the JAX
package's the test platform's forced CPU devices.  Tolerances, each with
its reason:

- logs against the JAX ``MeshEngine``: 1e-5 (float32 sums in another
  order; the logs are rounded to 5 decimals), final parameters 1e-4 (the
  issue's bound after a few Adam rounds at learning rate 5e-2);
- against the port's own file transport: 2e-3, the JAX package's
  tolerance between its mesh and file transports (the file wire reduces
  per-site gradients through its payload files);
- ``devices_per_site`` 2 against 1, ``site_shards`` 2 and 4 against 1, a
  zero-sample site against a run without it: 1e-6 (one reduction order
  against another, float32).
"""
import os

import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu_torch.config.keys import MeshAxis
from coinstac_dinunet_tpu_torch.data import device_prefetch
from coinstac_dinunet_tpu_torch.engine import InProcessEngine, MeshEngine
from coinstac_dinunet_tpu_torch.federation import SiteVectorizedEngine
from coinstac_dinunet_tpu_torch.interop import params_to_jax
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer
from coinstac_dinunet_tpu_torch.parallel import powersgd as port_psgd
from coinstac_dinunet_tpu_torch.parallel.mesh import MeshFederation, build_site_only_mesh
from test_torch_subprocess_engine import ARGS, TASK

LOGS = ("train_log", "validation_log", "test_metrics", "global_test_metrics")
JAX_ATOL = 1e-5
PARAM_ATOL = 1e-4
FILE_ATOL = 2e-3
EXACT_ATOL = 1e-6


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX-written FSV weights both packages start from (dropout off)."""
    from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer

    path = tmp_path_factory.mktemp("mesh_weights") / "init.ckpt"
    jt = JaxFSVTrainer(cache=dict(ARGS, dropout=0.0, precision_bits=32,
                                  local_data_parallel=False))
    jt.init_nn()
    jt.save_checkpoint(full_path=str(path))
    return dict(dropout=0.0, precision_bits=32, pretrained_path=str(path))


def fill(eng, per_site):
    """``per_site`` files (an int, or a list over the sites) a site."""
    for i, s in enumerate(eng.site_ids):
        n = per_site[i] if isinstance(per_site, (list, tuple)) else per_site
        d = eng.site_data_dir(s)
        for j in range(n):
            open(os.path.join(d, f"{s}_subj{j}.txt"), "w").close()


def port_mesh(workdir, n_sites, weights, per_site=10, ranks=1, cls=MeshEngine,
              trainer_cls=FSVTrainer, **args):
    eng = cls(workdir, n_sites=n_sites, trainer_cls=trainer_cls, dataset_cls=FSVDataset,
              device="cpu", devices=["cpu"] * (n_sites * ranks), task_id=TASK,
              **{**ARGS, **weights, **args})
    fill(eng, per_site)
    return eng


def jax_mesh(workdir, n_sites, weights, per_site=10, **args):
    from coinstac_dinunet_tpu.engine import MeshEngine as JaxMesh
    from coinstac_dinunet_tpu.models import FSVDataset as JaxFSVDataset
    from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer

    eng = JaxMesh(workdir, n_sites=n_sites, trainer_cls=JaxFSVTrainer,
                  dataset_cls=JaxFSVDataset, task_id=TASK, local_data_parallel=False,
                  **{**ARGS, **weights, **args})
    fill(eng, per_site)
    return eng


def port_file(workdir, n_sites, weights, per_site=10, trainer_cls=FSVTrainer, **args):
    eng = InProcessEngine(workdir, n_sites=n_sites, trainer_cls=trainer_cls,
                          dataset_cls=FSVDataset, device="cpu", task_id=TASK,
                          **{**ARGS, **weights, **args})
    fill(eng, per_site)
    return eng


def logs(cache):
    return {k: np.asarray(cache[k], np.float64) for k in LOGS}


def assert_logs_close(ours, theirs, atol, keys=LOGS):
    for key in keys:
        got, want = logs(ours)[key], logs(theirs)[key]
        assert got.shape == want.shape, (key, got, want)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol + 1e-9, err_msg=key)


def final_params(eng):
    return [p.detach().clone() for p in eng._trainer.nn["fsv_net"].parameters()]


def assert_params_close_to_jax(ours, theirs, atol=PARAM_ATOL):
    import jax

    want = jax.tree_util.tree_leaves(theirs._trainer.train_state.params["fsv_net"])
    got = jax.tree_util.tree_leaves(params_to_jax(ours._trainer.nn["fsv_net"]))
    assert len(want) == len(got)
    gap = max(float(np.abs(np.asarray(a, np.float64) - b).max()) for a, b in zip(want, got))
    assert gap <= atol, gap


def _start_q(seed, j, ncols, rank):
    return np.random.default_rng(int(seed) * 1000 + int(j)).normal(
        size=(int(ncols), int(rank))).astype(np.float32)


# ------------------------------------------------------------- the lifecycle
def test_mesh_plane_reaches_success(tmp_path, weights):
    eng = port_mesh(tmp_path, 4, weights)
    eng.run()
    assert eng.success
    task_dir = os.path.join(eng.remote_out_dir, TASK)
    assert os.path.exists(os.path.join(task_dir, "global_test_metrics.csv"))
    fold_dir = os.path.join(task_dir, "fold_0")
    assert os.path.exists(os.path.join(fold_dir, "logs.json"))
    assert os.path.exists(os.path.join(eng.workdir, eng.results_zip))
    assert len(eng.cache["train_log"]) >= 1 and len(eng.cache["validation_log"]) >= 1
    assert any(f.startswith("best.") for f in os.listdir(fold_dir))
    assert isinstance(eng._last_fed, MeshFederation)
    assert eng._last_fed.mesh.shape == {MeshAxis.SITE: 4, MeshAxis.DEVICE: 1}


def test_mesh_plane_matches_jax_mesh_and_file_transport(tmp_path, weights):
    """4 sites of unequal size: the same logs and final parameters as the
    JAX ``MeshEngine``, and the port's file transport's logs."""
    sizes = [8, 10, 12, 14]
    ours = port_mesh(tmp_path / "port", 4, weights, per_site=sizes)
    theirs = jax_mesh(tmp_path / "jax", 4, weights, per_site=sizes)
    ours.run()
    theirs.run()
    assert ours.success and theirs.success
    assert ours._last_fed.rounds_done == theirs._last_fed.rounds_done > 3
    assert_logs_close(ours.cache, theirs.cache, JAX_ATOL)
    assert_params_close_to_jax(ours, theirs)
    serial = port_file(tmp_path / "file", 4, weights, per_site=sizes)
    serial.run(max_rounds=300)
    assert serial.success
    assert_logs_close(ours.cache, serial.remote_cache, FILE_ATOL)


def test_mesh_plane_pretrain_matches_jax_and_file_transport(tmp_path, weights):
    """The designated-site pretrain (site_1 has the most data) on the mesh:
    the JAX ``MeshEngine``'s and the file transport's logs, and the fold's
    resume point untouched by the pretrain."""
    args = {"pretrain_args": {"epochs": 2}}
    sizes = [10, 16]
    ours = port_mesh(tmp_path / "port", 2, weights, per_site=sizes, **args)
    theirs = jax_mesh(tmp_path / "jax", 2, weights, per_site=sizes, **args)
    ours.run()
    theirs.run()
    assert ours.success and theirs.success
    assert_logs_close(ours.cache, theirs.cache, JAX_ATOL)
    serial = port_file(tmp_path / "file", 2, weights, per_site=sizes, **args)
    serial.run(max_rounds=300)
    assert serial.success
    assert_logs_close(ours.cache, serial.remote_cache, FILE_ATOL)
    fold_dir = os.path.join(ours.remote_out_dir, TASK, "fold_0")
    latest = [f for f in os.listdir(fold_dir) if f.startswith("latest.")]
    assert latest, os.listdir(fold_dir)
    extra = torch.load(os.path.join(fold_dir, latest[0]), weights_only=False)["extra"]
    assert "fed" in extra and int(extra["epoch"]) >= 1


def test_mesh_plane_sparse_test_mode(tmp_path, weights):
    """``load_sparse``: per-subject test datasets and per-subject
    ``save_predictions`` with the site's own state, as on the file
    transport, whose test scores it equals."""
    calls = []

    class SparseFSVTrainer(FSVTrainer):
        def save_predictions(self, dataset, predictions):
            calls.append((len(dataset), self.state.get("clientId")))

    args = {"load_sparse": True, "save_predictions": True}
    serial = port_file(tmp_path / "file", 2, weights, per_site=12,
                       trainer_cls=SparseFSVTrainer, **args)
    serial.run(max_rounds=300)
    assert serial.success
    file_calls, calls[:] = list(calls), []
    ours = port_mesh(tmp_path / "mesh", 2, weights, per_site=12,
                     trainer_cls=SparseFSVTrainer, **args)
    ours.run()
    assert ours.success
    assert calls and all(n == 1 for n, _ in calls)
    assert len(calls) == len(file_calls)
    assert {c for _, c in calls} == {"site_0", "site_1"}
    assert_logs_close(ours.cache, serial.remote_cache, FILE_ATOL,
                      keys=("test_metrics", "global_test_metrics"))


def test_mesh_plane_kfold_rotation(tmp_path, weights):
    eng = port_mesh(tmp_path, 3, weights, per_site=12, split_ratio=None, num_folds=3,
                    epochs=1)
    eng.run()
    assert eng.success
    task_dir = os.path.join(eng.remote_out_dir, TASK)
    assert len([d for d in os.listdir(task_dir) if d.startswith("fold_")]) == 3
    assert len(eng.cache["global_test_serializable"]) == 3


def test_mesh_plane_rankdad_matches_jax_and_file_transport(tmp_path, weights):
    """rankDAD: every site's factors gathered and each layer rebuilt in the
    step, against the file transport without re-compression and the JAX
    ``MeshEngine``.  At rank 16 ≥ every captured layer's rows the
    factorization is exact, so the two packages' power-iteration start
    blocks (torch against JAX PRNG) do not show."""
    args = {"agg_engine": "rankDAD", "dad_reduction_rank": 16, "dad_recompress": False}
    sizes = [10, 12, 14]
    ours = port_mesh(tmp_path / "port", 3, weights, per_site=sizes, **args)
    ours.run()
    assert ours.success
    serial = port_file(tmp_path / "file", 3, weights, per_site=sizes, **args)
    serial.run(max_rounds=300)
    assert serial.success
    assert_logs_close(ours.cache, serial.remote_cache, FILE_ATOL)
    theirs = jax_mesh(tmp_path / "jax", 3, weights, per_site=sizes, **args)
    theirs.run()
    assert theirs.success
    assert_logs_close(ours.cache, theirs.cache, 5e-5)


def test_mesh_plane_powersgd_matches_jax_and_file_transport(tmp_path, weights, monkeypatch):
    """PowerSGD across the dSGD warm-up (``start_powerSGD_iter`` 3), both
    packages' start Qs injected from one numpy draw: the JAX
    ``MeshEngine``'s logs and parameters and the file transport's logs;
    the error feedback survives a resume round trip."""
    import jax.numpy as jnp
    from coinstac_dinunet_tpu.parallel import powersgd as jax_psgd

    monkeypatch.setattr(jax_psgd, "seeded_Q", lambda *a: jnp.asarray(_start_q(*a)))
    monkeypatch.setattr(port_psgd, "seeded_Q", lambda *a: torch.from_numpy(_start_q(*a)))
    args = {"agg_engine": "powerSGD", "matrix_approximation_rank": 2,
            "start_powerSGD_iter": 3, "epochs": 3}
    sizes = [10, 12, 14]
    ours = port_mesh(tmp_path / "port", 3, weights, per_site=sizes, **args)
    ours.run()
    theirs = jax_mesh(tmp_path / "jax", 3, weights, per_site=sizes, **args)
    theirs.run()
    assert ours.success and theirs.success
    fed = ours._last_fed
    assert fed.rounds_done > 3 and fed.comm_state
    assert_logs_close(ours.cache, theirs.cache, JAX_ATOL)
    assert_params_close_to_jax(ours, theirs)
    serial = port_file(tmp_path / "file", 3, weights, per_site=sizes, **args)
    serial.run(max_rounds=400)
    assert serial.success
    assert_logs_close(ours.cache, serial.remote_cache, FILE_ATOL)
    snap = fed.serialize_comm_state()
    assert snap["comm"]["errors"][0].shape[0] == 3
    again = MeshFederation(fed.trainer, 3, agg_engine="powerSGD", devices=["cpu"] * 3)
    again.restore_comm_state(snap)
    assert again.rounds_done == fed.rounds_done
    for key in ("errors", "qs"):
        for s in range(3):
            for a, b in zip(again.comm_state[key][s], fed.comm_state[key][s]):
                assert torch.equal(a, b)


def test_mesh_plane_zero_sample_site(tmp_path, weights):
    """A site without data rides fully masked placeholder batches, leaves
    the gradient mean's denominator, and the run equals one without it."""
    eng = port_mesh(tmp_path / "with_empty", 4, weights, per_site=[10, 12, 14, 0])
    eng.run()
    ref = port_mesh(tmp_path / "ref", 3, weights, per_site=[10, 12, 14])
    ref.run()
    assert eng.success and ref.success
    assert_logs_close(eng.cache, ref.cache, EXACT_ATOL)


def test_mesh_federation_rejects_unknown_engine():
    with pytest.raises(ValueError, match="not supported on the mesh"):
        MeshFederation(None, n_sites=2, agg_engine="bogusEngine")


def test_mesh_plane_accepts_full_engine_surface(tmp_path, weights):
    """Pretrain broadcast, sparse test mode and an explicit rank layout
    construct on the mesh; too few devices, and a card that is not there,
    raise when the fold builds its plane."""
    MeshEngine(tmp_path / "a", n_sites=2, device="cpu", pretrain_args={"epochs": 2})
    MeshEngine(tmp_path / "b", n_sites=2, device="cpu", load_sparse=True)
    MeshEngine(tmp_path / "c", n_sites=2, device="cpu", devices=["cpu"] * 4,
               devices_per_site=2)
    for tag, devices, err in (("few", ["cpu"], "Mesh needs 2 devices"),
                              ("none", None, "devices=\\['cpu'\\] \\* n"),
                              ("card", ["cuda:0"] * 2, "no CUDA device")):
        eng = MeshEngine(tmp_path / tag, n_sites=2, trainer_cls=FSVTrainer,
                         dataset_cls=FSVDataset, device="cpu", devices=devices,
                         task_id=TASK, **{**ARGS, **weights})
        fill(eng, 6)
        with pytest.raises((ValueError, RuntimeError), match=err):
            eng.run()


# ------------------------------------------------------------- rank layouts
def test_devices_per_site_two_matches_one_and_ranks_share_the_state(tmp_path, weights):
    """Two ``device`` ranks a site (the batch split over them, the
    mask-weighted mean of their gradients) equal one rank a site; every
    rank reads the one train state, bit for bit."""
    sizes = [9, 10, 13]  # odd splits: padded tails split unevenly over the ranks
    one = port_mesh(tmp_path / "one", 3, weights, per_site=sizes)
    two = port_mesh(tmp_path / "two", 3, weights, per_site=sizes, ranks=2,
                    devices_per_site=2)
    one.run()
    two.run()
    assert one.success and two.success
    assert two._last_fed.mesh.shape == {MeshAxis.SITE: 3, MeshAxis.DEVICE: 2}
    assert_logs_close(two.cache, one.cache, EXACT_ATOL)
    for a, b in zip(final_params(two), final_params(one)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=EXACT_ATOL)
    fed = two._last_fed
    net = fed.trainer.nn["fsv_net"]
    for dev in fed.mesh.devices.ravel():
        for p in net.parameters():
            assert torch.equal(p.to(dev), p)


@pytest.mark.parametrize("engine", ["dSGD", "rankDAD"])
def test_sites_on_another_device_read_the_models_there(tmp_path, weights, monkeypatch,
                                                        engine):
    """Every forward of a site whose device is not the trainer's runs with
    the models read on the site's device (``on_rank_device``), rankDAD's
    capture too, and the run equals the one on the trainer's device.  The
    CPU stands in for a second card: ``same_device`` is made to answer no."""
    from coinstac_dinunet_tpu_torch.parallel import mesh as mesh_mod

    sizes = [9, 10, 13]
    args = {"agg_engine": engine, "dad_reduction_rank": 16, "dad_recompress": False}
    ref = port_mesh(tmp_path / "ref", 3, weights, per_site=sizes, **args)
    ref.run()
    seen = []
    plain_iteration = FSVTrainer.iteration

    def iteration(self, batch, generator=None):
        seen.append(isinstance(self.nn["fsv_net"], mesh_mod._DeviceView))
        return plain_iteration(self, batch, generator)

    monkeypatch.setattr(FSVTrainer, "iteration", iteration)
    monkeypatch.setattr(mesh_mod, "same_device", lambda a, b: False)
    moved = port_mesh(tmp_path / "moved", 3, weights, per_site=sizes, **args)
    moved.run()
    assert ref.success and moved.success
    assert seen and all(seen)
    assert_logs_close(moved.cache, ref.cache, EXACT_ATOL)
    for a, b in zip(final_params(moved), final_params(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=EXACT_ATOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_site_shards_match_one_shard_and_the_jax_sharded_plane(tmp_path, weights, shards):
    """The site-vectorized plane with its site axis in 2 or 4 shards (each
    folded on its own rank) equals the unsharded plane, and the JAX
    package's plane sharded the same way."""
    from coinstac_dinunet_tpu.federation import SiteVectorizedEngine as JaxVec
    from coinstac_dinunet_tpu.models import FSVDataset as JaxFSVDataset
    from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer

    sizes = [8, 10, 12, 14]

    def vec(tag, n_shards):
        eng = SiteVectorizedEngine(tmp_path / tag, n_sites=4, trainer_cls=FSVTrainer,
                                   dataset_cls=FSVDataset, device="cpu",
                                   devices=["cpu"] * n_shards, site_shards=n_shards,
                                   task_id=TASK, **{**ARGS, **weights})
        fill(eng, sizes)
        eng.run()
        assert eng.success
        return eng

    one, many = vec("one", 1), vec("many", shards)
    assert many._last_fed.shards == shards
    assert_logs_close(many.cache, one.cache, EXACT_ATOL)
    for a, b in zip(final_params(many), final_params(one)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=EXACT_ATOL)
    theirs = JaxVec(tmp_path / "jax", n_sites=4, trainer_cls=JaxFSVTrainer,
                    dataset_cls=JaxFSVDataset, task_id=TASK, local_data_parallel=False,
                    site_shards=shards, **{**ARGS, **weights})
    fill(theirs, sizes)
    theirs.run()
    assert theirs.success and theirs._last_fed.shards == shards
    assert_logs_close(many.cache, theirs.cache, JAX_ATOL)


def test_device_prefetch_sharding_matches_the_unsharded_batches():
    """``sharding=(mesh, axis)`` splits every batch over the axis's ranks
    (rank r's rows on its device); the parts put together are the batches
    the prefetch gives without it, and the vectorized plane's per-shard
    folds take the same rows."""
    rng = np.random.default_rng(0)
    host = [{"inputs": rng.normal(size=(8, 3)).astype(np.float32),
             "labels": rng.integers(0, 2, 8).astype(np.int32),
             "_mask": np.ones(8, np.float32)} for _ in range(5)]
    mesh = build_site_only_mesh(4, ["cpu"] * 4)
    plain = list(device_prefetch(iter(host), size=2, device="cpu"))
    sharded = list(device_prefetch(iter(host), size=2, sharding=(mesh, MeshAxis.SITE)))
    assert len(sharded) == len(plain) == 5
    for parts, whole in zip(sharded, plain):
        assert len(parts) == 4 and all(p["inputs"].shape[0] == 2 for p in parts)
        for key in whole:
            assert torch.equal(torch.cat([p[key] for p in parts]), whole[key])
    with pytest.raises(ValueError, match="does not split"):
        next(device_prefetch(iter([{"x": np.zeros(6)}]), size=2,
                             sharding=(mesh, MeshAxis.SITE)))
