"""The pretrained-weights broadcast in the port: wire checkpoints in the JAX
package's msgpack format (``utils/flax_msgpack.py``), the aggregator's
broadcast and the sites' load.

- A checkpoint the JAX package writes (``save_checkpoint``, and a tree
  ``flax.serialization.msgpack_serialize`` packs with bfloat16 arrays,
  numpy scalars and chunked arrays) reads into the port: parameters
  equal, values exact.
- A checkpoint the port writes is byte for byte what flax packs for the
  same tree, and the JAX ``load_checkpoint(..., allow_torch=False)`` loads
  it with equal parameters.
- A torch pickle offered as a broadcast is refused.
- Round by round against the JAX engine (FSV MLP, 2 sites, a 2-epoch
  pretrain, the port from the JAX initial weights, dropout off): the same
  outputs and parameters within 1e-5 after every round.
- A port federation with ``pretrain_args={"epochs": 2}`` reaches SUCCESS
  with ``pretrained_*`` in every site's base directory, and right after the
  load every site's parameters equal the broadcast weights bit for bit.
"""
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer
from coinstac_dinunet_tpu_torch import InProcessEngine
from coinstac_dinunet_tpu_torch.interop import params_from_jax, params_to_jax
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer
from coinstac_dinunet_tpu_torch.nn.basetrainer import WIRE_CHECKPOINT_SOURCE
from coinstac_dinunet_tpu_torch.utils import flax_msgpack

CACHE = dict(num_classes=2, seed=4, compute_dtype="float32", hidden_sizes=[32, 16])


def _jax_trainer():
    t = JaxFSVTrainer(cache=dict(CACHE, local_data_parallel=False))
    t.init_nn()
    return t


def _port_trainer(tmp_path):
    t = FSVTrainer(cache=dict(CACHE, log_dir=str(tmp_path / "logs")), device="cpu")
    t.init_nn()
    return t


def _port_params(trainer):
    return {n: params_to_jax(m) for n, m in trainer.nn.items()}


def _assert_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))


def test_jax_written_checkpoint_loads_into_the_port(tmp_path):
    jt = _jax_trainer()
    path = str(tmp_path / "jax.ckpt")
    jt.save_checkpoint(full_path=path)  # models, step, rng and optimizers
    pt = _port_trainer(tmp_path)
    pt.load_checkpoint(full_path=path, load_optimizer=False, allow_torch=False)
    want = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.train_state.params))
    _assert_trees_equal(_port_params(pt), want)
    net = pt.nn["fsv_net"]
    for k, v in params_from_jax(want["fsv_net"], net).items():
        torch.testing.assert_close(net.get_parameter(k).detach(), v, rtol=0, atol=0)
    assert pt.step == int(jt.train_state.step)


def test_bfloat16_and_numpy_scalars_decode():
    bf = jnp.asarray([1.5, -2.25, 3e-3, 65504.0], jnp.bfloat16)
    tree = {"bf": np.asarray(bf), "f32": np.float32(0.1), "u32": np.uint32(7),
            "i64": np.int64(-9), "big": np.arange(300, dtype=np.int16), "step": 12,
            "name": "x" * 40, "nested": {"b": b"\x00\x01", "none": None, "flag": True}}
    back = flax_msgpack.restore(flax.serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(back["bf"], np.asarray(bf, np.float32))
    assert back["bf"].dtype == np.float32
    assert back["f32"] == np.float32(0.1) and back["f32"].dtype == np.float32
    assert back["u32"] == 7 and back["u32"].dtype == np.uint32
    assert back["i64"] == -9 and back["i64"].dtype == np.int64
    np.testing.assert_array_equal(back["big"], tree["big"])
    assert back["step"] == 12 and back["name"] == tree["name"]
    assert back["nested"] == {"b": b"\x00\x01", "none": None, "flag": True}
    # the port writes what flax writes, maps sorted, numpy scalars as ext 3
    del tree["bf"]
    assert flax_msgpack.serialize(tree) == flax.serialization.msgpack_serialize(tree)


def test_chunked_arrays_are_read(monkeypatch):
    """flax splits an array over 2^30 bytes into a map of chunks; the port
    reads it back whole (the limit lowered so a small array takes that
    form) and refuses to write one."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 16)
    a = np.arange(10, dtype=np.float32)
    back = flax_msgpack.restore(flax.serialization.msgpack_serialize({"a": a, "b": a[:2]}))
    np.testing.assert_array_equal(back["a"], a)
    np.testing.assert_array_equal(back["b"], a[:2])
    with pytest.raises(ValueError, match="limit"):
        flax_msgpack.serialize({"a": a})


def test_port_written_checkpoint_loads_through_jax(tmp_path):
    pt = _port_trainer(tmp_path)
    pt.step = 5
    path = str(tmp_path / "port.ckpt")
    pt.save_wire_checkpoint(path)
    with open(path, "rb") as f:
        data = f.read()
    restored = flax.serialization.msgpack_restore(data)
    assert restored["source"] == WIRE_CHECKPOINT_SOURCE == "coinstac-dinunet-tpu"
    assert restored["step"] == 5
    assert flax.serialization.msgpack_serialize(restored) == data
    jt = _jax_trainer()
    jt.load_checkpoint(full_path=path, load_optimizer=False, allow_torch=False)
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, jax.device_get(jt.train_state.params)),
                        _port_params(pt))


def test_torch_pickle_broadcast_is_refused(tmp_path):
    pt = _port_trainer(tmp_path)
    path = pt.save_checkpoint(name="local.ckpt")  # a torch.save payload
    with pytest.raises(RuntimeError, match="torch checkpoint"):
        pt.load_checkpoint(full_path=path, load_optimizer=False, allow_torch=False)
    pt.load_checkpoint(full_path=path)  # a local file may be one


class _PortFromJaxWeights(FSVTrainer):
    """Initialized from the JAX package's initial weights."""

    jax_init = None

    def _init_nn_weights(self):
        super()._init_nn_weights()
        net = self.nn["fsv_net"]
        net.load_state_dict(params_from_jax(self.jax_init, net))


def test_pretrain_rounds_match_jax_engine(tmp_path):
    """The JAX engine and the port's, round by round, with a 2-epoch local
    pretrain and its broadcast: the same output keys, phases and modes,
    the same broadcast file name, parameters within 1e-5 after every round
    (the port starts from the JAX initial weights; dropout off)."""
    from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
    from coinstac_dinunet_tpu.models import FSVDataset as JaxFSVDataset

    args = dict(CACHE, data_dir="data", synthetic=True, batch_size=4, epochs=2,
                split_ratio=[0.5, 0.25, 0.25], patience=100, dropout=0.0,
                pretrain_args={"epochs": 2}, precision_bits=32)
    jt = JaxFSVTrainer(cache=dict(args, local_data_parallel=False))
    jt.init_nn()
    _PortFromJaxWeights.jax_init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jt.train_state.params["fsv_net"])
    jeng = JaxEngine(tmp_path / "jax", n_sites=2, trainer_cls=JaxFSVTrainer,
                     dataset_cls=JaxFSVDataset, local_data_parallel=False, **args)
    peng = InProcessEngine(tmp_path / "port", n_sites=2, trainer_cls=_PortFromJaxWeights,
                           dataset_cls=FSVDataset, device="cpu", **args)
    _provision(jeng)
    _provision(peng)

    def shape(out):
        return (sorted(out), out.get("phase"), out.get("mode"), out.get("global_modes"),
                out.get("pretrained_weights"))

    compared = 0
    while not jeng.success:
        assert jeng.rounds < 40
        j_sites, j_remote = jeng.step_round()
        p_sites, p_remote = peng.step_round()
        assert shape(p_remote) == shape(j_remote), jeng.rounds
        for s in jeng.site_ids:
            assert shape(p_sites[s]) == shape(j_sites[s]), (jeng.rounds, s)
            j_ts = jeng.site_caches[s].get("_train_state")
            p_ts = peng.site_caches[s].get("_train_state")
            if j_ts is None or p_ts is None:
                continue
            want = jax.tree_util.tree_leaves(j_ts.params["fsv_net"])
            got = jax.tree_util.tree_leaves(params_to_jax(p_ts.nn["fsv_net"]))
            gap = max(np.abs(np.asarray(a) - b).max() for a, b in zip(want, got))
            assert gap <= 1e-5, (jeng.rounds, s, gap)
            compared += 1
    assert peng.success and peng.rounds == jeng.rounds
    assert compared >= 2 * 8


def _provision(eng):
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        # site_0 holds the most training data: the designated pretrainer
        for i in range(16 if s == "site_0" else 12):
            open(os.path.join(d, f"{s}_subject_{i:02d}"), "w").close()


def test_pretrain_federation_broadcasts_and_reaches_success(tmp_path):
    eng = InProcessEngine(tmp_path, n_sites=3, trainer_cls=FSVTrainer, dataset_cls=FSVDataset,
                          device="cpu", data_dir="data", synthetic=True, batch_size=4,
                          epochs=2, split_ratio=[0.5, 0.25, 0.25], patience=100,
                          pretrain_args={"epochs": 2}, **CACHE)
    _provision(eng)
    loaded = False
    while not eng.success:
        assert eng.rounds < 40
        broadcast = eng.site_inputs["site_1"].get("pretrained_weights")
        eng.step_round()
        if broadcast:
            loaded = True
            for s in eng.site_ids:
                with open(os.path.join(eng.site_states[s]["baseDirectory"], broadcast), "rb") as f:
                    want = flax_msgpack.restore(f.read())["models"]
                _assert_trees_equal(_port_params(eng.site_caches[s]["_train_state"]), want)
    assert loaded and eng.success
    assert eng.site_caches["site_0"]["pretrain"] is True
    for s in eng.site_ids:
        names = os.listdir(eng.site_states[s]["baseDirectory"])
        assert any(n.startswith("pretrained_") for n in names), names
    csv = tmp_path / "remote_out" / "task" / "global_test_metrics.csv"
    assert all(np.isfinite(float(v)) for v in open(csv).read().strip().splitlines()[1].split(","))
