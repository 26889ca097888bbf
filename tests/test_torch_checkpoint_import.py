"""The port's torch checkpoint import (``coinstac_dinunet_tpu_torch.utils.torch_import``
through ``NNTrainer.load_checkpoint``) against the JAX package's, the
cases of the JAX package's own ``tests/test_torch_import.py``: every file
here is written by ``torch.save`` from a module the test defines, and each
one is loaded into both the JAX trainer and the port trainer.

- Parameters: bit-equal after ``interop.params_to_jax`` (the JAX package
  transposes into flax's layout, the port keeps torch's; the transposes
  are exact).
- The next Adam step after an optimizer import, from the same gradient on
  both sides: parameters within 1e-6 (the same float32 arithmetic in two
  orders).
- The port pairs in the flax creation order (``interop.creation_order``);
  for every model of the port it is the JAX model's creation order.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSV
from coinstac_dinunet_tpu.models import MultiNetTrainer as JaxMultiNet
from coinstac_dinunet_tpu.models import ResNetTrainer as JaxResNet
from coinstac_dinunet_tpu.models import SeqTrainer as JaxSeq
from coinstac_dinunet_tpu.models import VBMTrainer as JaxVBM
from coinstac_dinunet_tpu.utils import torch_import as jax_import
from coinstac_dinunet_tpu_torch import interop
from coinstac_dinunet_tpu_torch.models import (FSVTrainer, MultiNetTrainer, ResNetTrainer,
                                               SeqTrainer, VBMTrainer)
from coinstac_dinunet_tpu_torch.utils import tensorutils as ttu
from coinstac_dinunet_tpu_torch.utils import torch_import

FSV = {"input_size": 66, "batch_size": 4, "num_classes": 2, "seed": 0, "learning_rate": 1e-2}


def _torch_mlp(hidden=(256, 128, 64), num_in=66, num_classes=2, seed=0):
    torch.manual_seed(seed)
    sizes = (num_in, *hidden)
    layers = []
    for a, b in zip(sizes, sizes[1:]):
        layers += [torch.nn.Linear(a, b), torch.nn.ReLU()]
    layers += [torch.nn.Linear(sizes[-1], num_classes)]
    return torch.nn.Sequential(*layers)


def _stepped(net, steps, seed=0):
    """``net`` after ``steps`` Adam steps, and the optimizer."""
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    xb = torch.from_numpy(np.random.default_rng(seed).normal(size=(8, 66)).astype(np.float32))
    for _ in range(steps):
        opt.zero_grad()
        net(xb).pow(2).sum().backward()
        opt.step()
    return opt


def _pair(tmp_path, **extra):
    """A JAX and a port FSV trainer from the same cache, both built."""
    cache = {**FSV, "log_dir": str(tmp_path), **extra}
    jt = JaxFSV(cache=dict(cache, share_compiled=False), state={}).init_nn()
    pt = FSVTrainer(cache=dict(cache), device="cpu").init_nn()
    return jt, pt


def _params_equal(jt, pt, name):
    want = jax.tree_util.tree_leaves(jax.device_get(jt.train_state.params[name]))
    got = jax.tree_util.tree_leaves(interop.params_to_jax(pt.nn[name]))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def _load_both(jt, pt, path, **kw):
    jt.load_checkpoint(full_path=str(path), **kw)
    pt.load_checkpoint(full_path=str(path), **kw)


def _jax_adam(jt, name):
    import optax

    def find(node):
        if isinstance(node, optax.ScaleByAdamState):
            return node
        if isinstance(node, tuple):
            for x in node:
                r = find(x)
                if r is not None:
                    return r
        return None

    return find(jt.train_state.opt_state[name])


# ------------------------------------------------------------- the pairing
def _jax_order(jt, name):
    return [tuple(p) for p, _ in jax_import._flatten_insertion_order(jt._params[name])]


CREATION = {
    "fsv": (JaxFSV, FSVTrainer, dict(FSV)),
    "vbm": (JaxVBM, VBMTrainer, {"input_shape": [16, 16, 16], "model_width": 4}),
    "seq": (JaxSeq, SeqTrainer, {"d_model": 32, "num_heads": 2, "num_layers": 2,
                                 "max_len": 64, "num_features": 8, "seq_len": 32}),
    "resnet": (JaxResNet, ResNetTrainer, {"input_shape": [16, 16, 3], "model_width": 4}),
    "multinet": (JaxMultiNet, MultiNetTrainer, {"input_shape": [16, 16, 16], "model_width": 4}),
}


@pytest.mark.parametrize("model", sorted(CREATION))
def test_creation_order_is_the_flax_models(model):
    """``interop.creation_order`` of every port model is the JAX model's
    creation order (its init's insertion order), leaf for leaf."""
    jcls, pcls, cache = CREATION[model]
    cache = {**cache, "seed": 0, "compute_dtype": "float32"}
    jt = jcls(cache=dict(cache, share_compiled=False, local_data_parallel=False)).init_nn()
    pt = pcls(cache=dict(cache), device="cpu").init_nn()
    assert list(jt._params) == list(pt.nn)
    for name, m in pt.nn.items():
        got = [interop.flax_path(m, p) for p in interop.creation_order(m)]
        assert got == _jax_order(jt, name), (model, name)


# ------------------------------------------------------------ the payloads
def test_coinstac_payload_loads_bit_equal(tmp_path):
    net = _torch_mlp()
    ckpt = tmp_path / "weights.tar"
    torch.save({"source": "Coinstac", "models": {"fsv_net": net.state_dict()},
                "optimizers": {}}, str(ckpt))
    jt, pt = _pair(tmp_path)
    _load_both(jt, pt, ckpt)
    _params_equal(jt, pt, "fsv_net")
    x = np.random.default_rng(1).normal(size=(8, 66)).astype(np.float32)
    pt.nn["fsv_net"].eval()
    with torch.no_grad():
        got = pt.nn["fsv_net"](torch.from_numpy(x)).numpy()
        want = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    for name, t in net.state_dict().items():  # the file's tensors, bit for bit
        layer = int(name.split(".")[0]) // 2
        key = f"layers.{layer}" if layer < 3 else "head"
        assert torch.equal(pt.nn["fsv_net"].state_dict()[f"{key}.{name.split('.')[1]}"], t)


def test_raw_state_dict_maps_to_first_model(tmp_path):
    net = _torch_mlp(seed=3)
    ckpt = tmp_path / "raw.tar"
    torch.save(net.state_dict(), str(ckpt))
    jt, pt = _pair(tmp_path)
    before = pt.nn["fsv_net"].head.weight.detach().clone()
    _load_both(jt, pt, ckpt)
    _params_equal(jt, pt, "fsv_net")
    assert not torch.equal(before, pt.nn["fsv_net"].head.weight)


def test_pretrained_path_accepts_torch_file(tmp_path):
    """``pretrained_path`` warm-starts the weights and leaves the optimizer
    fresh at step 0 in both packages, whatever the file carries."""
    net = _torch_mlp(seed=5)
    opt = _stepped(net, 2)
    ckpt = tmp_path / "weights.tar"
    torch.save({"source": "coinstac", "models": {"fsv_net": net.state_dict()},
                "optimizers": {"fsv_net": opt.state_dict()}}, str(ckpt))
    jt, pt = _pair(tmp_path, pretrained_path=str(ckpt))
    _params_equal(jt, pt, "fsv_net")
    assert int(jt.train_state.step) == pt.step == 0
    assert int(_jax_adam(jt, "fsv_net").count) == 0 and not pt.optimizer["fsv_net"].state
    b = pt._stack_batches([{"inputs": np.ones((4, 66), np.float32),
                            "labels": np.zeros(4, np.int32), "_mask": np.ones(4, np.float32)}])
    pt.train_step(b)
    assert pt.step == 1


def test_name_map_reroutes_the_pairing(tmp_path):
    """A file in an order the positional pairing would get wrong (head
    first, biases before weights) loads through ``torch_name_map``: the
    JAX package's ``/``-joined flax paths, a dict value included."""
    net = _torch_mlp(seed=9)
    sd = net.state_dict()
    names = list(sd)[::-1]
    layer_of = {0: "Dense_0", 2: "Dense_1", 4: "Dense_2", 6: "Dense_3"}
    name_map = {}
    for n in names:
        i, kind = n.split(".")
        name_map[n] = f"params/{layer_of[int(i)]}/{'kernel' if kind == 'weight' else 'bias'}"
    name_map[names[0]] = {"path": name_map[names[0]], "conv_transpose": False}
    ckpt = tmp_path / "shuffled.tar"
    torch.save({n: sd[n] for n in names}, str(ckpt))
    jt, pt = _pair(tmp_path, torch_name_map=name_map)
    _load_both(jt, pt, ckpt)
    _params_equal(jt, pt, "fsv_net")
    assert torch.equal(pt.nn["fsv_net"].head.weight, sd["6.weight"])
    # an unknown path is refused in both
    bad = dict(name_map, **{names[1]: "params/Dense_9/kernel"})
    jt, pt = _pair(tmp_path, torch_name_map=bad)
    for t in (jt, pt):
        with pytest.raises(KeyError, match="not a param path"):
            t.load_checkpoint(full_path=str(ckpt))


@pytest.mark.parametrize("hidden,match", [((32,), "(?s)torch:.*flax:"),
                                          ((256, 128, 32), "cannot convert")])
def test_mismatch_raises_with_inventory(tmp_path, hidden, match):
    """Another depth (a count mismatch: both inventories) or another width
    (a shape mismatch) aborts the load, and nothing changes."""
    ckpt = tmp_path / "bad.tar"
    torch.save(_torch_mlp(hidden=hidden).state_dict(), str(ckpt))
    jt, pt = _pair(tmp_path)
    before = interop.params_to_jax(pt.nn["fsv_net"])
    for t in (jt, pt):
        with pytest.raises(ValueError, match=match) as err:
            t.load_checkpoint(full_path=str(ckpt))
        assert "torch" in str(err.value)
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(interop.params_to_jax(pt.nn["fsv_net"]))):
        np.testing.assert_array_equal(a, b)


def test_running_statistics_are_refused_with_inventory(tmp_path):
    """A BatchNorm file: its running statistics pair against batch
    statistics, which neither package's FSV model has."""
    net = torch.nn.Sequential(torch.nn.Linear(66, 256), torch.nn.BatchNorm1d(256),
                              torch.nn.Linear(256, 128), torch.nn.Linear(128, 64),
                              torch.nn.Linear(64, 2))
    ckpt = tmp_path / "bn.tar"
    torch.save(net.state_dict(), str(ckpt))
    jt, pt = _pair(tmp_path)
    for t in (jt, pt):
        with pytest.raises(ValueError, match="running_mean"):
            t.load_checkpoint(full_path=str(ckpt))


def test_unsafe_pickle_refused_without_opt_in(tmp_path):
    ckpt = tmp_path / "evil.tar"
    torch.save({"payload": os.getcwd,
                "models": {"fsv_net": _torch_mlp(seed=43).state_dict()}}, str(ckpt))
    assert torch_import.is_torch_file(str(ckpt)) and jax_import.is_torch_file(str(ckpt))
    with pytest.raises(RuntimeError, match="allow_unsafe_torch_pickle"):
        torch_import.read_torch_file(str(ckpt))
    jt, pt = _pair(tmp_path)
    for t in (jt, pt):
        with pytest.raises(RuntimeError, match="allow_unsafe_torch_pickle"):
            t.load_checkpoint(full_path=str(ckpt))


def test_unsafe_pickle_opt_in_loads(tmp_path):
    net = _torch_mlp(seed=29)
    ckpt = tmp_path / "legacy.tar"
    torch.save({"source": "coinstac", "models": {"fsv_net": net.state_dict()},
                "extra_fn": os.getcwd}, str(ckpt))
    models, _ = torch_import.split_payload(torch_import.read_torch_file(str(ckpt),
                                                                        allow_unsafe=True))
    assert "fsv_net" in models
    jt, pt = _pair(tmp_path, allow_unsafe_torch_pickle=True)
    _load_both(jt, pt, ckpt)
    _params_equal(jt, pt, "fsv_net")


def test_broadcast_path_refuses_torch_checkpoint(tmp_path):
    ckpt = tmp_path / "broadcast.tar"
    torch.save({"source": "coinstac", "models": {"fsv_net": _torch_mlp(seed=31).state_dict()}},
               str(ckpt))
    jt, pt = _pair(tmp_path)
    for t in (jt, pt):
        with pytest.raises(RuntimeError, match="aggregator"):
            t.load_checkpoint(full_path=str(ckpt), allow_torch=False)


def test_is_torch_file_rejects_plain_zip(tmp_path):
    import zipfile

    p = tmp_path / "artifact.zip"
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("readme.txt", "not a checkpoint")
    assert not torch_import.is_torch_file(str(p)) and not jax_import.is_torch_file(str(p))
    assert not torch_import.is_torch_file(str(tmp_path / "missing.tar"))


def test_load_before_init_raises_cleanly(tmp_path):
    ckpt = tmp_path / "w.tar"
    torch.save(_torch_mlp().state_dict(), str(ckpt))
    with pytest.raises(RuntimeError, match="init_nn"):
        FSVTrainer(cache=dict(FSV), device="cpu").load_checkpoint(full_path=str(ckpt))


# ------------------------------------------------------------ the optimizer
def test_adam_graft_carries_step_and_gives_the_same_next_step(tmp_path):
    net = _torch_mlp(seed=17)
    opt = _stepped(net, 3)
    ckpt = tmp_path / "with_opt.tar"
    torch.save({"source": "coinstac", "models": {"fsv_net": net.state_dict()},
                "optimizers": {"fsv_net": opt.state_dict()}}, str(ckpt))
    jt, pt = _pair(tmp_path)
    _load_both(jt, pt, ckpt)
    _params_equal(jt, pt, "fsv_net")
    assert int(jt.train_state.step) == pt.step == 3
    assert int(_jax_adam(jt, "fsv_net").count) == 3
    # every parameter's step is the one count; the moments are the file's
    tstate = opt.state_dict()["state"]
    model = pt.nn["fsv_net"]
    for ix, pname in enumerate(interop.creation_order(model)):
        st = pt.optimizer["fsv_net"].state[model.get_parameter(pname)]
        assert float(st["step"]) == 3.0
        assert torch.equal(st["exp_avg"], tstate[ix]["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], tstate[ix]["exp_avg_sq"])
    # the next Adam step from the same gradient: the same parameters
    g = [np.random.default_rng(i).normal(size=np.shape(a)).astype(np.float32) * 1e-2
         for i, a in enumerate(jax.tree_util.tree_leaves(jt.train_state.params))]
    ts = jt.apply_grads(jt.train_state, jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jt.train_state.params), [jnp.asarray(a) for a in g]))
    pt.apply_grads(ttu.grads_like(pt.nn, g))
    want = jax.tree_util.tree_leaves(ts.params)
    got = jax.tree_util.tree_leaves(interop.params_to_jax(pt.nn["fsv_net"]))
    assert max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(want, got)) <= 1e-6
    # and it is torch's own next step for that gradient
    tg = ttu.grads_like(pt.nn, g)["fsv_net"]
    for pname, p in zip(interop.creation_order(model), net.parameters()):
        p.grad = tg[pname].clone()
    opt.step()
    for pname, p in zip(interop.creation_order(model), net.parameters()):
        assert torch.allclose(model.get_parameter(pname), p, atol=1e-7, rtol=0)


def test_divergent_per_param_steps_fall_back_fresh(tmp_path):
    net = _torch_mlp(seed=41)
    opt = _stepped(net, 4, seed=9)
    sd = opt.state_dict()
    sd["state"][0]["step"] = torch.tensor(1.0)
    ckpt = tmp_path / "divergent.tar"
    torch.save({"source": "coinstac", "models": {"fsv_net": net.state_dict()},
                "optimizers": {"fsv_net": sd}}, str(ckpt))
    jt, pt = _pair(tmp_path)
    _load_both(jt, pt, ckpt)
    _params_equal(jt, pt, "fsv_net")
    assert int(jt.train_state.step) == pt.step == 0
    assert not pt.optimizer["fsv_net"].state
    with pytest.raises(ValueError, match="disagree"):
        torch_import.convert_torch_adam_state(pt.nn["fsv_net"], sd)


def test_stateless_params_graft_with_zero_moments(tmp_path):
    net = _torch_mlp(seed=47)
    opt = _stepped(net, 4, seed=11)
    sd = opt.state_dict()
    del sd["state"][0]
    ckpt = tmp_path / "frozen.tar"
    torch.save({"source": "coinstac", "models": {"fsv_net": net.state_dict()},
                "optimizers": {"fsv_net": sd}}, str(ckpt))
    jt, pt = _pair(tmp_path)
    _load_both(jt, pt, ckpt)
    assert int(_jax_adam(jt, "fsv_net").count) == pt.step == 4
    model = pt.nn["fsv_net"]
    state = pt.optimizer["fsv_net"].state
    first, last = model.layers[0].weight, model.head.weight
    assert float(state[first]["exp_avg"].abs().max()) == 0.0 and float(state[first]["step"]) == 4
    assert float(state[last]["exp_avg"].abs().max()) > 0.0
    np.testing.assert_array_equal(
        np.asarray(_jax_adam(jt, "fsv_net").mu["params"]["Dense_3"]["kernel"]),
        interop.to_flax(model, "head.weight", state[last]["exp_avg"].numpy()))


@pytest.mark.parametrize("how", ["load_optimizer", "import_torch_optimizer", "name_map"])
def test_optimizer_opt_outs_start_fresh(tmp_path, how):
    """``load_optimizer=False``, ``import_torch_optimizer=False`` and a
    ``torch_name_map`` (the optimizer state is keyed by index) each leave
    the imported model's optimizer fresh at step 0."""
    net = _torch_mlp(seed=23)
    opt = _stepped(net, 1, seed=2)
    ckpt = tmp_path / "opt.tar"
    torch.save({"source": "coinstac", "models": {"fsv_net": net.state_dict()},
                "optimizers": {"fsv_net": opt.state_dict()}}, str(ckpt))
    extra, kw = {}, {}
    if how == "load_optimizer":
        kw["load_optimizer"] = False
    elif how == "import_torch_optimizer":
        extra["import_torch_optimizer"] = False
    else:
        layers = ["Dense_0", "Dense_1", "Dense_2", "Dense_3"]
        extra["torch_name_map"] = {
            f"{2 * i}.{k}": f"params/{d}/{'kernel' if k == 'weight' else 'bias'}"
            for i, d in enumerate(layers) for k in ("weight", "bias")}
    jt, pt = _pair(tmp_path, **extra)
    _load_both(jt, pt, ckpt, **kw)
    _params_equal(jt, pt, "fsv_net")
    assert int(jt.train_state.step) == pt.step == 0
    assert int(_jax_adam(jt, "fsv_net").count) == 0 and not pt.optimizer["fsv_net"].state


def test_import_resets_a_trained_optimizer_and_step(tmp_path):
    jt, pt = _pair(tmp_path)
    b = {"inputs": np.random.default_rng(0).normal(size=(4, 66)).astype(np.float32),
         "labels": np.zeros(4, np.int32), "_mask": np.ones(4, np.float32)}
    for _ in range(3):
        pt.train_step(pt._stack_batches([b]))
    assert pt.step == 3 and pt.optimizer["fsv_net"].state
    ckpt = tmp_path / "warm.tar"
    torch.save({"source": "coinstac", "models": {"fsv_net": _torch_mlp(seed=13).state_dict()}},
               str(ckpt))
    pt.load_checkpoint(full_path=str(ckpt))
    assert pt.step == 0 and not pt.optimizer["fsv_net"].state


def test_partial_checkpoint_keeps_the_other_model(tmp_path):
    """A payload naming only ``net_a`` of the two-network trainer imports
    it (and its Adam state) and leaves ``net_b``'s trained weights and
    optimizer as they were — in both packages."""
    cache = {"input_shape": [16, 16, 16], "model_width": 4, "seed": 0, "learning_rate": 1e-3,
             "compute_dtype": "float32"}
    jt = JaxMultiNet(cache=dict(cache, share_compiled=False, local_data_parallel=False)).init_nn()
    pt = MultiNetTrainer(cache=dict(cache), device="cpu").init_nn()
    for n in ("net_a", "net_b"):
        pt.nn[n].load_state_dict(interop.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jt.train_state.params[n]), pt.nn[n]))
    rng = np.random.default_rng(0)
    batch = {"inputs": rng.normal(size=(2, 16, 16, 16)).astype(np.float32),
             "labels": np.asarray([0, 1], np.int32), "_mask": np.ones(2, np.float32)}
    pt.train_step(pt._stack_batches([batch]))
    trained_b = interop.params_to_jax(pt.nn["net_b"])
    opt_b = {k: v.clone() for k, v in next(iter(pt.optimizer["net_b"].state.values())).items()}

    source = MultiNetTrainer(cache=dict(cache, seed=7), device="cpu").init_nn()
    sd = source.nn["net_a"].state_dict()
    src_opt = torch.optim.Adam(source.nn["net_a"].parameters(), lr=1e-3)
    source.nn["net_a"](torch.from_numpy(batch["inputs"])).square().sum().backward()
    src_opt.step()
    ckpt = tmp_path / "only_a.tar"
    torch.save({"source": "coinstac", "models": {"net_a": sd},
                "optimizers": {"net_a": src_opt.state_dict()}}, str(ckpt))
    b_before = jax.device_get(jt.train_state.params["net_b"])
    _load_both(jt, pt, ckpt)
    _params_equal(jt, pt, "net_a")
    for k, v in sd.items():
        assert torch.equal(pt.nn["net_a"].state_dict()[k], v)
    for a, b in zip(jax.tree_util.tree_leaves(trained_b),
                    jax.tree_util.tree_leaves(interop.params_to_jax(pt.nn["net_b"]))):
        np.testing.assert_array_equal(a, b)
    after_b = next(iter(pt.optimizer["net_b"].state.values()))
    assert all(torch.equal(opt_b[k], after_b[k]) for k in opt_b)
    for a, b in zip(jax.tree_util.tree_leaves(b_before),
                    jax.tree_util.tree_leaves(jax.device_get(jt.train_state.params["net_b"]))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pt.step == int(jt.train_state.step) == 1


# ----------------------------------------------- a real architecture: ResNet
class _TorchvisionStyleResNet18(torch.nn.Module):
    """ResNet-18 written as torchvision writes it (``conv1``, ``bn1``,
    ``layer1.0.conv1`` … ``downsample``, ``fc``), with GroupNorm in place
    of BatchNorm: other names, the same creation order."""

    def __init__(self, width=8, num_classes=2):
        super().__init__()
        gn = lambda c: torch.nn.GroupNorm(min(8, c), c, eps=1e-6)  # noqa: E731
        self.conv1 = torch.nn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = gn(width)
        cin = width
        for i, feat in enumerate((width, 2 * width, 4 * width, 8 * width)):
            layer = torch.nn.Sequential()
            for b in range(2):
                stride = 2 if (i > 0 and b == 0) else 1
                blk = torch.nn.Module()
                blk.conv1 = torch.nn.Conv2d(cin, feat, 3, stride, 1, bias=False)
                blk.bn1 = gn(feat)
                blk.conv2 = torch.nn.Conv2d(feat, feat, 3, 1, 1, bias=False)
                blk.bn2 = gn(feat)
                if stride != 1 or cin != feat:
                    blk.downsample = torch.nn.Sequential(
                        torch.nn.Conv2d(cin, feat, 1, stride, bias=False), gn(feat))
                layer.append(blk)
                cin = feat
            setattr(self, f"layer{i + 1}", layer)
        self.fc = torch.nn.Linear(cin, num_classes)


def test_resnet_loads_a_torchvision_style_checkpoint(tmp_path):
    net = _TorchvisionStyleResNet18()
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    for p in net.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    ckpt = tmp_path / "resnet.tar"
    torch.save({"source": "coinstac", "models": {"resnet": net.state_dict()},
                "optimizers": {"resnet": opt.state_dict()}}, str(ckpt))
    cache = {"input_shape": [32, 32, 3], "model_width": 8, "seed": 0, "compute_dtype": "float32"}
    jt = JaxResNet(cache=dict(cache, share_compiled=False, local_data_parallel=False)).init_nn()
    pt = ResNetTrainer(cache=dict(cache), device="cpu").init_nn()
    _load_both(jt, pt, ckpt)
    _params_equal(jt, pt, "resnet")
    model = pt.nn["resnet"]
    for pname, t in zip(interop.creation_order(model), net.parameters()):
        assert torch.equal(model.get_parameter(pname), t.detach())
    assert pt.step == int(jt.train_state.step) == 1
    assert all(float(s["step"]) == 1.0 for s in pt.optimizer["resnet"].state.values())
    assert len(pt.optimizer["resnet"].state) == 62
