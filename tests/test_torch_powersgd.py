"""The port's PowerSGD engine (``parallel/powersgd.py``) against the JAX
package's.

The round-by-round run: two sites of the FSV MLP (synthetic samples, 24
files each, batch 4, 2 epochs, dropout off, float32, float32 wire),
``start_powerSGD_iter=2`` and ``matrix_approximation_rank=2``, the port
started from the JAX package's initial weights and both packages' start Q
replaced by one numpy draw (JAX draws it from threefry, the port from a
torch generator; the test patches both ``seeded_Q``).  Every round the
outputs carry the same keys, phases and modes, and each site's parameters
agree within 1e-5; both reach SUCCESS in the same round.  Then the
port alone: the warm-up rounds are dSGD, a convolution kernel's matrix has
the kernel's depth axis of 3 as its rows (the reference's reshape), an
int8 run reaches SUCCESS, and sites that disagree on the phase are refused.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coinstac_dinunet_tpu.parallel.powersgd as jax_psgd
import coinstac_dinunet_tpu_torch.parallel.powersgd as port_psgd
from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
from coinstac_dinunet_tpu.models import FSVDataset as JaxFSVDataset
from coinstac_dinunet_tpu.models import FSVTrainer as JaxFSVTrainer
from coinstac_dinunet_tpu_torch import InProcessEngine
from coinstac_dinunet_tpu_torch.interop import params_from_jax, params_to_jax
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer, VBM3DNet
from coinstac_dinunet_tpu_torch.ops import quantize
from coinstac_dinunet_tpu_torch.trainer import COINNTrainer
from coinstac_dinunet_tpu_torch.utils.tensorutils import extract_grads

ARGS = dict(
    data_dir="data", synthetic=True, batch_size=4, epochs=2,
    split_ratio=[0.5, 0.25, 0.25], compute_dtype="float32", seed=11, patience=100,
    dropout=0.0, agg_engine="powerSGD",
)
PARAM_ATOL = 1e-5


def _provision(eng, n=24):
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(n):
            open(os.path.join(d, f"{s}_subject_{i:02d}"), "w").close()


def _jax_init_weights():
    t = JaxFSVTrainer(cache=dict(ARGS, num_classes=2, local_data_parallel=False))
    t.init_nn()
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  t.train_state.params["fsv_net"])


class _PortFromJaxWeights(FSVTrainer):
    """Initialized from the JAX package's initial weights."""

    jax_init = None

    def _init_nn_weights(self):
        super()._init_nn_weights()
        net = self.nn["fsv_net"]
        net.load_state_dict(params_from_jax(self.jax_init, net))


def _start_q(seed, j, ncols, rank):
    return np.random.default_rng(int(seed) * 1000 + int(j)).normal(
        size=(int(ncols), int(rank))).astype(np.float32)


def _shape(out):
    return (sorted(out), out.get("phase"), out.get("mode"), out.get("global_modes"),
            out.get("powerSGD_phase"))


def test_powersgd_rounds_match_jax_engine(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_psgd, "seeded_Q", lambda *a: jnp.asarray(_start_q(*a)))
    monkeypatch.setattr(port_psgd, "seeded_Q", lambda *a: torch.from_numpy(_start_q(*a)))
    _PortFromJaxWeights.jax_init = _jax_init_weights()
    engine_args = dict(ARGS, precision_bits=32, start_powerSGD_iter=2,
                       matrix_approximation_rank=2)
    jeng = JaxEngine(tmp_path / "jax", n_sites=2, trainer_cls=JaxFSVTrainer,
                     dataset_cls=JaxFSVDataset, local_data_parallel=False, **engine_args)
    peng = InProcessEngine(tmp_path / "port", n_sites=2, trainer_cls=_PortFromJaxWeights,
                           dataset_cls=FSVDataset, device="cpu", **engine_args)
    _provision(jeng)
    _provision(peng)
    phases, compared = set(), 0
    while not jeng.success:
        assert jeng.rounds < 40
        j_sites, j_remote = jeng.step_round()
        p_sites, p_remote = peng.step_round()
        assert _shape(p_remote) == _shape(j_remote), jeng.rounds
        for s in jeng.site_ids:
            assert _shape(p_sites[s]) == _shape(j_sites[s]), (jeng.rounds, s)
            phases.add(p_sites[s].get("powerSGD_phase"))
            j_ts = jeng.site_caches[s].get("_train_state")
            p_ts = peng.site_caches[s].get("_train_state")
            if j_ts is None:
                continue
            want = jax.tree_util.tree_leaves(j_ts.params["fsv_net"])
            got = jax.tree_util.tree_leaves(params_to_jax(p_ts.nn["fsv_net"]))
            gap = max(np.abs(np.asarray(a) - b).max() for a, b in zip(want, got))
            assert gap <= PARAM_ATOL, (jeng.rounds, s, gap)
            compared += 1
    assert peng.success and peng.rounds == jeng.rounds
    assert {"dSGD", "phase_P_sync", "phase_Q_sync"} <= phases
    assert compared >= 2 * 12
    # the error-feedback memory is live and the compression updates ran
    st = peng.site_caches["site_0"]["_powersgd_state"]
    assert st.iteration > 2 and any(float(e.abs().sum()) > 0 for e in st.errors)


def test_powersgd_warmup_falls_back_to_dsgd(tmp_path):
    eng = InProcessEngine(tmp_path, n_sites=2, trainer_cls=FSVTrainer, dataset_cls=FSVDataset,
                          device="cpu", precision_bits=32, **dict(ARGS, epochs=1))
    _provision(eng)
    shipped = 0
    for _ in range(6):
        sites, remote = eng.step_round()
        for out in sites.values():
            if out.get("reduce"):
                shipped += 1
                assert out["powerSGD_phase"] == "dSGD" and out["grads_file"] == "grads.npy"
                assert "powerSGD_P_file" not in out
    assert shipped >= 4
    assert eng.site_caches["site_0"]["_powersgd_state"].iteration >= 2


def test_conv_leaf_matrix_has_the_kernel_depth_as_rows():
    """``_as_matrix`` reshapes the flax-layout leaf: a (3, 3, 3, cin, cout)
    kernel becomes (3, 9·cin·cout), as in the JAX package."""
    net = VBM3DNet(width=4)
    net.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn((2, 8, 8, 8), generator=torch.Generator().manual_seed(1))
    net(x).sum().backward()
    flat = extract_grads({"vbm_net": net})
    hi, lo = port_psgd._split_leaves(flat)
    j_hi, j_lo = jax_psgd._split_leaves([g.numpy() for g in flat])
    assert (hi, lo) == (j_hi, j_lo) and len(hi) == 8 and len(lo) == 15
    for i in hi:
        got = port_psgd._as_matrix(flat[i])
        want = np.asarray(jax_psgd._as_matrix(flat[i].numpy()))
        np.testing.assert_array_equal(got.numpy(), want)
    stem = port_psgd._as_matrix(flat[hi[-1]])  # params/_StemConv_0/kernel sorts last
    assert tuple(stem.shape) == (3, 3 * 3 * 1 * 4)


def test_powersgd_int8_run_reaches_success(tmp_path):
    before = quantize.KERNEL.launches
    eng = InProcessEngine(tmp_path, n_sites=2, trainer_cls=FSVTrainer, dataset_cls=FSVDataset,
                          device="cpu", precision_bits=8, start_powerSGD_iter=1,
                          matrix_approximation_rank=1, **ARGS)
    _provision(eng)
    eng.run(max_rounds=40)
    assert eng.success
    csv = tmp_path / "remote_out" / "task" / "global_test_metrics.csv"
    header, row = open(csv).read().strip().splitlines()
    assert all(np.isfinite(float(v)) for v in row.split(","))
    assert quantize.KERNEL.launches == before  # CPU tensors take the plain version
    for s in eng.site_ids:
        for p in eng.site_caches[s]["_train_state"].nn["fsv_net"].parameters():
            assert bool(p.isfinite().all())


def test_sites_disagreeing_on_the_phase_are_refused():
    trainer = COINNTrainer(cache={}, input={
        "site_0": {"powerSGD_phase": port_psgd.PHASE_P_SYNC, "reduce": True},
        "site_1": {"powerSGD_phase": port_psgd.PHASE_Q_SYNC, "reduce": True},
    }, state={}, device="cpu")
    with pytest.raises(RuntimeError, match="disagree on powerSGD phase"):
        port_psgd.PowerSGDReducer(trainer=trainer).reduce()
