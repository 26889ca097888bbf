"""The other metrics and data end to end: the port's engines against the
JAX package's on the CPU.

- A 3-class federation of the VBM 3-D CNN on NIfTI files
  (``NiftiVBMDataset``, half float32 ``.nii.gz``, half int16 ``.nii`` with
  a header slope, a stray unlabelled file a site), the port's
  ``InProcessEngine`` against the JAX one from the JAX package's initial
  weights, dropout off, float32: after every round each site's
  parameters within ``PARAM_ATOL`` = 1e-5 (``tests/test_torch_slice.py``'s
  bound: float32 sums in another order); the split files and the
  ``global_test_metrics.csv`` header identical; every log row the
  ConfusionMatrix's P, R, F1 and accuracy after the loss.
- The JAX package's ``tests/test_auc.py`` lifecycle on the port
  (``monitor_metric="auc"``, the XOR MLP that ships probabilities): the
  file transport reaches SUCCESS with every validation and global test
  AUC in (0, 1]; its logs are within 1e-5 of the JAX file transport's from
  the same weights (the logs are rounded to 5 decimals); and the
  site-vectorized engine's logs are within 2e-3 of the file transport's
  (the JAX test's tolerance between its mesh and file transports: the
  plane reduces inside one backward), its train-log AUC column above 0.
  The port's ``MeshEngine`` runs only under the vectorized plane (its
  per-rank planes are refused, ``ROADMAP.md`` Queue 1 item 11); without
  ``pred``/``true`` it evaluates per site on the host instead, as the JAX
  engine does.
- A ConfusionMatrix run through ``SubprocessEngine`` with the port's
  ``vbm_nifti`` entry scripts and ``persist_round_state``, every
  invocation seeing only the JSON cache: the epoch accumulators come back
  from the round file as 3×3 matrices, and the run equals the in-process
  run bit for bit.
"""
import json
import os

import jax
import numpy as np
import torch

from coinstac_dinunet_tpu_torch import InProcessEngine
from coinstac_dinunet_tpu_torch.federation import SiteVectorizedEngine
from coinstac_dinunet_tpu_torch.interop import params_from_jax, params_to_jax
from coinstac_dinunet_tpu_torch.metrics import ConfusionMatrix
from coinstac_dinunet_tpu_torch.models import NiftiVBMDataset, VBMTrainer
from test_torch_nifti import make_site_data
from test_torch_node_lanes import PortXorDataset, PortXorTrainer
from test_torch_subprocess_engine import REPO, FreshCacheEngine, round_file

PARAM_ATOL = 1e-5
LOG_ATOL = 1e-5
VEC_ATOL = 2e-3
LOGS = ("train_log", "validation_log", "test_metrics", "global_test_metrics")
NIFTI_TASK = "vbm_nifti"
NIFTI_ARGS = dict(
    task_id=NIFTI_TASK, data_dir="data", input_shape=[16, 16, 16], model_width=4, batch_size=4,
    epochs=2, split_ratio=[0.5, 0.25, 0.25], compute_dtype="float32", seed=11,
    patience=100, num_classes=3, precision_bits=32, verbose=False,
)
AUC_ARGS = dict(
    task_id="xor", data_dir="data", split_ratio=[0.7, 0.15, 0.15], batch_size=8, epochs=2,
    validation_epochs=1, learning_rate=5e-2, seed=11, patience=50,
    monitor_metric="auc", num_classes=2, verbose=False,
)


def _nifti_data(eng, n=12):
    """``n`` labelled subjects a site on a grid the dataset crops (x, y)
    and pads (z) to 16³.  (At 8³ the last stage's GroupNorm sees one
    voxel, and its 1/sqrt(eps) turns float32 rounding into 1e-3.)"""
    for i, s in enumerate(eng.site_ids):
        make_site_data(eng.site_data_dir(s), n, shape=(20, 18, 14), start=i * n,
                       n_classes=3, scaled_int16=True)


# ------------------------------------------------------ 3-class NIfTI VBM
def _jax_vbm():
    from coinstac_dinunet_tpu.metrics import classification_outputs
    from coinstac_dinunet_tpu.models import VBMTrainer as JaxVBMTrainer

    class JaxNoDropout(JaxVBMTrainer):
        def iteration(self, params, batch, rng=None):
            logits = self.nn["vbm_net"].apply(params["vbm_net"], batch["inputs"], train=False)
            return classification_outputs(logits, batch["labels"], mask=batch.get("_mask"))

    return JaxNoDropout


class PortFromJaxWeights(VBMTrainer):
    """Dropout off, initialized from the initial weights of the same site
    of the JAX engine, which steps first in every round."""

    jax_engine = None

    def _init_nn_weights(self):
        super()._init_nn_weights()
        ts = self.jax_engine.site_caches[self.state["clientId"]]["_train_state"]
        init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      ts.params["vbm_net"])
        self.nn["vbm_net"].load_state_dict(params_from_jax(init, self.nn["vbm_net"]))

    def iteration(self, batch, generator=None):
        return super().iteration(batch, None)


def test_three_class_nifti_federation_matches_jax(tmp_path):
    from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
    from coinstac_dinunet_tpu.models import NiftiVBMDataset as JaxNiftiVBMDataset

    jeng = JaxEngine(tmp_path / "jax", n_sites=2, trainer_cls=_jax_vbm(),
                     dataset_cls=JaxNiftiVBMDataset, local_data_parallel=False, **NIFTI_ARGS)
    PortFromJaxWeights.jax_engine = jeng
    peng = InProcessEngine(tmp_path / "port", n_sites=2, trainer_cls=PortFromJaxWeights,
                           dataset_cls=NiftiVBMDataset, device="cpu", **NIFTI_ARGS)
    _nifti_data(jeng)
    _nifti_data(peng)
    compared = 0
    while not jeng.success:
        assert jeng.rounds < 40
        jeng.step_round()
        peng.step_round()
        for s in jeng.site_ids:
            j_ts = jeng.site_caches[s].get("_train_state")
            p_ts = peng.site_caches[s].get("_train_state")
            if j_ts is None:
                continue
            want = jax.tree_util.tree_leaves(j_ts.params["vbm_net"])
            got = jax.tree_util.tree_leaves(params_to_jax(p_ts.nn["vbm_net"]))
            gap = max(np.abs(np.asarray(a, np.float32) - b).max() for a, b in zip(want, got))
            assert gap <= PARAM_ATOL, (jeng.rounds, s, gap)
            compared += 1
    assert peng.success and peng.rounds == jeng.rounds
    assert compared >= 2 * 6
    for s in jeng.site_ids:
        split = os.path.join("out", NIFTI_TASK, "splits", "SPLIT.json")
        got = open(tmp_path / "port" / s / split).read()
        assert got == open(tmp_path / "jax" / s / split).read()
        # the splits list the directory; the dataset indexes every labelled
        # volume and leaves the stray file and the CSV out
        ds = NiftiVBMDataset()
        ds.add([f for v in json.loads(got).values() for f in v],
               cache=dict(NIFTI_ARGS), state=peng.site_states[s])
        assert len(ds) == 12 and "stray.nii.gz" not in {f for _, f in ds.indices}
    csv = os.path.join("remote_out", NIFTI_TASK, "global_test_metrics.csv")
    p_header = open(tmp_path / "port" / csv).readline()
    assert p_header == open(tmp_path / "jax" / csv).readline()
    assert p_header.strip() == "loss,precision,recall,f1,accuracy"
    for key in ("train_log", "validation_log", "test_metrics"):
        assert all(len(row) == 5 for row in peng.remote_cache[key]), key
    for key in LOGS:
        np.testing.assert_allclose(np.asarray(peng.remote_cache[key], np.float64),
                                   np.asarray(jeng.remote_cache[key], np.float64),
                                   atol=LOG_ATOL, err_msg=key)


# ----------------------------------------------------------- AUC monitor
def _xor_files(eng, per_site=16):
    for i, s in enumerate(eng.site_ids):
        d = eng.site_data_dir(s)
        for j in range(per_site):
            with open(os.path.join(d, f"s_{i * per_site + j}"), "w") as f:
                f.write("x")


def _jax_xor_weights():
    from test_auc import XorProbTrainer

    jt = XorProbTrainer(cache={"input_shape": (2,), "seed": 11, "local_data_parallel": False})
    jt.init_nn()
    PortXorTrainer.jax_init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jt.train_state.params["net"])
    return XorProbTrainer


def _port_file_run(workdir):
    eng = InProcessEngine(workdir, n_sites=4, trainer_cls=PortXorTrainer,
                          dataset_cls=PortXorDataset, device="cpu", **AUC_ARGS)
    _xor_files(eng)
    eng.run(max_rounds=900)
    assert eng.success
    return eng


def test_auc_file_transport_lifecycle_matches_jax(tmp_path):
    from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
    from test_trainer import XorDataset

    XorProbTrainer = _jax_xor_weights()
    ours = _port_file_run(tmp_path / "port")
    vlog = np.asarray(ours.remote_cache["validation_log"], np.float64)
    assert vlog.shape[0] >= 1
    assert np.all(vlog[:, -1] > 0.0) and np.all(vlog[:, -1] <= 1.0)
    g = np.asarray(ours.remote_cache["global_test_metrics"], np.float64)
    assert g.shape == (1, 2) and 0.0 < g[0, -1] <= 1.0

    theirs = JaxEngine(tmp_path / "jax", n_sites=4, trainer_cls=XorProbTrainer,
                       dataset_cls=XorDataset, input_shape=(2,), local_data_parallel=False,
                       **AUC_ARGS)
    _xor_files(theirs)
    theirs.run(max_rounds=900)
    assert theirs.success and theirs.rounds == ours.rounds
    csv = os.path.join("remote_out", "xor", "global_test_metrics.csv")
    assert open(tmp_path / "port" / csv).read().splitlines()[0] == \
        open(tmp_path / "jax" / csv).read().splitlines()[0]
    for key in LOGS:
        np.testing.assert_allclose(np.asarray(ours.remote_cache[key], np.float64),
                                   np.asarray(theirs.remote_cache[key], np.float64),
                                   atol=LOG_ATOL, err_msg=key)


def test_auc_vectorized_engine_matches_file_transport(tmp_path):
    _jax_xor_weights()
    file_eng = _port_file_run(tmp_path / "file")
    vec = SiteVectorizedEngine(tmp_path / "vec", n_sites=4, trainer_cls=PortXorTrainer,
                               dataset_cls=PortXorDataset, device="cpu", **AUC_ARGS)
    _xor_files(vec)
    vec.run()
    assert vec.success
    for key in LOGS:
        a = np.asarray(file_eng.remote_cache[key], np.float64)
        b = np.asarray(vec.cache[key], np.float64)
        assert a.shape == b.shape, (key, a, b)
        np.testing.assert_allclose(a, b, atol=VEC_ATOL, err_msg=key)
    t = np.asarray(vec.cache["train_log"], np.float64)
    assert np.all(t[:, -1] > 0.0)


# -------------------------------------- round-state resume of a 3×3 matrix
def test_confusion_matrix_survives_fresh_caches(tmp_path):
    example = os.path.join(REPO, "coinstac_dinunet_tpu_torch", "examples", NIFTI_TASK)
    args = dict(NIFTI_ARGS, persist_round_state=True)
    fresh = FreshCacheEngine(tmp_path / "fresh", n_sites=2,
                             local_script=os.path.join(example, "local.py"),
                             remote_script=os.path.join(example, "remote.py"),
                             first_input={f"{NIFTI_TASK}_args": args},
                             env=dict(os.environ, PYTHONPATH=REPO), device="cpu")
    _nifti_data(fresh)
    restored = []
    while not fresh.success:
        assert fresh.rounds < 60
        fresh.step_round()
        path = round_file(fresh, "site_0")
        if os.path.exists(path):
            extra = torch.load(path, map_location="cpu", weights_only=True).get("extra", {})
            if "ep_metrics" in extra:
                m = ConfusionMatrix.deserialize(extra["ep_metrics"])
                restored.append(m.matrix.shape)
    assert restored and set(restored) == {(3, 3)}
    ref = InProcessEngine(tmp_path / "ip", n_sites=2, trainer_cls=VBMTrainer,
                          dataset_cls=NiftiVBMDataset, device="cpu", **NIFTI_ARGS)
    _nifti_data(ref)
    ref.run(max_rounds=60)
    assert ref.success and fresh.rounds == ref.rounds
    for key in LOGS:
        assert fresh.remote_cache[key] == ref.remote_cache[key], key
    assert all(len(row) == 5 for row in ref.remote_cache["train_log"])


def test_plane_without_pred_falls_back_to_host_eval(tmp_path, monkeypatch):
    """A host-side metric whose iteration gives no ``pred``/``true``: the
    plane cannot feed it, and ``MeshEngine`` evaluates per site on the host
    instead (as the JAX engine does), for validation and the test."""
    from coinstac_dinunet_tpu_torch.engine import MeshEngine

    class NoScores(PortXorTrainer):
        def iteration(self, batch, generator=None):
            it = super().iteration(batch, generator)
            return {k: v for k, v in it.items() if k not in ("pred", "true", "prob")}

    _jax_xor_weights()
    calls = []
    host_eval = MeshEngine._host_eval

    def spy(self, handles, which, **kw):
        calls.append(which)
        return host_eval(self, handles, which, **kw)

    monkeypatch.setattr(MeshEngine, "_host_eval", spy)
    vec = SiteVectorizedEngine(tmp_path / "vec", n_sites=2, trainer_cls=NoScores,
                               dataset_cls=PortXorDataset, device="cpu",
                               **dict(AUC_ARGS, epochs=1))
    _xor_files(vec)
    vec.run()
    assert vec.success
    assert calls == ["validation", "test"]
