"""The port's ``vision`` (``coinstac_dinunet_tpu_torch/vision``) against the
JAX package's.

- every ``imageutils`` function on the inputs of ``tests/test_imageutils.py``
  returns what the JAX package's returns, bit for bit (arrays of the same
  dtype and shape and equal values, the same dicts, lists and tuples);
  both CLAHE paths, OpenCV's where it is installed and the numpy one;
- ``plot_progress`` writes the PNGs the JAX plotter writes, under the same
  names, and returns their paths;
- the aggregator writes the training-curve PNGs at the epochs
  ``lazy_debug`` picks and at the end of the fold;
- without matplotlib the plot is skipped with one ``plot:skipped`` event,
  and the run goes on.
"""
import copy
import os
import sys

import numpy as np
import pytest

from coinstac_dinunet_tpu.vision import imageutils as jax_iu
from coinstac_dinunet_tpu.vision import plotter as jax_plotter
from coinstac_dinunet_tpu_torch import InProcessEngine, vision
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer
from coinstac_dinunet_tpu_torch.vision import imageutils as iu
from coinstac_dinunet_tpu_torch.vision import plotter


def _same(a, b):
    """Bit-for-bit equality of nested results."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert type(a) is type(b) and a == b


def _rng(seed):
    return np.random.default_rng(seed)


def _patches(img, chunk, off, mod):
    return np.array([img[tuple(slice(b[2 * d], b[2 * d + 1]) for d in range(img.ndim))]
                     for b in mod.get_chunk_indexes(img.shape, chunk, off)])


def _mask_and_copy(mod):
    img = mod.Image()
    img.array = np.full((8, 8), 7, np.uint8)
    img.mask = np.zeros((8, 8), np.uint8)
    img.mask[2:6, 2:6] = 255
    img.apply_mask()
    dup = copy.copy(img)
    dup.array[3, 3] = 0
    return img.array, dup.array, dup.mask


def _clahe_rgb(mod):
    img = mod.Image()
    img.array = _rng(1).integers(0, 255, (16, 16, 3)).astype(np.uint8)
    img.apply_clahe()
    return img.array


def _tight(seed=0, shape=(32, 32)):
    return _rng(seed).normal(100, 10, shape).clip(0, 255).astype(np.uint8)


def _cc_arrays():
    arr = np.zeros((10, 10), np.uint8)
    arr[0:2, 0:2] = 1
    arr[5:9, 5:9] = 1
    return arr


def _components():
    arr = np.zeros((20, 20), np.uint8)
    arr[1:3, 1:3] = 1
    arr[5:15, 5:15] = 1
    return arr


PRED = np.array([[255, 255], [0, 0]], np.uint8)
TRUTH = np.array([[255, 0], [255, 0]], np.uint8)
IMG2 = _rng(0).integers(0, 255, (12, 10)).astype(np.uint8)
IMG3 = _rng(1).integers(0, 255, (8, 8, 6)).astype(np.uint8)
ZEROS = np.zeros((6, 6), np.uint8)
ZEROS[0, 0] = 100
FLOAT = _rng(0).random((8, 8)).astype(np.float32)
OVERLAY = np.zeros((4, 4), np.uint8)
OVERLAY[1, 1] = 255

CASES = {
    "image_mask_and_copy": _mask_and_copy,
    "clahe": lambda m: m._clahe(_tight(), 2.0, (4, 4)),
    "clahe_numpy": lambda m: m._clahe_numpy(_tight(), 2.0, (4, 4)),
    "clahe_numpy_ragged_tiles": lambda m: m._clahe_numpy(_tight(3, (37, 29)), 3.0, (8, 8)),
    "clahe_rgb": _clahe_rgb,
    "rgb_scores": lambda m: m.get_rgb_scores(PRED, TRUTH),
    "praf1": lambda m: m.get_praf1(PRED, TRUTH),
    "praf1_empty_prediction": lambda m: m.get_praf1(np.zeros_like(PRED), TRUTH),
    "rescale": lambda m: m.rescale(np.array([[0, 5], [10, 10]], np.float64)),
    "rescale3d": lambda m: m.rescale3d([np.arange(6.0), np.ones(3)]),
    "whiten": lambda m: m.whiten_image2d(_rng(0).normal(0, 1, (16, 16))),
    "signed_diff": lambda m: m.get_signed_diff_int8(IMG2, IMG2[::-1]),
    "chunk_indexes_2d": lambda m: list(m.get_chunk_indexes((10, 7), (4, 4), (3, 3))),
    "chunk_indexes_3d": lambda m: list(m.get_chunk_indexes((9, 9, 9), (4, 4, 4))),
    "chunk_indexes_small_image": lambda m: list(m.get_chunk_indexes((3, 8), (4, 4), (4, 4))),
    "chunk_indices_by_index": lambda m: m.get_chunk_indices_by_index(
        (10, 10), (4, 4), [(0, 0), (5, 5), (9, 9)]),
    "merge_2d": lambda m: m.merge_patches(_patches(IMG2, (5, 4), (3, 3), m), IMG2.shape,
                                          (5, 4), (3, 3)),
    "merge_3d": lambda m: m.merge_patches(_patches(IMG3, (4, 4, 3), (4, 4, 3), m), IMG3.shape,
                                          (4, 4, 3), (4, 4, 3)),
    "merge_true_coverage": lambda m: m.merge_patches(_patches(ZEROS, (4, 4), (2, 2), m),
                                                     ZEROS.shape, (4, 4), (2, 2)),
    "merge_float": lambda m: m.merge_patches(_patches(FLOAT, (4, 4), (4, 4), m), FLOAT.shape,
                                             (4, 4), (4, 4)),
    "merge_out_dtype": lambda m: m.merge_patches(_patches(FLOAT, (4, 4), (2, 2), m),
                                                 FLOAT.shape, (4, 4), (2, 2),
                                                 out_dtype=np.float64),
    "expand_and_mirror": lambda m: m.expand_and_mirror_patch((10, 10), (0, 4, 6, 10), (4, 4)),
    "largest_cc": lambda m: m.largest_cc(_cc_arrays()),
    "largest_cc_empty": lambda m: m.largest_cc(np.zeros((4, 4), np.uint8)),
    "remove_connected_comp": lambda m: m.remove_connected_comp(_components(), 5),
    "map_img_to_img2d": lambda m: m.map_img_to_img2d(np.full((4, 4), 50, np.uint8), OVERLAY),
    "pix_neigh": lambda m: (m.get_pix_neigh(1, 1), m.get_pix_neigh(3, 2, eight=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_imageutils_match_the_jax_package(case):
    _same(CASES[case](iu), CASES[case](jax_iu))


def test_exports_match_the_jax_package():
    assert iu.__all__ == jax_iu.__all__
    assert sorted(vision.__all__) == sorted(
        __import__("coinstac_dinunet_tpu.vision", fromlist=["__all__"]).__all__)


def test_image_load_roundtrip_and_missing_file(tmp_path):
    from PIL import Image as PILImage

    arr = (np.arange(64).reshape(8, 8) * 3).astype(np.uint8)
    PILImage.fromarray(arr).save(tmp_path / "x.png")
    got = []
    for mod in (iu, jax_iu):
        img = mod.Image()
        img.load(str(tmp_path), "x.png")
        img.load_mask(str(tmp_path), lambda f: f)
        got.append((img.array, img.mask, copy.copy(img).path))
        img.load(str(tmp_path), "missing.png")  # logged, not raised
    _same(got[0], got[1])


def test_plot_progress_writes_the_jax_plotters_files(tmp_path):
    cache = {"train_log": [[1.0, 0.5, 0.4], [0.8, 0.6, 0.5], [0.7, 0.7, 0.6]],
             "validation_log": [[0.9, 0.5, 0.5], [0.85, 0.55, 0.5]],
             "test_log": [[1.0]], "log_header": "loss|precision,f1"}
    keys = ["train_log", "validation_log", "test_log"]
    written = plotter.plot_progress(cache, str(tmp_path / "port"), plot_keys=keys, epoch=2)
    jax_plotter.plot_progress(cache, str(tmp_path / "jax"), plot_keys=keys, epoch=2)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "train_log.png", "validation_log.png"]
    assert written == [str(tmp_path / "port" / f"{k}.png") for k in keys[:2]]
    from PIL import Image as PILImage

    for name in ("train_log.png", "validation_log.png"):
        with PILImage.open(tmp_path / "port" / name) as a, \
                PILImage.open(tmp_path / "jax" / name) as b:
            assert a.size == b.size
    _same(plotter._epoch_ticks(7, 3), jax_plotter._epoch_ticks(7, 3))
    _same(plotter._rolling_mean(np.arange(10.0), 3), jax_plotter._rolling_mean(np.arange(10.0), 3))


ARGS = dict(
    data_dir="data", split_ratio=[0.6, 0.2, 0.2], batch_size=4, epochs=4,
    validation_epochs=1, learning_rate=5e-2, input_size=12, hidden_sizes=[8],
    num_classes=2, seed=7, synthetic=True, verbose=False, patience=50,
)


def _run(workdir, **args):
    eng = InProcessEngine(workdir, n_sites=2, trainer_cls=FSVTrainer, dataset_cls=FSVDataset,
                          device="cpu", task_id="fsv_classification", **{**ARGS, **args})
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(10):
            open(os.path.join(d, f"{s}_subj{i}.txt"), "w").close()
    return eng


def test_the_remote_writes_pngs_at_lazy_debug_epochs(tmp_path, monkeypatch):
    epochs = []
    real = plotter.plot_progress

    def spy(cache, log_dir=None, plot_keys=("train_log",), epoch=None):
        epochs.append(epoch)
        return real(cache, log_dir, plot_keys=plot_keys, epoch=epoch)

    monkeypatch.setattr(plotter, "plot_progress", spy)
    eng = _run(tmp_path).run(max_rounds=200)
    assert eng.success
    from coinstac_dinunet_tpu_torch.utils.logger import lazy_debug

    # every epoch barrier lazy_debug picks, then the end of the fold
    assert epochs == [e for e in range(1, ARGS["epochs"] + 1) if lazy_debug(e)] + [
        ARGS["epochs"]]
    log_dir = eng.remote_cache["log_dir"]
    from PIL import Image as PILImage

    for name in ("train_log.png", "validation_log.png"):
        with PILImage.open(os.path.join(log_dir, name)) as im:
            im.load()
            assert im.size[0] > 0


def test_without_matplotlib_the_plot_is_skipped_with_one_event(tmp_path, monkeypatch):
    import json

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    monkeypatch.setattr(plotter, "_SKIP_REPORTED", False)
    assert plotter.plot_progress({"train_log": [[1.0], [2.0]]}, str(tmp_path / "x")) == []
    assert not os.path.exists(tmp_path / "x")
    monkeypatch.setattr(plotter, "_SKIP_REPORTED", False)
    eng = _run(tmp_path / "run", profile=True).run(max_rounds=200)
    assert eng.success and eng.remote_cache["global_test_metrics"]
    assert not [f for _, _, fs in os.walk(tmp_path / "run") for f in fs if f.endswith(".png")]
    lane = os.path.join(eng.remote_state["outputDirectory"], "telemetry.remote.jsonl")
    with open(lane) as f:
        events = [json.loads(line) for line in f if line.strip()]
    skipped = [e for e in events if e.get("name") == "plot:skipped"]
    assert len(skipped) == 1, skipped
    assert "matplotlib" in json.dumps(skipped[0])
