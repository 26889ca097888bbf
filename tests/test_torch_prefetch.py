"""The port's ``device_prefetch`` (``data/data.py``) and its use in
``NNTrainer.train_local``, on the CPU.

The JAX package's ``test_device_prefetch_preserves_batches`` on the port
(order, a producer error raised again in the consumer, ``size <= 0`` a
pass-through), a consumer that breaks early stopping the producer thread,
``sharding=`` over a rank mesh, and a local training run with
``prefetch_batches`` 0 and 2 ending on bit-equal parameters (the same
batches in the same order through the same ops).  The copy stream and the
cross-stream lifetime are the card's: ``tests/test_torch_prefetch_card.py``.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu_torch.data import COINNDataHandle, device_prefetch
from coinstac_dinunet_tpu_torch.models import NiftiVBMDataset, VBMTrainer
from test_torch_nifti import make_site_data

CPU = torch.device("cpu")


def _producers():
    return [t for t in threading.enumerate() if t.name == "coinn-prefetch"]


def _wait_no_producer(timeout=5.0):
    end = time.monotonic() + timeout
    while _producers() and time.monotonic() < end:
        time.sleep(0.02)
    return not _producers()


def test_device_prefetch_preserves_batches():
    batches = [{"inputs": np.full((4, 2), i, np.float32), "labels": np.arange(4)}
               for i in range(6)]
    got = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(got) == 6
    for i, b in enumerate(got):
        assert isinstance(b["inputs"], torch.Tensor) and b["inputs"].device == CPU
        np.testing.assert_array_equal(b["inputs"].numpy(), batches[i]["inputs"])
        np.testing.assert_array_equal(b["labels"].numpy(), batches[i]["labels"])

    def bad():
        yield batches[0]
        raise RuntimeError("loader died")

    it = device_prefetch(bad(), size=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="loader died"):
        next(it)

    # size <= 0: a plain pass-through of the host batches
    plain = list(device_prefetch(iter(batches), size=0))
    assert len(plain) == 6 and all(p is b for p, b in zip(plain, batches))
    assert _wait_no_producer()


def test_device_prefetch_casts_inputs_only():
    batches = [{"inputs": np.ones((2, 3), np.float32), "_mask": np.ones(2, np.float32)}]
    (b,) = device_prefetch(iter(batches), size=1, device="cpu", cast=torch.bfloat16)
    assert b["inputs"].dtype == torch.bfloat16 and b["_mask"].dtype == torch.float32


def test_early_break_stops_the_producer():
    drawn = []

    def endless():
        i = 0
        while True:
            drawn.append(i)
            yield {"inputs": np.full((2,), i, np.float32)}
            i += 1

    gen = device_prefetch(endless(), size=2, device="cpu")
    for i, b in enumerate(gen):
        assert float(b["inputs"][0]) == i
        if i == 3:
            break
    gen.close()
    assert _wait_no_producer(), "the producer thread outlived its consumer"
    n = len(drawn)
    time.sleep(0.3)
    assert len(drawn) == n  # nothing drawn after the stop
    # it stayed at most size (+ the one in hand) ahead of the consumer
    assert n <= 4 + 2 + 1


def test_sharding_splits_each_batch_over_the_ranks():
    """``sharding=(mesh, axis)``: each batch as one part per rank of the
    axis, rank r's rows on its device, in the order of the unsharded
    prefetch; a batch that does not split evenly raises in the consumer."""
    from coinstac_dinunet_tpu_torch.parallel.mesh import build_site_only_mesh

    mesh = build_site_only_mesh(3, ["cpu"] * 3)
    host = [{"x": np.arange(6.0) + 10 * i} for i in range(4)]
    got = list(device_prefetch(iter(host), size=2, sharding=(mesh, "site")))
    assert [[p["x"].tolist() for p in parts] for parts in got] == [
        [[10 * i + 0.0, 10 * i + 1.0], [10 * i + 2.0, 10 * i + 3.0],
         [10 * i + 4.0, 10 * i + 5.0]] for i in range(4)]
    assert _wait_no_producer()
    with pytest.raises(ValueError, match="does not split"):
        next(device_prefetch(iter([{"x": np.zeros(4)}]), size=2, sharding=(mesh, "site")))


def _local_trainer(root, prefetch):
    data = root / "data"
    data.mkdir(parents=True)
    make_site_data(str(data), 20, n_classes=3, scaled_int16=True)
    cache = dict(task_id="vbm", data_dir="data", split_ratio=[0.6, 0.2, 0.2], batch_size=4,
                 seed=5, learning_rate=1e-3, epochs=2, input_shape=[8, 8, 8], model_width=4,
                 num_classes=3, compute_dtype="bfloat16", patience=50, verbose=False,
                 prefetch_batches=prefetch, log_dir=str(root / "logs"))
    state = {"baseDirectory": str(root), "outputDirectory": str(root / "out"),
             "transferDirectory": str(root / "xfer"), "clientId": "site_0"}
    os.makedirs(state["transferDirectory"])
    handle = COINNDataHandle(cache=cache, state=state, dataset_cls=NiftiVBMDataset)
    handle.prepare_data()
    cache["split_ix"] = 0
    trainer = VBMTrainer(cache=cache, state=state, data_handle=handle, device="cpu")
    trainer.init_nn()
    return trainer


def test_train_local_with_and_without_prefetch_is_bit_equal(tmp_path):
    """The pretrain's loop (3-class NIfTI VBM, bfloat16 inputs cast on the
    host, dropout on): the parameters and logs after two epochs are the
    same bit for bit with the thread two batches ahead and without it."""
    runs = {}
    for prefetch in (0, 2):
        trainer = _local_trainer(tmp_path / f"p{prefetch}", prefetch)
        trainer.train_local()
        runs[prefetch] = trainer
    a, b = runs[0], runs[2]
    assert a.step == b.step > 0
    for (name, pa), (_, pb) in zip(a.nn["vbm_net"].named_parameters(),
                                   b.nn["vbm_net"].named_parameters()):
        assert torch.equal(pa, pb), name
    assert a.cache["train_log"] == b.cache["train_log"]
    assert a.cache["validation_log"] == b.cache["validation_log"]
    # the 3-class matrix's P, R, F1 and accuracy after the loss
    assert len(a.cache["train_log"][0]) == 5
    assert _wait_no_producer()


def test_prefetch_needs_a_card_unless_given_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            next(device_prefetch(iter([{"x": np.zeros(1)}]), size=2, device=dev))
    (b,) = device_prefetch(iter([{"x": np.zeros(1)}]), size=2, device="cpu")
    assert b["x"].device == CPU
