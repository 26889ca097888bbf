"""The port's background commits (``cache['async_wire_commit']``):
``tensorutils.save_wire`` makes the payload's host parts before it returns
(K1's plain version here, the copy to the host, raw arrays to bytes) and
hands the header, the write, the fsync and the manifest to
``resilience.transport``'s committer thread; the nodes flush it before
their output leaves them.

- the files equal the synchronous path's byte for byte at every
  precision, with the manifest entries and the seed counter, even when
  the caller overwrites its tensors right after ``save_wire`` returns;
- an ``InProcessEngine`` run with it on gives the same logs and final
  parameters as one with it off, bit for bit, and no commit is pending
  when a round's outputs are out;
- a commit error fails the invocation that submitted it and never leaks
  into the next one;
- a float32 payload committed by the port in the background equals the
  one the JAX package commits in its own background, byte for byte.
"""
import os

import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu_torch import InProcessEngine
from coinstac_dinunet_tpu_torch.config.keys import Retry
from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer
from coinstac_dinunet_tpu_torch.resilience import transport
from coinstac_dinunet_tpu_torch.utils import tensorutils as tu

TASK = "fsv_classification"
ARGS = dict(
    data_dir="data", split_ratio=[0.6, 0.2, 0.2], batch_size=4, epochs=2,
    validation_epochs=1, learning_rate=5e-2, input_size=12, hidden_sizes=[8],
    num_classes=2, seed=7, synthetic=True, verbose=False, patience=50,
)
LOGS = ("train_log", "validation_log", "test_metrics", "global_test_metrics")


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(40, 33)).astype(np.float32)),
            rng.normal(size=(7,)).astype(np.float32),
            torch.arange(5, dtype=torch.int64),
            torch.from_numpy(rng.normal(size=(129,)).astype(np.float32))]


@pytest.mark.parametrize("bits", [32, 16, 8])
def test_async_files_equal_sync_files(tmp_path, bits):
    sync_dir, async_dir = tmp_path / "sync", tmp_path / "async"
    sync_dir.mkdir()
    async_dir.mkdir()
    sync_cache, async_cache = {"_wire_seed": 3}, {"_wire_seed": 3, Retry.ASYNC_WIRE_COMMIT: True}
    for r in range(3):
        arrays = _arrays(r)
        tu.save_wire(sync_dir / f"p{r}.npy", arrays, salt="site_1", cache=sync_cache,
                     precision_bits=bits)
        assert tu.save_wire(async_dir / f"p{r}.npy", arrays, salt="site_1",
                            cache=async_cache, precision_bits=bits) is None
        for a in arrays:  # the next backward overwrites the gradient buffers
            if isinstance(a, torch.Tensor):
                a.zero_()
            else:
                a[...] = 0
    assert transport.flush_async() == []
    assert async_cache["_wire_seed"] == sync_cache["_wire_seed"] == 3 + 3 * 4
    for r in range(3):
        assert (open(async_dir / f"p{r}.npy", "rb").read()
                == open(sync_dir / f"p{r}.npy", "rb").read())
    want = transport.read_manifest(str(sync_dir))["files"]
    got = transport.read_manifest(str(async_dir))["files"]
    assert {k: (v["bytes"], v["crc32"]) for k, v in got.items()} == {
        k: (v["bytes"], v["crc32"]) for k, v in want.items()}


def _fill(eng, per_site=10):
    for s in eng.site_ids:
        d = eng.site_data_dir(s)
        for i in range(per_site):
            open(os.path.join(d, f"{s}_subj{i}.txt"), "w").close()


def _engine(workdir, **args):
    eng = InProcessEngine(workdir, n_sites=2, trainer_cls=FSVTrainer, dataset_cls=FSVDataset,
                          device="cpu", task_id=TASK, **{**ARGS, **args})
    _fill(eng)
    return eng


def test_in_process_run_with_async_commit_equals_sync(tmp_path):
    """int8 wire: the same logs, rounds and parameters, bit for bit; the
    committer's queue is empty whenever a round's outputs are out."""
    ref = _engine(tmp_path / "sync", precision_bits=8).run(max_rounds=200)
    eng = _engine(tmp_path / "async", precision_bits=8, async_wire_commit=True)
    committer = transport.async_committer()
    submitted = []
    real_submit = committer.submit
    committer.submit = lambda fn: submitted.append(fn) or real_submit(fn)
    try:
        while not eng.success:
            assert eng.rounds < 200
            eng.step_round()
            assert committer.pending() == 0
    finally:
        del committer.submit
    assert ref.success and eng.rounds == ref.rounds
    assert len(submitted) > 0
    for key in LOGS:
        assert eng.remote_cache[key] == ref.remote_cache[key], key
    for s in ref.site_ids:
        want = ref.site_caches[s]["_train_state"].nn["fsv_net"].state_dict()
        got = eng.site_caches[s]["_train_state"].nn["fsv_net"].state_dict()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        assert eng.site_caches[s]["_wire_seed"] == ref.site_caches[s]["_wire_seed"]


def test_a_commit_error_raises_from_the_invocation(tmp_path, monkeypatch):
    """A site payload whose commit fails: the site's invocation raises with
    the commit's error before its output names the file, and the error does
    not reach a later invocation."""
    real = transport.commit_bytes

    def failing(path, *a, **kw):
        if os.path.basename(str(path)) == "grads.npy":
            raise OSError("no space left on the transfer volume")
        return real(path, *a, **kw)

    eng = _engine(tmp_path / "fail", async_wire_commit=True)
    monkeypatch.setattr(transport, "commit_bytes", failing)
    with pytest.raises(RuntimeError, match="no space left on the transfer volume"):
        for _ in range(20):
            eng.step_round()
    assert transport.flush_async() == []
    monkeypatch.setattr(transport, "commit_bytes", real)
    ok = _engine(tmp_path / "ok", async_wire_commit=True).run(max_rounds=200)
    assert ok.success


def test_float32_async_payload_equals_the_jax_package(tmp_path):
    from coinstac_dinunet_tpu.resilience import transport as jax_transport
    from coinstac_dinunet_tpu.utils import tensorutils as jax_tu

    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(17, 9)).astype(np.float32), np.arange(4, dtype=np.int32),
              rng.normal(size=(300,)).astype(np.float32)]
    port_cache = {Retry.ASYNC_WIRE_COMMIT: True}
    jax_cache = {Retry.ASYNC_WIRE_COMMIT: True}
    for r in range(2):
        tu.save_wire(tmp_path / f"port{r}.npy", arrays, salt="remote-aggregator",
                     cache=port_cache, precision_bits=32)
        jax_tu.save_wire(str(tmp_path / f"jax{r}.npy"), arrays, salt="remote-aggregator",
                         cache=jax_cache, precision_bits=32)
    transport.flush_async()
    jax_transport.flush_async()
    assert port_cache["_wire_seed"] == jax_cache["_wire_seed"]
    for r in range(2):
        assert (open(tmp_path / f"port{r}.npy", "rb").read()
                == open(tmp_path / f"jax{r}.npy", "rb").read())


def test_concurrent_callers_and_the_committer_keep_every_file_and_count(tmp_path):
    """Eight threads commit in the background while the main thread writes
    synchronously into the same directory, with a short switch interval:
    every file is its payload's bytes, the directory manifest names each
    with its CRC, and the native counters lose no update."""
    import sys
    import threading

    from coinstac_dinunet_tpu_torch import native

    before = native.COUNTS["packs"]
    arrays = {f"t{t}_{i}": [np.full((33, 5), t * 100 + i, np.float32)]
              for t in range(8) for i in range(10)}

    def worker(t):
        for i in range(10):
            tu.save_wire(tmp_path / f"t{t}_{i}.npy", arrays[f"t{t}_{i}"],
                         cache={Retry.ASYNC_WIRE_COMMIT: True})

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for i in range(20):
            arrays[f"main_{i}"] = [np.full(7, i, np.float32)]
            tu.save_arrays(tmp_path / f"main_{i}.npy", arrays[f"main_{i}"])
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert transport.flush_async() == []
    finally:
        sys.setswitchinterval(old)
    files = transport.read_manifest(str(tmp_path))["files"]
    assert sorted(files) == sorted(f"{k}.npy" for k in arrays)
    for key, arrs in arrays.items():
        header, blobs, crc = tu._pack_parts(arrs)
        assert open(tmp_path / f"{key}.npy", "rb").read() == header + b"".join(blobs)
        assert files[f"{key}.npy"]["crc32"] == crc
    assert native.COUNTS["packs"] - before == len(arrays)
