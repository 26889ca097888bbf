"""Data layer: user-subclassable dataset, static-shape batch loader, handle.

Port of the JAX package's ``data/data.py``.  Batches are numpy
dict-of-arrays with static shapes: the tail batch is padded to
``batch_size`` and carries a ``_mask`` vector (1 = real, 0 = padding), every
site can be padded to the same number of batches for lockstep epochs, and
shuffling is numpy's, seeded by (seed, epoch), so both packages draw the
same batches.  :func:`to_device` moves a batch to the card through pinned
memory; :func:`device_prefetch` does it from a thread a few batches ahead,
on a copy stream of its own.
"""
import contextlib
import math
import os
import queue
import threading

import numpy as np
import torch

from .. import config
from ..config.keys import Mode
from . import datautils


def safe_collate(samples):
    """Stack a list of sample dicts into a batch dict, dropping failed
    (None) samples."""
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    keys = samples[0].keys()
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys}


def to_device(batch, device, cast=None):
    """A numpy batch dict as torch tensors on ``device``; float ``inputs``
    are cast to ``cast`` on the host first (half the bytes to copy at
    bfloat16).  Copies to the card go through pinned memory; a tensor
    already on ``device`` is taken as it is (no copy)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if cast is not None and k == "inputs" and t.is_floating_point():
            t = t.to(cast)
        if device.type == "cuda" and not t.is_cuda:
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


_PREFETCH_END = object()


def split_batch(batch, n):
    """A batch dict split along its first axis into ``n`` equal parts."""
    rows = int(np.shape(next(iter(batch.values())))[0])
    if rows % n:
        raise ValueError(f"a batch of {rows} does not split over {n} ranks")
    step = rows // n
    return [{k: v[r * step:(r + 1) * step] for k, v in batch.items()} for r in range(n)]


def device_prefetch(iterator, size=2, sharding=None, device=None, cast=None):
    """Yield ``iterator``'s host batches as device batches
    (:func:`to_device` with ``cast``), a producer thread staying ``size``
    batches ahead so that reading a batch and its copy overlap the
    consumer's work on the previous one.

    On the card the thread copies on a ``torch.cuda.Stream`` of its own
    and records an event after each batch; the consumer's current stream
    waits on that event, and every tensor is marked used by that stream
    (``record_stream``) so the caching allocator does not hand its memory
    out again while the consumer's work may still read it.  On the CPU the
    same thread runs with no stream.  ``size <= 0`` is a plain
    pass-through of the host batches; an exception in the producer is
    raised again in the consumer; a consumer that stops early (an error, a
    ``break``) stops the producer at its next batch.

    ``sharding``, the JAX package's placement of a batch over several
    devices, is a rank mesh and the name of one of its axes, ``(mesh,
    axis)`` (``parallel/mesh.py``; a 1-D mesh's axis): each batch is
    then split along its first axis into one part per rank, rank ``r``'s
    rows ``[r·B/n, (r+1)·B/n)`` on its device, and yielded as the list of
    the parts.  The copy stream serves ranks on one card; ranks on several
    cards are copied on each card's current stream."""
    axis = None
    if sharding is not None:
        mesh, name = sharding
        axis = mesh.axis(name)
    if int(size) <= 0:
        yield from iterator
        return
    dev = config.resolve_device(device if axis is None else axis.devices[0])
    one_device = axis is None or all(d == axis.devices[0] for d in axis.devices)

    def place(batch):
        if axis is None:
            return to_device(batch, dev, cast)
        return [to_device(part, d, cast) for part, d in
                zip(split_batch(batch, axis.size), axis.devices)]
    q = queue.Queue(maxsize=int(size))
    stop = threading.Event()

    def _put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer():
        try:
            on_card = dev.type == "cuda" and one_device
            with torch.cuda.device(dev) if on_card else contextlib.nullcontext():
                stream = torch.cuda.Stream(dev) if on_card else None
                for batch in iterator:
                    if stream is None:
                        item = (place(batch), None)
                    else:
                        with torch.cuda.stream(stream):
                            placed = place(batch)
                            done = torch.cuda.Event()
                            done.record(stream)
                        item = (placed, done)
                    if not _put(item):
                        return
            _put(_PREFETCH_END)
        except BaseException as exc:  # noqa: BLE001 — raised again by the consumer
            _put(exc)

    threading.Thread(target=_producer, name="coinn-prefetch", daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _PREFETCH_END:
                break
            if isinstance(item, BaseException):
                raise item
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(done)
                for part in (batch if isinstance(batch, list) else [batch]):
                    for t in part.values():
                        t.record_stream(stream)
            yield batch
    finally:
        stop.set()


class COINNDataset:
    """User-subclassable dataset: implement ``load_index(dataset_name,
    file)`` (append index entries to ``self.indices``) and
    ``__getitem__(ix) -> dict`` of numpy arrays."""

    def __init__(self, mode=Mode.TRAIN, limit=None, **kw):
        self.mode = mode
        self.limit = limit or float("inf")
        self.indices = []
        self.state = {}
        self.cache = {}
        self.data_conf = {}

    def load_index(self, dataset_name, file):
        self.indices.append([dataset_name, file])

    def __getitem__(self, ix):
        raise NotImplementedError

    def __len__(self):
        return len(self.indices)

    def path(self, dataset_name=None, cache_key="data_dir"):
        """Resolve a data path from the engine ``state`` + cached conf."""
        base = self.state.get(dataset_name, self.state).get("baseDirectory", ".") \
            if isinstance(self.state.get(dataset_name), dict) else self.state.get("baseDirectory", ".")
        sub = self.data_conf.get(cache_key, self.cache.get(cache_key, ""))
        return os.path.join(base, sub) if sub else base

    def add(self, files, cache=None, state=None, data_conf=None, dataset_name="site"):
        self.cache = cache or self.cache
        self.state = state or self.state
        self.data_conf = data_conf or self.data_conf
        for f in files:
            if len(self.indices) >= self.limit:
                break
            self.load_index(dataset_name, f)


class COINNDataLoader:
    """Deterministic static-shape batch iterator: pads the tail batch (and
    optionally the epoch up to ``target_batches``, wrapping indices) and
    marks padding with ``_mask=0``."""

    def __init__(self, dataset, batch_size=16, shuffle=False, seed=0, epoch=0,
                 drop_last=False, target_batches=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.drop_last = drop_last
        n = len(dataset)
        if drop_last:
            self.num_batches = n // self.batch_size
        else:
            self.num_batches = math.ceil(n / self.batch_size)
        if target_batches is not None:
            self.num_batches = max(self.num_batches, int(target_batches))
        self._order = self._make_order()

    def _make_order(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        total = self.num_batches * self.batch_size
        if total <= n:
            order = idx[:total]
            mask = np.ones(total, dtype=np.float32)
        else:
            reps = math.ceil(total / max(n, 1)) if n else 0
            order = np.tile(idx, reps)[:total] if n else np.zeros(total, dtype=int)
            mask = np.zeros(total, dtype=np.float32)
            mask[:n] = 1.0
        return order, mask

    def __len__(self):
        return self.num_batches

    @staticmethod
    def _collate_static(samples, batch_mask):
        """Collate keeping the batch dimension static: a sample that failed
        to load (None) is replaced by a copy of a real one and masked out."""
        keep = [s is not None for s in samples]
        if not any(keep):
            return None
        template = samples[keep.index(True)]
        filled, out_mask = [], np.array(batch_mask, dtype=np.float32)
        for i, s in enumerate(samples):
            if s is None:
                filled.append(template)
                out_mask[i] = 0.0
            else:
                filled.append(s)
        batch = safe_collate(filled)
        batch["_mask"] = out_mask
        return batch

    def __iter__(self):
        order, mask = self._order
        for b in range(self.num_batches):
            sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
            samples = [self.dataset[int(i)] for i in order[sl]]
            batch = self._collate_static(samples, mask[sl])
            if batch is not None:
                yield batch

    def batch_at(self, cursor):
        """Random access for cursor-based streaming (``next_iter``)."""
        order, mask = self._order
        sl = slice(cursor * self.batch_size, (cursor + 1) * self.batch_size)
        samples = [self.dataset[int(i)] for i in order[sl]]
        return self._collate_static(samples, mask[sl])


class COINNDataHandle:
    """Per-mode datasets built from the current fold's split JSON, loader
    configuration, and the ``next_iter`` batch cursor that survives across
    engine invocations in the node cache."""

    def __init__(self, cache=None, input=None, state=None, dataloader_args=None,
                 dataset_cls=COINNDataset):
        self.cache = cache if cache is not None else {}
        self.input = input if input is not None else {}
        self.state = state if state is not None else {}
        self.dataloader_args = dataloader_args or {}
        self.dataset_cls = dataset_cls
        self.datasets = {}

    def list_files(self):
        data_dir = os.path.join(
            self.state.get("baseDirectory", "."),
            self.cache.get("data_dir", self.cache.get("task_id", "")),
        )
        if not os.path.isdir(data_dir):
            data_dir = self.state.get("baseDirectory", ".")
        return sorted(os.listdir(data_dir))

    def prepare_data(self):
        """k-fold init (``datautils.init_k_folds`` precedence)."""
        files = self.list_files()
        return datautils.init_k_folds(files, self.cache, self.state,
                                      self.cache.get("data_conf", {}))

    def get_split(self):
        import json

        split_file = self.cache["splits"][str(self.cache.get("split_ix", 0))]
        with open(os.path.join(self.cache["split_dir"], split_file)) as f:
            return json.load(f)

    def get_dataset(self, handle_key, files, mode=None):
        ds = self.dataset_cls(mode=mode or handle_key, limit=self.cache.get("load_limit"))
        ds.add(files, cache=self.cache, state=self.state,
               data_conf=self.cache.get("data_conf", {}))
        self.datasets[handle_key] = ds
        return ds

    def get_train_dataset(self):
        return self.get_dataset("train", self.get_split().get("train", []), Mode.TRAIN)

    def get_validation_dataset(self):
        return self.get_dataset("validation", self.get_split().get("validation", []), Mode.VALIDATION)

    def get_test_dataset(self, load_sparse=False):
        files = self.get_split().get("test", [])
        if load_sparse and files:
            out = []
            for f in files:
                ds = self.dataset_cls(mode=Mode.TEST, limit=self.cache.get("load_limit"))
                ds.add([f], cache=self.cache, state=self.state,
                       data_conf=self.cache.get("data_conf", {}))
                out.append(ds)
            self.datasets["test"] = out
            return out
        return self.get_dataset("test", files, Mode.TEST)

    def get_loader(self, handle_key="train", dataset=None, **kw):
        """Merge precedence: call kwargs > per-key cached args > global args."""
        args = dict(self.dataloader_args.get(handle_key, {}))
        for k in ("batch_size", "seed"):
            if k in self.cache and k not in args:
                args[k] = self.cache[k]
        args.update(kw)
        args.setdefault("batch_size", 16)
        ds = dataset or self.datasets.get(handle_key)
        return COINNDataLoader(ds, **args)

    def next_iter(self, out=None):
        """The next training batch; on epoch exhaustion reset the cursor and
        signal VALIDATION_WAITING (the epoch barrier)."""
        out = out if out is not None else {}
        cursor = int(self.cache.get("cursor", 0))
        if "train" not in self.datasets:
            self.get_train_dataset()
        loader = self.get_loader(
            "train",
            shuffle=True,
            seed=int(self.cache.get("seed", 0)),
            epoch=int(self.cache.get("epoch", 0)),
            target_batches=self.cache.get("target_batches"),
        )
        batch = None
        while cursor < len(loader) and batch is None:
            batch = loader.batch_at(cursor)
            cursor += 1
        if batch is None:
            self.cache["cursor"] = 0
            self.cache["epoch"] = int(self.cache.get("epoch", 0)) + 1
            out["mode"] = Mode.VALIDATION_WAITING.value
            return None, out
        self.cache["cursor"] = cursor
        out["mode"] = self.cache.get("mode", Mode.TRAIN.value)
        return batch, out


class EmptyDataHandle(COINNDataHandle):
    """The aggregator holds no data."""

    def list_files(self):
        return []

    def prepare_data(self):
        return {}
