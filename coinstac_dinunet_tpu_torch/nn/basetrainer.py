"""NNTrainer — the single-node training runtime (PyTorch port).

Port of the JAX package's ``nn/basetrainer.py``: a dict of models with one
Adam per model (``torch.optim.Adam``, the defaults of ``optax.adam``), seeded
initialization, the federated halves ``compute_grads`` (the mean gradient
over ``k`` micro-batches: summed, then divided by ``k``) and
``apply_grads``, ``eval_step``/``evaluation``, ``train_local`` with
checkpoints and early stopping.

PyTorch idiom in place of JAX's: the trainer owns live ``nn.Module``s on an
explicit ``torch.device`` (``cuda`` unless the caller passes
``device="cpu"``); dropout draws from an explicit ``torch.Generator`` (a
different stream from the JAX package's PRNG key, so runs with dropout on
differ between the packages); a bfloat16 ``compute_dtype`` runs the
forward and backward under ``torch.autocast`` while the loss, the logits
and the metric reductions stay float32.  Local checkpoints are
``torch.save`` payloads; a checkpoint that crosses the wire (the
pretrained weights the aggregator broadcasts) is the JAX package's own
format — ``flax.serialization.msgpack_serialize`` of ``{"source":
"coinstac-dinunet-tpu", "models": <flax variables>, "step"}``, written and
read by :mod:`..utils.flax_msgpack` through :mod:`..interop` — so either
package loads the other's.  Reading one, the port ignores ``optimizers``
and ``rng`` (the optimizer restarts, the dropout generator stays).  Local
data parallelism waits for a later slice (``ROADMAP.md``).

User subclasses implement ``_init_nn_model`` (fill ``self.nn``) and
``iteration(batch, generator=None)`` returning at least ``{"loss": ...}``
(plus optional ``pred``/``true``/``averages``); ``generator`` is None when
not training.
"""
import contextlib
import io
import os
from dataclasses import dataclass

import torch

from .. import config, interop
from ..config.keys import Mode
from ..data import to_device
from ..metrics import COINNAverages, Prf1a
from ..utils import atomic_write, flax_msgpack, logger
from ..utils.utils import performance_improved_, stop_training_

CHECKPOINT_SOURCE = "coinstac-dinunet-tpu-torch"
#: the ``source`` of a wire checkpoint: the JAX package's string, which its
#: ``load_checkpoint`` needs to read ``models`` (any other string sends it
#: down its foreign-payload fallback)
WIRE_CHECKPOINT_SOURCE = "coinstac-dinunet-tpu"


def is_torch_file(path):
    """Whether ``path`` holds a ``torch.save`` payload: a zip archive with a
    ``data.pkl`` member, or a legacy pickle (first byte ``0x80``, which is
    also msgpack's empty map — no checkpoint is one)."""
    try:
        with open(path, "rb") as f:
            head = f.read(2)
    except OSError:
        return False
    if head[:2] == b"PK":
        import zipfile

        try:
            with zipfile.ZipFile(path) as z:
                return any(n.endswith("data.pkl") for n in z.namelist())
        except (zipfile.BadZipFile, OSError):
            return False
    return head[:1] == b"\x80"


@dataclass
class TrainState:
    """Everything a site carries from one round to the next."""

    nn: dict
    optimizer: dict
    generator: object
    step: int


class NNTrainer:
    """Single-node training runtime over a dict of ``nn.Module``s."""

    #: cast float ``inputs`` to the compute dtype on the host (see
    #: :meth:`_input_cast_dtype`); ``cache['cast_inputs']`` wins
    CAST_INPUTS = True

    def __init__(self, cache=None, input=None, state=None, data_handle=None,
                 device=None, **kw):
        self.cache = cache if cache is not None else {}
        self.input = input if input is not None else {}
        self.state = state if state is not None else {}
        self.data_handle = data_handle
        self.device = config.resolve_device(device)
        self.nn = {}
        self.optimizer = {}
        self.generator = None
        self.step = 0

    @property
    def train_state(self):
        if not self.optimizer:
            return None
        return TrainState(dict(self.nn), dict(self.optimizer), self.generator,
                          self.step)

    @train_state.setter
    def train_state(self, ts):
        self.nn = dict(ts.nn)
        self.optimizer = dict(ts.optimizer)
        self.generator = ts.generator
        self.step = int(ts.step)

    # ------------------------------------------------------------------ hooks
    def _init_nn_model(self):
        """Populate ``self.nn`` with modules (user hook)."""
        raise NotImplementedError

    def iteration(self, batch, generator=None):
        """Forward + loss on one device batch (user hook)."""
        raise NotImplementedError

    def _init_optimizer(self):
        """One Adam per model at ``cache['learning_rate']``."""
        lr = float(self.cache.get("learning_rate", 1e-3))
        for name, m in self.nn.items():
            self.optimizer[name] = torch.optim.Adam(
                m.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def new_metrics(self):
        return Prf1a()

    def new_averages(self):
        return COINNAverages(num_averages=int(self.cache.get("num_averages", 1)))

    # ------------------------------------------------------------ init / state
    def _seed(self):
        return int(self.cache.get("seed", config.current_seed))

    def init_nn(self, init_models=True, init_weights=True, init_optimizer=True):
        """Build the models (``init_models``), give them their seeded
        weights (``init_weights``; without it they go to the device as
        built, for a checkpoint to fill) and the optimizers and train state
        (``init_optimizer``)."""
        if init_models:
            self.nn = {}
            self._init_nn_model()
        if init_weights:
            self._init_nn_weights()
        else:
            self.nn = {name: m.to(self.device) for name, m in self.nn.items()}
        if init_optimizer:
            self._init_optimizer()
            self._init_train_state()
        return self

    def _init_nn_weights(self):
        """Seeded initialization on the CPU, then the move to the device:
        the same seed gives every site the same replica, whatever its
        device.  ``pretrained_path`` warm-starts after."""
        gen = torch.Generator().manual_seed(self._seed())
        for name, m in self.nn.items():
            if hasattr(m, "init_weights"):
                m.init_weights(gen)
            else:
                with torch.random.fork_rng(devices=[]):
                    torch.manual_seed(int(torch.randint(2 ** 31, (), generator=gen)))
                    for sub in m.modules():
                        if hasattr(sub, "reset_parameters"):
                            sub.reset_parameters()
            self.nn[name] = m.to(self.device)
        if self.cache.get("pretrained_path"):
            self.load_checkpoint(full_path=self.cache["pretrained_path"],
                                 load_optimizer=False)

    def _init_train_state(self):
        self.generator = torch.Generator(device=self.device).manual_seed(
            self._seed() + 1)
        self.step = 0

    # ------------------------------------------------------------- checkpoints
    def checkpoint_path(self, name=None):
        log_dir = self.cache.get("log_dir", self.state.get("outputDirectory", "."))
        os.makedirs(log_dir, exist_ok=True)
        return os.path.join(log_dir, name or self.cache.get("latest_nn_state", "latest.ckpt"))

    def save_checkpoint(self, name=None, full_path=None, save_optimizer=True,
                        extra=None):
        """Serialize ALL models (+ optimizers, step, dropout generator);
        ``extra`` is a JSON-able dict stored alongside (resume record)."""
        payload = {
            "source": CHECKPOINT_SOURCE,
            "models": {n: m.state_dict() for n, m in self.nn.items()},
            "step": int(self.step),
        }
        if self.generator is not None:
            payload["rng"] = self.generator.get_state()
        if extra is not None:
            payload["extra"] = extra
        if save_optimizer:
            payload["optimizers"] = {n: o.state_dict() for n, o in self.optimizer.items()}
        path = full_path or self.checkpoint_path(name)
        buf = io.BytesIO()
        torch.save(payload, buf)
        atomic_write(path, buf.getvalue())
        return path

    def save_wire_checkpoint(self, full_path):
        """Write the models as a wire checkpoint (the JAX package's msgpack
        format, see the module docstring): what crosses to other sites."""
        payload = {
            "source": WIRE_CHECKPOINT_SOURCE,
            "models": {n: interop.params_to_jax(m) for n, m in self.nn.items()},
            "step": int(self.step),
        }
        atomic_write(full_path, flax_msgpack.serialize(payload))
        return full_path

    def load_checkpoint(self, name=None, full_path=None, load_optimizer=True,
                        allow_torch=True):
        """Restore models (and optimizers, step, generator when present)
        from a :meth:`save_checkpoint` file, or the models and step from a
        wire checkpoint (:meth:`save_wire_checkpoint`, or one the JAX
        package wrote), into the built models.  ``allow_torch=False`` — a
        file received from the aggregator — refuses a ``torch.save``
        payload rather than unpickle it."""
        path = full_path or self.checkpoint_path(name)
        if not self.nn:
            raise RuntimeError("load_checkpoint needs built models: call init_nn() first")
        if not is_torch_file(path):
            return self._load_wire_checkpoint(path)
        if not allow_torch:
            raise RuntimeError(
                f"{path!r} is a torch checkpoint, but torch files are only "
                "loaded from operator-configured local paths "
                "(cache['pretrained_path']), never from files received from "
                "the aggregator"
            )
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if payload.get("source") != CHECKPOINT_SOURCE:
            raise ValueError(f"{path!r} is not a {CHECKPOINT_SOURCE} checkpoint")
        self.last_checkpoint_extra = dict(payload.get("extra", {}))
        for n, sd in payload["models"].items():
            self.nn[n].load_state_dict(sd)
        if load_optimizer and self.optimizer and "optimizers" in payload:
            for n, sd in payload["optimizers"].items():
                self.optimizer[n].load_state_dict(sd)
            self.step = int(payload.get("step", self.step))
            if "rng" in payload and self.generator is not None:
                self.generator.set_state(payload["rng"])
        return self

    def _load_wire_checkpoint(self, path):
        """Models and step from a msgpack checkpoint.  As in the JAX package
        a payload of another ``source`` is taken as the models dict itself;
        ``optimizers`` and ``rng`` are ignored."""
        with open(path, "rb") as f:
            payload = flax_msgpack.restore(f.read())
        self.last_checkpoint_extra = dict(payload.get("extra", {}))
        models = (payload["models"] if payload.get("source") == WIRE_CHECKPOINT_SOURCE
                  else payload)
        for n, m in self.nn.items():
            m.load_state_dict(interop.params_from_jax(models[n], m))
        if "step" in payload:
            self.step = int(payload["step"])
        return self

    # -------------------------------------------------------------- the steps
    def _autocast(self):
        """bfloat16 autocast when ``cache['compute_dtype']`` asks for it;
        models keep their head and loss in float32 themselves."""
        if str(self.cache.get("compute_dtype", "float32")) == "bfloat16":
            return torch.autocast(device_type=self.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def _input_cast_dtype(self):
        """dtype float ``inputs`` are cast to on the host before the copy
        (None for float32 compute or ``cache['cast_inputs']=False``)."""
        if not self.cache.get("cast_inputs", type(self).CAST_INPUTS):
            return None
        dt = str(self.cache.get("compute_dtype", "float32"))
        return None if dt == "float32" else getattr(torch, dt)

    def _stack_batches(self, batches):
        """Host batches → device batches (the list of ``k`` micro-batches
        one round consumes)."""
        cast = self._input_cast_dtype()
        return [to_device(b, self.device, cast) for b in batches]

    def _step_outputs(self, it, batch, metrics_shell, averages_shell):
        """Metric/average state deltas of one micro-batch, on the device."""
        mask = batch.get("_mask")
        m_state = None
        if "pred" in it and "true" in it:
            m_state = metrics_shell.update_state(
                metrics_shell.empty_state(), it["pred"], it["true"], mask)
        vals = it.get("averages", it["loss"].detach())
        n = (torch.sum(mask) if mask is not None
             else torch.tensor(float(next(iter(batch.values())).shape[0])))
        a_state = averages_shell.update_state(averages_shell.empty_state(), vals, n)
        return m_state, a_state

    @staticmethod
    def _own_loss(it, batch):
        """The default ``loss_fn`` of ``compute_grads``: the iteration's loss,
        for the backward and for the log."""
        return it["loss"], it["loss"].detach()

    def compute_grads(self, batches, loss_fn=None):
        """Mean gradients over the ``k`` device micro-batches: each batch's
        gradient accumulates into ``.grad`` and the sum is divided by ``k``
        (the JAX package's ``gsum / k``).  ``loss_fn(it, batch)`` returns
        the scalar the backward takes and the loss value to log (default:
        the iteration's ``loss`` for both).  Returns ``(grads, aux)`` —
        ``grads`` is ``{model: {param name: gradient}}``; ``aux`` holds the
        round's metric/average states and the mean of the logged losses."""
        loss_fn = loss_fn or self._own_loss
        for m in self.nn.values():
            m.zero_grad(set_to_none=True)
        metrics_shell, averages_shell = self.new_metrics(), self.new_averages()
        msum = asum = None
        losses = []
        for batch in batches:
            with self._autocast():
                it = self.iteration(batch, self.generator)
            loss, logged = loss_fn(it, batch)
            loss.backward()
            with torch.no_grad():
                m_state, a_state = self._step_outputs(it, batch, metrics_shell,
                                                      averages_shell)
            msum = m_state if msum is None else {k: msum[k] + m_state[k] for k in msum}
            asum = a_state if asum is None else {k: asum[k] + a_state[k] for k in asum}
            losses.append(logged)
        k = len(batches)
        grads = {}
        for name, m in self.nn.items():
            grads[name] = {}
            for pname, p in m.named_parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.div_(k)
                grads[name][pname] = p.grad
        aux = {"metrics": msum, "averages": asum,
               "loss": torch.stack(losses).mean()}
        return grads, aux

    def apply_grads(self, grads):
        """One optimizer step from externally supplied (e.g. averaged)
        gradients ``{model: {param name: tensor}}``."""
        for name, m in self.nn.items():
            for pname, p in m.named_parameters():
                p.grad = grads[name][pname]
            self.optimizer[name].step()
        self.step += 1

    def train_step(self, batches, loss_fn=None):
        """compute_grads + the optimizer step (the local training path)."""
        _, aux = self.compute_grads(batches, loss_fn)
        for opt in self.optimizer.values():
            opt.step()
        self.step += 1
        return aux

    def eval_step(self, batch):
        with torch.no_grad(), self._autocast():
            it = self.iteration(batch, None)
        with torch.no_grad():
            m_state, a_state = self._step_outputs(
                it, batch, self.new_metrics(), self.new_averages())
        return m_state, a_state, it

    # ----------------------------------------------------------- train / eval
    def training_iteration_local(self, batches):
        return self.train_step(self._stack_batches(batches))

    @staticmethod
    def fold_train_outputs(aux, ep_averages, ep_metrics):
        """Fold one round's aux into the epoch accumulators."""
        ep_averages.update(aux["averages"])
        if aux.get("metrics") is not None:
            ep_metrics.update(aux["metrics"])

    def evaluation(self, mode=Mode.VALIDATION, dataset_list=None, save_pred=False):
        """No-grad loop over one or more datasets with mask-weighted metrics."""
        metrics, averages = self.new_metrics(), self.new_averages()
        datasets = dataset_list if dataset_list is not None else [
            self.data_handle.datasets.get(str(mode), None)
        ]
        cast = self._input_cast_dtype()
        for ds in datasets:
            if ds is None or len(ds) == 0:
                continue
            loader = self.data_handle.get_loader(
                handle_key=str(mode), dataset=ds, shuffle=False
            )
            ds_metrics, ds_averages = self.new_metrics(), self.new_averages()
            predictions = []
            for host_batch in loader:
                batch = to_device(host_batch, self.device, cast)
                m_state, a_state, it = self.eval_step(batch)
                if m_state is not None:
                    ds_metrics.update(m_state)
                ds_averages.update(a_state)
                if save_pred and "pred" in it:
                    predictions.append(
                        (it["pred"].cpu().numpy(), host_batch.get("_mask")))
            metrics.accumulate(ds_metrics)
            averages.accumulate(ds_averages)
            if save_pred:
                self.save_predictions(ds, predictions)
        return averages, metrics

    _RESUME_KEYS = ("train_log", "validation_log", "best_val_epoch",
                    "best_val_score")

    def train_local(self, train_dataset=None, val_dataset=None):
        """Full local training loop: epochs × batches with validation
        cadence, best-checkpoint save, early stop, score logging; with
        ``cache['resume']`` it restarts from the latest autosave."""
        cache = self.cache
        epochs = int(cache.get("epochs", 10))
        local_iterations = int(cache.get("local_iterations", 1))
        cache.setdefault("train_log", [])
        cache.setdefault("validation_log", [])
        if train_dataset is None:
            train_dataset = self.data_handle.get_train_dataset()
        if val_dataset is None:
            val_dataset = self.data_handle.get_validation_dataset()

        start_epoch = 1
        if cache.get("resume"):
            ckpt = self.checkpoint_path(cache.get("latest_nn_state", "latest.ckpt"))
            if os.path.exists(ckpt):
                self.load_checkpoint(full_path=ckpt)
                extra = getattr(self, "last_checkpoint_extra", {})
                for k in self._RESUME_KEYS:
                    if k in extra:
                        cache[k] = extra[k]
                start_epoch = int(extra.get("epoch", 0)) + 1
                logger.info(f"Resuming from epoch {start_epoch}",
                            cache.get("verbose", True))

        for epoch in range(start_epoch, epochs + 1):
            ep_averages, ep_metrics = self.new_averages(), self.new_metrics()
            loader = self.data_handle.get_loader(
                "train", dataset=train_dataset, shuffle=True,
                seed=int(cache.get("seed", 0)), epoch=epoch, drop_last=False,
            )
            batch_buf = []
            for i, batch in enumerate(loader):
                batch_buf.append(batch)
                if len(batch_buf) == local_iterations:
                    aux = self.training_iteration_local(batch_buf)
                    self.fold_train_outputs(aux, ep_averages, ep_metrics)
                    batch_buf = []
                    if logger.lazy_debug(i):
                        logger.info(
                            f"Ep {epoch}/{epochs} it {i}: loss {float(aux['loss']):.4f}",
                            cache.get("verbose", True),
                        )
            if batch_buf:
                aux = self.training_iteration_local(batch_buf)
                self.fold_train_outputs(aux, ep_averages, ep_metrics)
            cache["train_log"].append(ep_averages.get() + ep_metrics.get())

            if epoch % int(cache.get("validation_epochs", 1)) == 0 and len(val_dataset):
                val_averages, val_metrics = self.evaluation(Mode.VALIDATION, [val_dataset])
                cache["validation_log"].append(val_averages.get() + val_metrics.get())
                self._on_validation_end(epoch, val_averages, val_metrics)
                if self._stop_early(epoch):
                    logger.info(f"Early stop at epoch {epoch}", cache.get("verbose", True))
                    break
            autosave_every = int(cache.get("autosave_epochs", 1))
            if autosave_every > 0 and epoch % autosave_every == 0:
                self._autosave(epoch)
        self._on_train_end()
        return self

    def _autosave(self, epoch):
        """Write the latest checkpoint as a full resume point."""
        extra = {"epoch": epoch}
        extra.update({k: self.cache[k] for k in self._RESUME_KEYS if k in self.cache})
        self.save_checkpoint(name=self.cache.get("latest_nn_state", "latest.ckpt"),
                             extra=extra)

    # ------------------------------------------------------------- user hooks
    def _on_validation_end(self, epoch, averages, metrics):
        monitor = self.cache.get("monitor_metric", "f1")
        try:
            score = metrics.extract(monitor)
        except AttributeError:
            score = averages.average
        if performance_improved_(epoch, score, self.cache):
            self.save_checkpoint(name=self.cache.get("best_nn_state", "best.ckpt"))

    def _stop_early(self, epoch):
        return stop_training_(epoch, self.cache)

    def _on_train_end(self):
        self._autosave(len(self.cache.get("train_log", [])))

    def save_predictions(self, dataset, predictions):
        """User hook: persist per-dataset predictions."""
