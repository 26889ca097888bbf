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
pretrained weights the aggregator broadcasts, a donor's warm start for a
joiner) is the JAX package's own format — ``flax.serialization.
msgpack_serialize`` of ``{"source": "coinstac-dinunet-tpu", "models":
<flax variables>, "step"}`` and, for a warm start, ``"optimizers"``: each
model's Adam state as optax's ``(ScaleByAdamState(count, mu, nu),
EmptyState())`` state dict, the moments in the flax paths and layouts —
written and read by :mod:`..utils.flax_msgpack` through :mod:`..interop`,
so either package loads the other's.  ``count``, ``mu`` and ``nu`` are
``torch.optim.Adam``'s ``step``, ``exp_avg`` and ``exp_avg_sq``.  Reading
one, the port ignores ``rng`` (the dropout generator does not map; it
keeps its own).  Any other ``torch.save`` file is a checkpoint of the
reference framework, imported as the JAX package imports it
(:mod:`..utils.torch_import`).  Local data parallelism waits for a later
slice (``ROADMAP.md``).

With telemetry on (an ambient recorder, ``telemetry.get_active()``), as
in the JAX package: ``compute_grads`` records the gradient-health series
(norm, its EMA, the round's loss) and ``apply_grads`` the update norm;
``compute_grads`` and ``train_step`` time the round (``samples_per_sec``,
after a fence on the card) and take one device-memory sample, and run
under the anomaly-triggered profiler capture (``telemetry/capture.py``)
when the watchdog armed one.  The first step a freshly built model takes
records memory but no throughput (its time holds the first launches, not
a step), the JAX package's rule for the round that compiled its step.

A metric that cannot accumulate on the card (``jit_safe = False``: the
AUC's variable-length arrays) gets no device state: the step carries the
micro-batches' scores out as ``aux["host_scores"]`` (``prob`` over
``pred``, ``true``, the mask; :meth:`NNTrainer.host_scores_payload`) and
``aux["metrics"]`` is None; :meth:`NNTrainer.fold_train_outputs` and
:meth:`NNTrainer.evaluation` bring them to the host in one copy a round or
a batch.  ``train_local`` feeds its epochs through
:func:`..data.device_prefetch` (``cache['prefetch_batches']``, default 2;
0 turns it off).

User subclasses implement ``_init_nn_model`` (fill ``self.nn``) and
``iteration(batch, generator=None)`` returning at least ``{"loss": ...}``
(plus optional ``pred``/``prob``/``true``/``averages``); ``generator`` is
None when not training.
"""
import contextlib
import io
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import config, interop
from ..config.keys import Mode, Model
from ..data import device_prefetch, to_device
from ..metrics import COINNAverages, Prf1a
from ..telemetry import capture as _capture
from ..telemetry import health as _health
from ..telemetry import perf as _perf
from ..telemetry.recorder import get_active as _telemetry
from ..utils import atomic_write, flax_msgpack, logger
from ..utils import torch_import
from ..utils.utils import performance_improved_, stop_training_

CHECKPOINT_SOURCE = "coinstac-dinunet-tpu-torch"
#: the ``source`` of a wire checkpoint: the JAX package's string, which its
#: ``load_checkpoint`` needs to read ``models`` (any other string sends it
#: down its foreign-payload fallback)
WIRE_CHECKPOINT_SOURCE = "coinstac-dinunet-tpu"


@dataclass
class TrainState:
    """Everything a site carries from one round to the next."""

    nn: dict
    optimizer: dict
    generator: object
    step: int


def _on_device(tree, device):
    """A tensor, or a dict of them, on ``device`` (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: v.to(device) for k, v in tree.items()}
    return tree.to(device)


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

    def iteration_sharded(self, batch, generator=None, sp_axis=None):
        """Sequence-parallel iteration (the hook of
        :class:`~..parallel.seq_mesh.SeqMeshFederation`): ``batch`` is one
        batch per rank of ``sp_axis`` (a :class:`~..parallel.mesh.RankAxis`),
        each holding its sequence block of ``inputs``; returns one iteration
        output per rank.  The model must attend globally (ring attention),
        offset positional state by its block and reduce any pooling over
        the axis.  Default: ``iteration`` when ``sp_axis`` is None, else a
        refusal — attending only to the local block would change the
        math."""
        if sp_axis is None:
            return self.iteration(batch, generator)
        raise NotImplementedError(
            f"{type(self).__name__} does not implement sequence parallelism; "
            "override iteration_sharded() to run with sequence_parallel > 1"
        )

    def iteration_tp(self, batch, generator=None, tp_axis=None):
        """Tensor-parallel iteration (the hook of
        :class:`~..parallel.tp_mesh.TPMeshFederation`): ``batch`` is the
        site's whole batch once per rank of ``tp_axis``; the model computes
        each heavy matmul's rank slice and sums the row-parallel outputs
        over the axis, so every rank's loss is the same.  Default:
        ``iteration`` when ``tp_axis`` is None, else a refusal — the full
        model on every rank would waste the axis, and slicing without the
        sums would change the math."""
        if tp_axis is None:
            return self.iteration(batch, generator)
        raise NotImplementedError(
            f"{type(self).__name__} does not implement tensor parallelism; "
            "override iteration_tp() to run with tensor_parallel > 1"
        )

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

    def save_wire_checkpoint(self, full_path, save_optimizer=False):
        """Write the models (and with ``save_optimizer`` each model's Adam
        state in optax's layout) as a wire checkpoint (the JAX package's
        msgpack format, see the module docstring): what crosses to other
        sites."""
        payload = {
            "source": WIRE_CHECKPOINT_SOURCE,
            "models": {n: interop.params_to_jax(m) for n, m in self.nn.items()},
            "step": int(self.step),
        }
        if save_optimizer:
            payload["optimizers"] = {n: self._adam_to_optax(n) for n in self.optimizer}
        atomic_write(full_path, flax_msgpack.serialize(payload))
        return full_path

    def _adam_to_optax(self, name):
        """Model ``name``'s Adam state as optax's ``adam`` state dict:
        ``{"0": {"count", "mu", "nu"}, "1": {}}``, the moments in the
        parameters' flax paths and layouts (zero before the first step)."""
        model, opt = self.nn[name], self.optimizer[name]
        count = 0
        mu, nu = {}, {}
        for pname, p in model.named_parameters():
            st = opt.state.get(p) or {}
            if "step" in st:
                count = int(st["step"])
            for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                t = st.get(key)
                a = (t.detach().cpu().float().numpy() if t is not None
                     else np.zeros(tuple(p.shape), np.float32))
                node = tree
                *mods, leaf = interop.flax_path(model, pname)
                for k in mods:
                    node = node.setdefault(k, {})
                node[leaf] = np.ascontiguousarray(interop.to_flax(model, pname, a))
        return {"0": {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}, "1": {}}

    def _adam_from_optax(self, name, state):
        """Inverse of :meth:`_adam_to_optax` into model ``name``'s
        ``torch.optim.Adam`` (a count of 0 leaves it fresh)."""
        model, opt = self.nn[name], self.optimizer[name]
        adam = state["0"]
        count = int(np.asarray(adam["count"]))
        opt.state.clear()
        if count == 0:
            return
        for pname, p in model.named_parameters():
            moments = []
            for tree in (adam["mu"], adam["nu"]):
                node = tree
                for k in interop.flax_path(model, pname):
                    node = node[k]
                a = np.array(interop.from_flax(model, pname, np.asarray(node, np.float32)))
                moments.append(torch.from_numpy(a).to(device=p.device, dtype=p.dtype))
            opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                            "exp_avg": moments[0], "exp_avg_sq": moments[1]}

    def load_checkpoint(self, name=None, full_path=None, load_optimizer=True,
                        allow_torch=True):
        """Restore models (and optimizers, step, generator when present)
        from a :meth:`save_checkpoint` file, or the models and step from a
        wire checkpoint (:meth:`save_wire_checkpoint`, or one the JAX
        package wrote), into the built models; any other ``torch.save``
        file is a reference-ecosystem checkpoint
        (:meth:`_load_torch_checkpoint`).  ``allow_torch=False`` — a file
        received from the aggregator — refuses a ``torch.save`` payload
        rather than unpickle it."""
        path = full_path or self.checkpoint_path(name)
        if not self.nn:
            raise RuntimeError("load_checkpoint needs built models: call init_nn() first")
        if not torch_import.is_torch_file(path):
            return self._load_wire_checkpoint(path, load_optimizer)
        if not allow_torch:
            raise RuntimeError(
                f"{path!r} is a torch checkpoint, but torch files are only "
                "loaded from operator-configured local paths "
                "(cache['pretrained_path']), never from files received from "
                "the aggregator"
            )
        payload = torch_import.read_torch_file(
            path, allow_unsafe=bool(self.cache.get(Model.ALLOW_UNSAFE_TORCH_PICKLE)))
        if not (isinstance(payload, dict) and payload.get("source") == CHECKPOINT_SOURCE):
            return self._load_torch_checkpoint(payload, load_optimizer)
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

    def _load_torch_checkpoint(self, payload, load_optimizer=True):
        """Warm start from a reference-ecosystem ``torch.save`` payload
        (:mod:`..utils.torch_import`): a ``source='coinstac'`` payload maps
        its models by name, anything else is a state dict for the first
        model.  Every imported model's optimizer starts fresh; with
        ``load_optimizer`` and ``cache['import_torch_optimizer']`` (default
        on) a payload's Adam state for it is grafted on, and the step
        carries the largest grafted count (0 without one).  Models absent
        from the file keep their weights and optimizers.
        ``cache['torch_name_map']`` overrides the positional pairing."""
        state_dicts, optimizers = torch_import.split_payload(payload)
        if set(state_dicts) == {None}:
            state_dicts = {next(iter(self.nn)): state_dicts[None]}
        unknown = set(state_dicts) - set(self.nn)
        if unknown:
            raise KeyError(f"checkpoint models {sorted(unknown)} not in trainer models "
                           f"{list(self.nn)}")
        name_map = self.cache.get(Model.TORCH_NAME_MAP) or None
        # convert every model before any changes: a mismatch loads nothing
        imported = {n: torch_import.convert_state_dict(self.nn[n], sd, name_map=name_map)
                    for n, sd in state_dicts.items()}
        self.last_checkpoint_extra = {}
        for n, sd in imported.items():
            self.nn[n].load_state_dict(sd)
        if not self.optimizer:
            return self  # before init_nn builds the optimizers (pretrained_path)
        want_opt = load_optimizer and self.cache.get(Model.IMPORT_TORCH_OPTIMIZER, True)
        counts = []
        for n in imported:
            self.optimizer[n].state.clear()  # no stale moments for new weights
            opt_sd = (optimizers or {}).get(n)
            if not (want_opt and opt_sd):
                continue
            try:
                moments, count = torch_import.convert_torch_adam_state(
                    self.nn[n], opt_sd, name_map=name_map)
            except (ValueError, KeyError, TypeError) as exc:
                logger.warn(f"torch optimizer state for {n!r} not imported ({exc}); "
                            "starting that optimizer fresh")
                continue
            torch_import.graft_adam_state(self.optimizer[n], self.nn[n], moments, count)
            counts.append(count)
        self.step = max(counts, default=0)
        return self

    def _load_wire_checkpoint(self, path, load_optimizer=True):
        """Models and step from a msgpack checkpoint, and with
        ``load_optimizer`` each model's Adam state from its ``optimizers``
        (optax's layout) when it holds one.  As in the JAX package a
        payload of another ``source`` is taken as the models dict itself;
        ``rng`` is ignored."""
        with open(path, "rb") as f:
            payload = flax_msgpack.restore(f.read())
        self.last_checkpoint_extra = dict(payload.get("extra", {}))
        wire = payload.get("source") == WIRE_CHECKPOINT_SOURCE
        models = payload["models"] if wire else payload
        for n, m in self.nn.items():
            m.load_state_dict(interop.params_from_jax(models[n], m))
        if wire and load_optimizer and self.optimizer and "optimizers" in payload:
            for n in self.optimizer:
                self._adam_from_optax(n, payload["optimizers"][n])
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
        one round consumes); a batch already on the device (from
        :func:`..data.device_prefetch`) is taken as it is."""
        cast = self._input_cast_dtype()
        return [to_device(b, self.device, cast) for b in batches]

    def _step_outputs(self, it, batch, metrics_shell, averages_shell):
        """Metric/average state deltas of one micro-batch, on the device."""
        mask = batch.get("_mask")
        m_state = None
        if "pred" in it and "true" in it and metrics_shell.jit_safe:
            m_state = metrics_shell.update_state(
                metrics_shell.empty_state(), it["pred"], it["true"], mask)
        vals = it.get("averages", it["loss"].detach())
        n = (torch.sum(mask) if mask is not None
             else torch.tensor(float(next(iter(batch.values())).shape[0])))
        a_state = averages_shell.update_state(averages_shell.empty_state(), vals, n)
        return m_state, a_state

    @staticmethod
    def host_scores_payload(it, batch):
        """``{"score", "true", "mask"}`` float32 tensors of one micro-batch
        for a host-side metric (``score`` prefers the calibrated ``prob``
        over the argmax ``pred``), or None when the iteration has no
        ``pred``/``true``."""
        if "pred" not in it or "true" not in it:
            return None
        true = it["true"].detach().to(torch.float32)
        mask = batch.get("_mask")
        return {
            "score": it.get("prob", it["pred"]).detach().to(torch.float32),
            "true": true,
            "mask": (torch.ones_like(true) if mask is None
                     else torch.as_tensor(mask, device=true.device).to(torch.float32)),
        }

    @staticmethod
    def add_host_scores(metrics, hs):
        """Feed ``host_scores`` (``{"score", "true", "mask"}``, any shapes)
        to a host-side metric in one device-to-host copy."""
        parts = [hs[k].reshape(-1) for k in ("score", "true", "mask")]
        flat = torch.cat(parts).cpu().numpy()
        score, true, mask = np.split(flat, np.cumsum([p.numel() for p in parts])[:2])
        metrics.add(score, true, mask=mask)

    @staticmethod
    def _own_loss(it, batch):
        """The default ``loss_fn`` of ``compute_grads``: the iteration's loss,
        for the backward and for the log."""
        return it["loss"], it["loss"].detach()

    # ------------------------------------------------------------- telemetry
    def _captured(self, rec):
        """The anomaly-armed profiler capture around a round's step
        (enabled telemetry only)."""
        if not rec.enabled:
            return contextlib.nullcontext()
        return _capture.captured_round(self.cache, self.state.get("outputDirectory"), rec)

    def _fence(self):
        """Wait for the card's queued work, so a step's wall time is its
        own (the CPU has nothing queued)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _memory_census(self):
        """The tensors the trainer holds — parameters, gradients and
        optimizer state — for the CPU memory sample."""
        for m in self.nn.values():
            for p in m.parameters():
                yield p
                if p.grad is not None:
                    yield p.grad
        for opt in self.optimizer.values():
            for st in opt.state.values():
                yield from (v for v in st.values() if isinstance(v, torch.Tensor))

    @staticmethod
    def _batch_shapes(batches):
        """The shapes a step's micro-batches give it: what a compiled JAX
        step keys its executable on."""
        return tuple(tuple((name, tuple(t.shape)) for name, t in sorted(b.items())
                           if isinstance(t, torch.Tensor)) for b in batches)

    def _counted_step(self, key, batches, rec, fn, *args):
        """``fn(*args)``, counted (:func:`~..telemetry.perf.record_jit_cost`)
        on a freshly built model's first ``key`` step and on one whose batch
        shapes changed — where the JAX package builds the step's executable.
        Returns ``(out, counted)``; telemetry off, nothing is counted."""
        shapes = self._batch_shapes(batches) if rec.enabled else None
        models = list(self.nn.values())
        if shapes is None or all(getattr(m, "_coinn_counted", {}).get(key) == shapes
                                 for m in models):
            return fn(*args), False
        out, _ = _perf.record_jit_cost(self.cache, key, fn, args, recorder=rec,
                                       device=self.device)
        for m in models:
            m._coinn_counted = {**getattr(m, "_coinn_counted", {}), key: shapes}
        return out, True

    def _perf_round_end(self, timer, key, batches, rec, counted):
        """Per-round perf bookkeeping after the step's fence: the
        ``samples_per_sec``/``achieved_tflops``/``mfu`` series (``k``
        micro-batches of the padded batch size), except on a counted step,
        whose wall time holds the counter's, and one device-memory sample."""
        if not counted:
            rows = next(iter(batches[0].values())).shape[0]
            timer.done(self.cache, key, len(batches) * int(rows), recorder=rec,
                       device=self.device)
        _perf.sample_device_memory(self.cache, recorder=rec, device=self.device,
                                   census=self._memory_census)

    def compute_grads(self, batches, loss_fn=None, iteration_fn=None):
        """Mean gradients over the ``k`` device micro-batches: each batch's
        gradient accumulates into ``.grad`` and the sum is divided by ``k``
        (the JAX package's ``gsum / k``).  ``loss_fn(it, batch)`` returns
        the scalar the backward takes and the loss value to log (default:
        the iteration's ``loss`` for both); ``iteration_fn(batch,
        generator)`` stands in for ``iteration`` (the mesh planes' per-rank
        forward).  Returns ``(grads, aux)`` —
        ``grads`` is ``{model: {param name: gradient}}``; ``aux`` holds the
        round's metric/average states and the mean of the logged losses.
        With telemetry on, the step's FLOP count (first step and new
        shapes), the gradient-health series (whose norm is the host fence),
        the round's perf samples and the armed capture."""
        rec = _telemetry()
        rec.count("grad_steps")
        timer = _perf.StepTimer() if rec.enabled else None
        with self._captured(rec):
            (grads, aux), counted = self._counted_step("grads", batches, rec, self._grads,
                                                       batches, loss_fn, iteration_fn)
            if rec.enabled:
                _health.record_grad_health(self.cache, grads, aux, recorder=rec)
        if timer is not None:
            self._perf_round_end(timer, "grads", batches, rec, counted)
        return grads, aux

    def _grads(self, batches, loss_fn=None, iteration_fn=None):
        """:meth:`compute_grads` without its telemetry."""
        loss_fn = loss_fn or self._own_loss
        iteration_fn = iteration_fn or self.iteration
        for m in self.nn.values():
            m.zero_grad(set_to_none=True)
        metrics_shell, averages_shell = self.new_metrics(), self.new_averages()
        # a host-side metric (AUC) accumulates no device state: its scores
        # leave the step as aux["host_scores"]
        collect_host = not metrics_shell.jit_safe
        msum = asum = None
        losses, scores = [], []
        for batch in batches:
            with self._autocast():
                it = iteration_fn(batch, self.generator)
            loss, logged = loss_fn(it, batch)
            loss.backward()
            with torch.no_grad():
                m_state, a_state = self._step_outputs(it, batch, metrics_shell,
                                                      averages_shell)
                if collect_host:
                    hs = self.host_scores_payload(it, batch)
                    if hs is not None:
                        scores.append(_on_device(hs, self.device))
            # micro-batches may lie on other devices (a mesh plane's
            # shards): the round's states gather on the trainer's
            m_state = _on_device(m_state, self.device)
            a_state = _on_device(a_state, self.device)
            if m_state is not None:
                msum = m_state if msum is None else {k: msum[k] + m_state[k] for k in msum}
            asum = a_state if asum is None else {k: asum[k] + a_state[k] for k in asum}
            losses.append(logged.to(self.device))
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
        if scores:
            # (k, ...) per key, the micro-batch axis first, as in JAX
            aux["host_scores"] = {key: torch.stack([hs[key] for hs in scores])
                                  for key in scores[0]}
        return grads, aux

    def apply_grads(self, grads):
        """One optimizer step from externally supplied (e.g. averaged)
        gradients ``{model: {param name: tensor}}``; with telemetry on, the
        update-norm series first."""
        rec = _telemetry()
        if rec.enabled:
            _health.record_update_health(self.cache, grads, recorder=rec)
        for name, m in self.nn.items():
            for pname, p in m.named_parameters():
                p.grad = grads[name][pname]
            self.optimizer[name].step()
        self.step += 1

    def train_step(self, batches, loss_fn=None, iteration_fn=None):
        """compute_grads + the optimizer step (the local training path);
        with telemetry on, counted as :meth:`compute_grads` is, timed after
        a fence and under the armed capture, without the gradient-health
        series (as in the JAX package)."""
        rec = _telemetry()
        rec.count("train_steps")
        timer = _perf.StepTimer() if rec.enabled else None
        with self._captured(rec):
            aux, counted = self._counted_step("train", batches, rec, self._train,
                                              batches, loss_fn, iteration_fn)
            if timer is not None:
                self._fence()
        if timer is not None:
            self._perf_round_end(timer, "train", batches, rec, counted)
        return aux

    def _train(self, batches, loss_fn=None, iteration_fn=None):
        """:meth:`train_step` without its telemetry."""
        _, aux = self._grads(batches, loss_fn, iteration_fn)
        for opt in self.optimizer.values():
            opt.step()
        self.step += 1
        return aux

    def eval_step(self, batch, iteration_fn=None):
        with torch.no_grad(), self._autocast():
            it = (iteration_fn or self.iteration)(batch, None)
        with torch.no_grad():
            m_state, a_state = self._step_outputs(
                it, batch, self.new_metrics(), self.new_averages())
        return m_state, a_state, it

    # ----------------------------------------------------------- train / eval
    def training_iteration_local(self, batches):
        return self.train_step(self._stack_batches(batches))

    @classmethod
    def fold_train_outputs(cls, aux, ep_averages, ep_metrics):
        """Fold one round's aux into the epoch accumulators: the device
        states of a count metric, the carried-out ``host_scores`` of a
        host-side one."""
        ep_averages.update(aux["averages"])
        if aux.get("metrics") is not None:
            ep_metrics.update(aux["metrics"])
        elif "host_scores" in aux:
            cls.add_host_scores(ep_metrics, aux["host_scores"])

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
                elif not ds_metrics.jit_safe:
                    # a host-side metric (AUC) ranks the probabilities
                    hs = self.host_scores_payload(it, batch)
                    if hs is not None:
                        self.add_host_scores(ds_metrics, hs)
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
            # a thread stays a few batches ahead: reading, casting and the
            # copy to the device overlap the step on the previous batch
            batches = device_prefetch(
                iter(loader), size=int(cache.get("prefetch_batches", 2)),
                device=self.device, cast=self._input_cast_dtype(),
            )
            batch_buf = []
            for i, batch in enumerate(batches):
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
