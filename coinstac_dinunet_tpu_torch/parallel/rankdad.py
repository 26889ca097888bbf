"""rankDAD learner/reducer — distributed auto-differentiation with low-rank
(output-gradient, input-activation) exchange (PyTorch port).

Port of the JAX package's ``parallel/rankdad.py``: instead of weight
gradients, each site ships, per captured dense layer, the pair (output
gradient ``delta``, input activation ``act``) compressed to rank r by
:func:`..ops.power_iteration.power_iteration_BC` — payload ``[Br_0, Cr_0,
Br_1, Cr_1, …]`` in layer call order — and the gradients of every other
leaf ("rest", in the JAX leaf order) whole.  A ones column appended to
``act`` carries the bias gradient inside the factorization, and the update
splits ``G = Crᵀ Br`` into ``G[:-1]`` (kernel) and ``G[-1]`` (bias).  The
aggregator scales each site's ``B`` by ``w_i/Σw``, concatenates the sites
along the rank axis (the sum of their approximations) and re-compresses
(``dad_recompress``, default on); the rest leaves take the plain mean.

Capture.  The JAX package adds a zero perturbation to every
``flax.linen.Dense`` output through an interceptor, so that one
``jax.grad`` gives the output gradients.  The port hooks the captured
layers instead: a forward hook records the layer's input and registers a
tensor hook on its output, and one backward pass yields both the output
gradients and the plain gradients of the rest leaves.  The captured
layers are those whose flax counterpart is a ``flax.linen.Dense``: the
port's modules of exact type ``nn.Linear``.  The transformer's ``TPDense``
subclasses ``nn.Linear`` but is its own flax module, so — as in the JAX
package — its layers ship whole.  Keys are ``<flax module path>@<occurrence>``.

What differs from the JAX package:

- **Leaf mapping by the whole path.**  The JAX package maps a captured
  layer to its kernel leaf by a path *suffix*, so a model whose nested
  modules reuse a top-level layer's name (the sequence transformer: its
  blocks hold ``Dense_0``/``Dense_1`` too) fails there with "cannot
  uniquely map".  The port maps by the layer's whole flax path and runs
  rankDAD on the transformer; on models the JAX package maps, the plans
  are the same.
- The start blocks of the power iteration come from CPU
  ``torch.Generator``s (sites ``seed + 17``, the aggregator ``seed + 29``),
  not from JAX PRNG keys.
- The telemetry events and compression-health records of the JAX file are
  left out (the port has no ``telemetry/`` package yet).
- A site's state between invocations, :meth:`_DADState.serialize`, for
  the round file and the epoch-barrier autosave: the start-block
  generator's state (it advances from round to round, where the JAX
  package splits its key off the train state's PRNG key) and the capture
  plan.  The JAX package re-derives the plan in ``to_reduce`` only, so in
  a fresh process its ``step``, which comes first, finds none and fails;
  the port carries it.
"""
import functools

import numpy as np
import torch

from .. import config, interop
from ..ops.power_iteration import float32_math, power_iteration_BC
from ..utils import logger, tensorutils
from .learner import COINNLearner
from .reducer import COINNReducer

dad_rest_file = "dad_rest.npy"

_STATE_KEY = "_rankdad_state"


def _flatten2d(x):
    """``(B, ..., d)`` → ``(B·..., d)``."""
    return x.reshape(-1, x.shape[-1])


class _Capture:
    """Hooks on the captured dense layers of a dict of models while the
    context is open: each call records its input activation (``acts``),
    its flax module path (``layers``) and, through a tensor hook on its
    output, its output gradient (``grads``), keyed ``<path>@<occurrence>``
    in call order (``keys``); :meth:`plan` maps them onto the wire leaves."""

    def __init__(self, models):
        self.models = models
        self.keys, self.layers, self.acts, self.grads = [], {}, {}, {}
        self._counts = {}
        self._handles = []
        for name, model in models.items():
            for mname, module in model.named_modules():
                if mname and type(module) is torch.nn.Linear:
                    path = tuple(model.FLAX_NAMES[mname])
                    self._handles.append(module.register_forward_hook(self._hook(name, path)))

    def _hook(self, model_name, path):
        joined = "/".join(path)

        def hook(module, args, out):
            k = self._counts.get(joined, 0)
            self._counts[joined] = k + 1
            key = f"{joined}@{k}"
            self.keys.append(key)
            self.layers[key] = (model_name, path)
            self.acts[key] = args[0].detach()
            if out.requires_grad:
                out.register_hook(functools.partial(self.grads.__setitem__, key))

        return hook

    def plan(self):
        """``(layer_keys, leaf_map, rest_ix)`` of the layers captured so
        far: their keys in call order, layer → (kernel leaf index, bias
        leaf index or None) into the wire leaf order, and the indices of
        every other leaf."""
        paths = [(name, interop.flax_path(self.models[name], tname))
                 for name, tname in interop.wire_leaves(self.models)]
        leaf_map, covered = {}, set()
        for key in self.keys:
            model_name, module = self.layers[key]

            def find(leaf):
                want = (model_name, ("params", *module, leaf))
                return [i for i, p in enumerate(paths) if p == want]

            kern, bias = find("kernel"), find("bias")
            if len(kern) != 1:
                raise ValueError(f"rankDAD: cannot map layer {key!r} to a kernel leaf "
                                 f"(matches: {len(kern)})")
            leaf_map[key] = (kern[0], bias[0] if bias else None)
            covered.update(i for i in leaf_map[key] if i is not None)
        rest_ix = [i for i in range(len(paths)) if i not in covered]
        return list(self.keys), leaf_map, rest_ix

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []


def discover_capture(models, iteration, batch):
    """The capture plan of ``iteration(batch, None)`` over ``models``:
    ``(layer_keys, leaf_map, rest_ix)`` — the captured layers in call
    order, layer → (kernel leaf index, bias leaf index or None) into the
    wire leaf order, and the leaves exchanged whole.  One forward pass
    without gradients (the JAX package traces shapes only); the learner
    takes the same :meth:`_Capture.plan` from its first training pass."""
    with torch.no_grad(), _Capture(models) as cap:
        iteration(batch, None)
    return cap.plan()


def compress_layer_factors(grads, acts, layer_keys, leaf_map, generator, rank, iters):
    """Per-layer ``(delta, act)`` → rank-``rank`` ``(Br, Cr)`` factors in
    float32; a layer with a bias gets a ones column on ``act``."""
    Brs, Crs = {}, {}
    for lk in layer_keys:
        delta = _flatten2d(grads[lk]).to(torch.float32)
        act = _flatten2d(acts[lk]).to(torch.float32)
        if leaf_map[lk][1] is not None:
            act = torch.cat([act, act.new_ones((act.shape[0], 1))], dim=1)
        Brs[lk], Crs[lk] = power_iteration_BC(delta, act, generator, rank=rank,
                                              iterations=iters)
    return Brs, Crs


class _DADState:
    """Site-side capture plan, found on the first batch of a fold."""

    def __init__(self, seed):
        self.layer_keys = None  # captured layer keys, call order
        self.leaf_map = None  # layer key -> (kernel leaf ix, bias leaf ix | None)
        self.rest_ix = None  # wire leaf indices exchanged whole
        self.generator = torch.Generator().manual_seed(int(seed) + 17)  # start blocks

    def serialize(self):
        """What a fresh process needs to go on as this one would: the
        generator's state and the plan (None before the first batch)."""
        out = {"generator": self.generator.get_state()}
        if self.layer_keys is not None:
            out.update(layer_keys=list(self.layer_keys), rest_ix=list(self.rest_ix),
                       leaf_map={k: list(v) for k, v in self.leaf_map.items()})
        return out

    @classmethod
    def deserialize(cls, payload, seed):
        st = cls(seed)
        st.generator.set_state(payload["generator"])
        if "layer_keys" in payload:
            st.layer_keys = list(payload["layer_keys"])
            st.rest_ix = [int(i) for i in payload["rest_ix"]]
            st.leaf_map = {k: tuple(v) for k, v in payload["leaf_map"].items()}
        return st


class DADLearner(COINNLearner):
    """Site-side rankDAD."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.rank = int(self.cache.get("dad_reduction_rank", 10))
        self.iters = int(self.cache.get("dad_num_pow_iters", 5))
        if int(self.cache.get("local_iterations", 1)) > 1:
            logger.warn("rankDAD does not support local_iterations > 1; using 1.")
            self.cache["local_iterations"] = 1

    @property
    def dad(self):
        st = self.cache.get(_STATE_KEY)
        if st is None:
            st = self.cache[_STATE_KEY] = _DADState(self.cache.get("seed", 0))
        return st

    def to_reduce(self):
        """One batch → per-layer compressed (delta, act) factors and the
        rest leaves' gradients on the wire."""
        out = {}
        batch, nxt = self.trainer.data_handle.next_iter()
        out.update(nxt)
        if batch is None:
            return out
        trainer = self.trainer
        mask = batch.get("_mask")
        n = float(np.sum(mask)) if mask is not None else 1.0
        dev_batch = trainer._stack_batches([batch])[0]
        for m in trainer.nn.values():
            m.zero_grad(set_to_none=True)
        with _Capture(trainer.nn) as cap:
            with trainer._autocast():
                it = trainer.iteration(dev_batch, trainer.generator)
            it["loss"].backward()
        st = self.dad
        if st.layer_keys is None:
            st.layer_keys, st.leaf_map, st.rest_ix = cap.plan()
        Brs, Crs = compress_layer_factors(cap.grads, cap.acts, st.layer_keys, st.leaf_map,
                                          st.generator, self.rank, self.iters)
        wire = config.wire_torch_dtype(self.precision_bits)
        payload = []
        for lk in st.layer_keys:
            payload += [Brs[lk].to(wire), Crs[lk].to(wire)]
        flat = tensorutils.extract_grads(trainer.nn)
        self._save_wire(config.dad_data_file, payload)
        self._save_wire(dad_rest_file, [flat[i].to(wire) for i in st.rest_ix])
        out["dad_data_file"] = config.dad_data_file
        out["dad_rest_file"] = dad_rest_file
        out["reduce"] = True
        out["grad_weight"] = 1.0 if n > 0 else 0.0
        self._track_dad_scores(dev_batch, it, n)
        return out

    def _track_dad_scores(self, batch, it, n):
        """Fold the batch's loss (weight ``max(n, 1)``) and metric counts
        into the epoch accumulators."""
        averages = self.cache.get("_ep_averages")
        if averages is None:
            averages = self.cache["_ep_averages"] = self.trainer.new_averages()
            self.cache["_ep_metrics"] = self.trainer.new_metrics()
        averages.add(it["loss"].detach(), max(n, 1.0))
        if "pred" in it and "true" in it:
            self.cache["_ep_metrics"].add(it["pred"], it["true"], mask=batch.get("_mask"))

    def step(self):
        """Rebuild each captured layer's gradient ``G = Crᵀ Br`` (kernel
        rows, then the bias row) from the aggregated factors, take the rest
        leaves as they came, and step."""
        st = self.dad
        data = self._load_wire(self._base_path(self.input["dad_data_file"]))
        rest = self._load_wire(self._base_path(self.input["dad_rest_file"]))
        dev = self.trainer.device
        flat = [None] * len(interop.wire_leaves(self.trainer.nn))
        with float32_math(dev):
            for i, lk in enumerate(st.layer_keys):
                B = torch.from_numpy(np.array(data[2 * i], np.float32)).to(dev)  # (R, dout)
                C = torch.from_numpy(np.array(data[2 * i + 1], np.float32)).to(dev)  # (R, din[+1])
                G = C.T @ B  # (din[+1], dout): the kernel gradient (+ the bias row)
                kern_ix, bias_ix = st.leaf_map[lk]
                if bias_ix is not None:
                    flat[kern_ix], flat[bias_ix] = G[:-1], G[-1]
                else:
                    flat[kern_ix] = G
        for j, i in enumerate(st.rest_ix):
            flat[i] = rest[j]
        self.trainer.apply_grads(tensorutils.grads_like(self.trainer.nn, flat))
        return {}


class DADReducer(COINNReducer):
    """Aggregator-side rankDAD."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.rank = int(self.cache.get("dad_reduction_rank", 10))
        self.iters = int(self.cache.get("dad_num_pow_iters", 5))

    def reduce(self):
        site_payloads = self._load("dad_data_file")
        n_layers = len(site_payloads[0]) // 2
        wire = config.wire_torch_dtype(self.precision_bits)
        generator = torch.Generator().manual_seed(int(self.cache.get("seed", 0)) + 29)
        # mean semantics: scale each site's grad side by w_i/Σw, so that
        # concatenating and multiplying averages the participating sites
        w = self._site_weights()
        scales = w / torch.clamp_min(w.sum(), 1.0)

        def factor(sp, ix):
            return torch.from_numpy(np.array(sp[ix], np.float32)).to(self.device)

        out_payload = []
        for li in range(n_layers):
            # concatenated along the rank axis = the sum of the sites'
            # approximations
            B = torch.cat([factor(sp, 2 * li) * s for sp, s in zip(site_payloads, scales)])
            C = torch.cat([factor(sp, 2 * li + 1) for sp in site_payloads])
            if self.cache.get("dad_recompress", True):
                B, C = power_iteration_BC(B, C, generator, rank=self.rank,
                                          iterations=self.iters)
            out_payload += [B.to(wire), C.to(wire)]
        fname = self._save_out(config.dad_data_file, out_payload)
        rname = self._save_out(dad_rest_file, self._average(self._load("dad_rest_file")))
        return {"dad_data_file": fname, "dad_rest_file": rname, "update": True}
