"""deep-*: the port's opt-in entry-point tier (``--deep``).

The JAX package's ``analysis/deepcheck.py`` traces each registered entry
point with ``jax.eval_shape`` on abstract inputs.  Eager PyTorch has no
abstract trace that reaches a ``ctypes`` kernel, so here each entry is
built from the port at the JAX stand-in's shapes and dtypes and **runs for
real** on ``device`` — ``cuda`` by default, as every entry point of the
port; ``cpu`` only when asked (:func:`~..config.resolve_device` raises
without a card).  Rank meshes repeat the one device (``[device] * 8``, the
JAX stand-ins' 8 virtual devices), so on the card the ring, Ulysses,
sharded-transformer and pipeline entries run through the attention
kernels (K2–K4) at head dims 8 and 4.

Reported findings (ordinary :class:`~.core.Finding` objects, so they flow
through the same baseline/suppression machinery as the static tiers):

- ``deep-entry-build`` — the entry's builder raised: the public
  constructor path itself is broken.
- ``deep-eval-shape`` — the entry raised on its first run (the JAX
  package's name for an ``eval_shape`` failure: a shape, dtype or mesh
  error somewhere in the step).
- ``deep-recompile`` — two runs on identical inputs gave different output
  trees of shapes and dtypes (or the second raised): host state leaks into
  the step.
- ``deep-config`` — the JAX package's platform error channel; the port's
  runner has no platform to set up, so it never reports it, and a missing
  card raises instead.

Each entry's second run is the one the analyzer's ``perf-host-sync`` rule
watches (:mod:`.dataflow`).  Runs are cached per process and device, so a
``--deep --tier3`` invocation runs each entry twice in all.

This module imports ``torch`` only inside the functions that build and run
the entries; importing it (``--list-deep``, ``--list-rules``) stays
``torch``-free.

Registering an entry point::

    from coinstac_dinunet_tpu_torch.analysis.deepcheck import register_entry_point

    @register_entry_point("my-step", "coinstac_dinunet_tpu_torch/foo/bar.py")
    def _entry_my_step(device):
        fn = build_my_step(..., device=device)   # the callable under test
        args = (...)                             # concrete inputs on device
        return fn, args

The builder runs lazily inside :func:`run_entry`; raising is itself a
finding, not a crash.
"""
import dataclasses

from .core import Finding

#: ranks of the stand-ins' meshes (the JAX stand-ins' 8 virtual devices)
RANKS = 8


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """One registered deep-check target."""

    name: str
    path: str      # repo-relative source path findings anchor to
    build: object  # (torch.device) -> (fn, args) with concrete inputs
    #: out -> the output tree in the JAX entry's layout (``gather`` of a
    #: sharded tree), for the comparison with the JAX package only
    view: object = None


#: every rule id this tier can emit (``--list-rules`` enumerates opt-in
#: tiers from these lists without importing torch)
DEEP_RULE_IDS = (
    "deep-config", "deep-entry-build", "deep-eval-shape", "deep-recompile",
)

DEEP_REGISTRY = {}


def register_entry_point(name, path, view=None):
    """Decorator registering ``build`` under ``name``; findings anchor to
    ``path`` (the module whose step the entry exercises)."""

    def deco(build):
        DEEP_REGISTRY[name] = EntryPoint(name, path, build, view)
        return build

    return deco


def _first_line(exc, limit=240):
    text = f"{type(exc).__name__}: {exc}"
    line = text.splitlines()[0] if text.splitlines() else text
    return line[:limit] + ("…" if len(line) > limit else "")


def output_signature(tree):
    """A tree of tensors (and numpy arrays) as the same tree of ``(shape,
    dtype name)`` pairs: dicts with sorted keys, lists for sequences."""
    if isinstance(tree, dict):
        return {str(k): output_signature(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [output_signature(v) for v in tree]
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return (tuple(int(n) for n in tree.shape),
                str(tree.dtype).replace("torch.", ""))
    return type(tree).__name__


@dataclasses.dataclass
class EntryRun:
    """One entry's two runs on one device: ``rule``/``message`` name the
    failure (None when both ran), ``out`` is the first run's output,
    ``syncs`` the synchronizing CUDA calls of the second run (``None``
    where they cannot be observed, on the CPU)."""

    name: str
    path: str
    rule: str = None
    message: str = None
    out: object = None
    syncs: list = None
    #: the watched second run's op records (:func:`.dataflow.watch_ops`),
    #: the step callable and its arguments (for the perf rules)
    ops: list = None
    fn: object = None
    args: tuple = None


#: (entry name, device) -> EntryRun
_RUN_CACHE = {}


def clear_run_cache():
    """Test hook: entries run under monkeypatched registries must not leak
    into later runs."""
    _RUN_CACHE.clear()


def run_entry(name, device="cuda"):
    """Build one registered entry on ``device`` and run it twice, the
    second run under the synchronizing-call and op watches
    (:mod:`.dataflow`).
    Cached per process; never raises for the entry's own failures."""
    import torch

    from ..config import resolve_device
    from .dataflow import watch_ops, watch_syncs

    _register_builtin_entries()
    dev = resolve_device(device)
    key = (name, str(dev))
    if key in _RUN_CACHE:
        return _RUN_CACHE[key]
    ep = DEEP_REGISTRY[name]
    run = _RUN_CACHE[key] = EntryRun(name, ep.path)
    try:
        fn, args = ep.build(dev)
    except Exception as exc:  # noqa: BLE001 — any build failure is a finding
        run.rule, run.message = "deep-entry-build", f"builder raised {_first_line(exc)}"
        return run
    try:
        run.out = fn(*args)
    except Exception as exc:  # noqa: BLE001 — run errors are the product
        run.rule, run.message = "deep-eval-shape", f"the step raised {_first_line(exc)}"
        return run
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # the first run's work is not the second's
    run.fn, run.args = fn, args
    try:
        with watch_syncs(dev) as syncs, watch_ops() as ops:
            out2 = fn(*args)
        run.syncs, run.ops = syncs, ops
    except Exception as exc:  # noqa: BLE001
        run.rule = "deep-recompile"
        run.message = (f"the second run of identical inputs raised {_first_line(exc)} — "
                       "the step consumes host state across runs")
        return run
    if output_signature(run.out) != output_signature(out2):
        run.rule = "deep-recompile"
        run.message = ("two runs of identical inputs gave different output trees of shapes "
                       "and dtypes — host state leaks into the step")
    return run


def run_deepcheck(names=None, device="cuda"):
    """Run the registered entry points on ``device``; returns findings.

    ``names`` filters the registry (None = all).  Every failure of an
    entry is a finding; a ``device`` that is not there raises."""
    _register_builtin_entries()
    wanted = set(names) if names else None
    findings = []
    for name in sorted(DEEP_REGISTRY):
        if wanted is not None and name not in wanted:
            continue
        run = run_entry(name, device)
        if run.rule is not None:
            findings.append(Finding(rule=run.rule, path=run.path, line=1, col=0,
                                    message=f"entry '{name}': {run.message}"))
    return findings


def list_entry_points():
    """name -> path of every registered entry (builtin registration forced)."""
    _register_builtin_entries()
    return {name: ep.path for name, ep in sorted(DEEP_REGISTRY.items())}


# --------------------------------------------------------------------------
# Built-in registry: the port's counterparts of the JAX package's stand-ins,
# the same names, shapes and dtypes.
# --------------------------------------------------------------------------
_BUILTINS_DONE = False
_PKG = "coinstac_dinunet_tpu_torch"


def _make_deep_trainer(device, **cache):
    """Minimal concrete NNTrainer: the JAX stand-in's MLP classifier
    (``Dense_0`` 4→8, ReLU, ``Dense_1`` 8→2; the FSV model at those
    widths), no data handle, one rank unless ``cache`` names more."""
    from ..metrics import classification_outputs
    from ..models.mlp import FSVNet
    from ..nn import NNTrainer

    class _DeepTrainer(NNTrainer):
        def _init_nn_model(self):
            self.nn["net"] = FSVNet(num_classes=2, hidden=(8,), dropout=0.0, input_size=4)

        def iteration(self, batch, generator=None):
            logits = self.nn["net"](batch["inputs"])
            return classification_outputs(logits, batch["labels"].long(), batch.get("_mask"))

    trainer = _DeepTrainer(cache={"input_shape": (4,), "learning_rate": 1e-2, "seed": 0,
                                  "local_data_parallel": False, **cache}, device=device)
    trainer.init_nn()
    return trainer


def _batches(k, rows, seed=0, mask=False):
    """``k`` host micro-batches of ``rows`` samples of the stand-in's 4
    features (numpy, as the loaders give them)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        b = {"inputs": rng.standard_normal((rows, 4)).astype(np.float32),
             "labels": rng.integers(0, 2, rows).astype(np.int32)}
        if mask:
            b["_mask"] = np.ones(rows, np.float32)
        out.append(b)
    return out


def _adam_tree(model, opt):
    """One model's ``torch.optim.Adam`` state in optax's ``adam`` layout
    (``({"count", "mu", "nu"}, {})``, the moments in flax paths and
    layouts), as views of the state tensors."""
    import torch

    from .. import interop

    count, mu, nu = 0, {}, {}
    for pname, p in model.named_parameters():
        st = opt.state.get(p) or {}
        if "step" in st:
            count = int(st["step"])  # a CPU tensor: no device sync
        for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            node = tree
            *mods, leaf = interop.flax_path(model, pname)
            for k in mods:
                node = node.setdefault(k, {})
            node[leaf] = interop.to_flax(model, pname, st.get(key, p))
    return ({"count": torch.tensor(count, dtype=torch.int32), "mu": mu, "nu": nu}, {})


def _params_tree(model):
    """A model's parameters as the flax variables dict, flax layouts, as
    views."""
    from .. import interop

    out = {}
    for pname, p in model.named_parameters():
        node = out
        *mods, leaf = interop.flax_path(model, pname)
        for k in mods:
            node = node.setdefault(k, {})
        node[leaf] = interop.to_flax(model, pname, p.detach())
    return out


def _state_tree(trainer):
    """The trainer's state in the JAX TrainState's layout (``params``,
    ``opt_state``, ``step``); the JAX state's PRNG key has no counterpart
    (the port's dropout stream is a ``torch.Generator``)."""
    import torch

    return {"params": {n: _params_tree(m) for n, m in trainer.nn.items()},
            "opt_state": {n: _adam_tree(m, trainer.optimizer[n]) for n, m in trainer.nn.items()},
            "step": torch.tensor(int(trainer.step), dtype=torch.int32)}


def _aux(aux):
    """A step's ``{"metrics", "averages", "loss"}``."""
    return {k: aux[k] for k in ("metrics", "averages", "loss")}


def _gathered(gather):
    """A view of a sharded step's ``(params, loss)``: the whole tree."""
    return lambda out: (gather(out[0]), out[1])


def _split_seq(x, n, devices):
    """``(B, H, T, d)`` as ``n`` sequence blocks, block ``r`` on
    ``devices[r]``."""
    import torch

    return [blk.to(dev) for blk, dev in zip(torch.chunk(x, n, 2), devices)]


def _qkv(shape, device, seed=0):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device) for _ in range(3)]


def _register_builtin_entries():
    global _BUILTINS_DONE
    if _BUILTINS_DONE:
        return
    _BUILTINS_DONE = True

    @register_entry_point("trainer-train-step", f"{_PKG}/nn/basetrainer.py")
    def _entry_trainer_train(device):
        # the step without its telemetry wrapper (JAX: the uncompiled
        # gradient + update); k=2 micro-batches exercise the accumulation
        trainer = _make_deep_trainer(device)
        batches = trainer._stack_batches(_batches(2, 4))

        def step(batches):
            return _state_tree(trainer), _aux(trainer._train(batches))

        return step, (batches,)

    @register_entry_point("trainer-eval-step", f"{_PKG}/nn/basetrainer.py")
    def _entry_trainer_eval(device):
        trainer = _make_deep_trainer(device)
        batch = trainer._stack_batches(_batches(1, 4))[0]
        return (lambda b: trainer.eval_step(b)[:2]), (batch,)

    @register_entry_point("trainer-train-jit", f"{_PKG}/nn/basetrainer.py")
    def _entry_trainer_train_jit(device):
        # the public hot-path step (JAX: the compiled train step)
        trainer = _make_deep_trainer(device)
        batches = trainer._stack_batches(_batches(2, 4))

        def step(batches):
            return _state_tree(trainer), _aux(trainer.train_step(batches))

        return step, (batches,)

    @register_entry_point("trainer-dp-train-step", f"{_PKG}/nn/basetrainer.py")
    def _entry_trainer_dp(device):
        # the trainer's local data parallelism over 8 ranks of the device
        trainer = _make_deep_trainer(device, local_data_parallel=True,
                                     local_ranks=[str(device)] * RANKS)
        batches = trainer._stack_batches(_batches(1, RANKS))

        def step(batches):
            return _state_tree(trainer), _aux(trainer.train_step(batches))

        return step, (batches,)

    @register_entry_point("mesh-federation-dsgd-step", f"{_PKG}/parallel/mesh.py")
    def _entry_mesh_dsgd(device):
        from ..parallel.mesh import MeshFederation

        trainer = _make_deep_trainer(device)
        fed = MeshFederation(trainer, n_sites=RANKS, devices=[str(device)] * RANKS)
        site_batches = {s: _batches(1, 4, seed=s) for s in range(RANKS)}  # (site, k, B, F)

        def step(site_batches):
            return _state_tree(trainer), _aux(fed.train_step(site_batches))

        return step, (site_batches,)

    def _fed_vector_entry(device, n_sites):
        from ..federation.vector import SiteVectorizedFederation

        trainer = _make_deep_trainer(device)
        fed = SiteVectorizedFederation(trainer, n_sites=n_sites,
                                       devices=[str(device)] * RANKS)
        site_batches = [_batches(1, 4, seed=s, mask=True) for s in range(n_sites)]

        def step(site_batches):
            aux = fed.train_step(site_batches)
            state = _state_tree(trainer)
            # one optimizer state for every site (PERF.md "Port faults")
            site_state = {"opt": state["opt_state"], "step": state["step"]}
            return state["params"], site_state, _aux(aux)

        return step, (site_batches,)

    @register_entry_point("fed-vector-step", f"{_PKG}/federation/vector.py")
    def _entry_fed_vector(device):
        # the site axis sharded over the 8 ranks (8 shards)
        return _fed_vector_entry(device, RANKS)

    @register_entry_point("fed-vector-step-vmap", f"{_PKG}/federation/vector.py")
    def _entry_fed_vector_vmap(device):
        # a site count the ranks do not divide: one shard, every site folded
        return _fed_vector_entry(device, RANKS - 3)

    @register_entry_point("powersgd-reducer", f"{_PKG}/parallel/powersgd.py")
    def _entry_powersgd(device):
        import torch

        from ..ops.power_iteration import orthogonalize
        from ..parallel.powersgd import compress_P, compress_Q, reconstruct

        def round_trip(M, Q):
            phat = orthogonalize(compress_P(M, Q))
            qn = compress_Q(M, phat)
            return reconstruct(phat, qn)

        gen = torch.Generator().manual_seed(0)
        M, Q = (torch.randn(shape, generator=gen).to(device) for shape in ((64, 32), (32, 4)))
        return round_trip, (M, Q)

    @register_entry_point("rankdad-reducer", f"{_PKG}/parallel/rankdad.py")
    def _entry_rankdad(device):
        import torch

        from ..ops.power_iteration import power_iteration_BC

        gen = torch.Generator().manual_seed(0)
        B, C = (torch.randn(shape, generator=gen).to(device) for shape in ((32, 16), (32, 8)))

        def fn(B, C):
            # the start block from a fresh generator each run (JAX: a key)
            return power_iteration_BC(B, C, torch.Generator().manual_seed(1), rank=4,
                                      iterations=3)

        return fn, (B, C)

    def _attention_entry(device, shape, attend, **kw):
        import torch

        from ..config.keys import MeshAxis
        from ..parallel.mesh import RankAxis

        axis = RankAxis(MeshAxis.SP, [device] * RANKS)
        blocks = [_split_seq(x, RANKS, axis.devices) for x in _qkv(shape, device)]

        def fn(qs, ks, vs):
            # the output blocks along T, as the shard_map's out_specs
            return torch.cat(attend(qs, ks, vs, axis, **kw), dim=2)

        return fn, tuple(blocks)

    @register_entry_point("ring-attention", f"{_PKG}/parallel/ring_attention.py")
    def _entry_ring(device):
        from ..parallel.ring_attention import ring_attention

        return _attention_entry(device, (2, 4, 64, 8), ring_attention, causal=True)

    @register_entry_point("ulysses-attention", f"{_PKG}/parallel/ring_attention.py")
    def _entry_ulysses(device):
        from ..parallel.ring_attention import ulysses_attention

        # heads divisible by the 8 ranks
        return _attention_entry(device, (2, 8, 64, 8), ulysses_attention)

    def _tsp_inputs(device, b):
        import torch

        gen = torch.Generator().manual_seed(2)
        return (torch.randn((b, 16, 4), generator=gen).to(device),
                torch.randint(0, 2, (b,), generator=gen).to(device))

    def _gather_pp(params):
        from ..parallel.pipeline import gather_pp_params

        return gather_pp_params(params)

    def _gather_tsp(params):
        from ..parallel.sequence import gather_tsp_params

        return gather_tsp_params(params)

    @register_entry_point("pipeline-train-step", f"{_PKG}/parallel/pipeline.py",
                          view=_gathered(_gather_pp))
    def _entry_pipeline(device):
        import torch

        from ..parallel.pipeline import (build_pp_mesh, make_pp_train_step, shard_pp_params,
                                         stack_layers)
        from ..parallel.sequence import TSPConfig, init_tsp_params

        cfg = TSPConfig(num_features=4, num_classes=2, d_model=16, num_heads=4,
                        num_layers=4, max_len=64)
        mesh = build_pp_mesh(pp=4, dp=2, devices=[device] * RANKS)
        step = make_pp_train_step(cfg, mesh)
        params = shard_pp_params(stack_layers(init_tsp_params(
            torch.Generator().manual_seed(0), cfg, device=device)), mesh)
        # per-dp-rank batch 4 divides the 4 microbatches exactly
        return step, (params, *_tsp_inputs(device, 8))

    def _tsp_entry(device, **cfg_kw):
        import torch

        from ..parallel.sequence import (TSPConfig, build_tsp_mesh, init_tsp_params,
                                         make_tsp_train_step, shard_tsp_params)

        cfg = TSPConfig(num_features=4, num_classes=2, d_model=16, num_heads=4,
                        max_len=64, **cfg_kw)
        sizes = dict(dp=2, tp=1, sp=2, ep=2) if cfg.num_experts else dict(dp=2, tp=2, sp=2, ep=1)
        mesh = build_tsp_mesh(**sizes, devices=[device] * RANKS)
        step = make_tsp_train_step(cfg, mesh)
        params = shard_tsp_params(init_tsp_params(torch.Generator().manual_seed(0), cfg,
                                                  device=device), mesh)
        return step, (params, *_tsp_inputs(device, 4))

    @register_entry_point("tsp-train-step", f"{_PKG}/parallel/sequence.py",
                          view=_gathered(_gather_tsp))
    def _entry_tsp(device):
        return _tsp_entry(device, num_layers=2)

    @register_entry_point("tsp-moe-train-step", f"{_PKG}/parallel/sequence.py",
                          view=_gathered(_gather_tsp))
    def _entry_tsp_moe(device):
        return _tsp_entry(device, num_layers=1, num_experts=2)
