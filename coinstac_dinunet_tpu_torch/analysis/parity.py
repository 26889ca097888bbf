"""proto-num-parity: the tier-7 bit-parity prover (dynamic half) over the
port — the JAX package's ``analysis/parity.py``.

The port's acceptance rests on the same claimed equivalences as the JAX
package's: run-ahead ``d=0`` drains to the serial schedule, async ``k=0``
+ pool-1 is the lockstep template, mmap fan-in loads equal heap copies,
the site-vectorized engine matches the file transport, and a factored
codec at full rank is exact (PowerSGD).  This prover enumerates those
five contracts and EXECUTES both arms — the engine-backed ones through
the port's real :class:`~..engine.InProcessEngine` round loop with the
JAX package's pure-numpy stubs under virtual time (the tier-5 explorer's
seams: an inline pool, no wall-clock grace), the wire-backed one through
the port's real COINNTW2 save/load path, the transport and codec models
as the same two-implementation numpy recurrences — and compares the
per-round trajectories under a ULP-aware comparator.  The stubs, the
seeds and the recurrences are the JAX package's, so each contract's
per-round trajectories equal the JAX prover's bit for bit.

Site gradients are magnitude-spread (×10³ per site) so summation ORDER
changes bits.  On mismatch the prover bisects to the first diverging
round, scans that round for the first diverging tensor, and emits a
``proto-num-parity`` finding anchored at the port's seam whose contract
broke (the vectorized contract at ``SiteVectorizedFederation.train_step``,
the port's stacked reduce), plus a replayable parity plan JSON
(``--parity-plans``) that :func:`replay_parity` re-executes.  The
``_BREAK_*`` switches (tests and ``chip_smoke.py`` only) model one broken
semantics per contract.  Numpy only: no torch tensor is computed.
"""
import ast
import json
import math
import os
import tempfile

import numpy as np

from ..config.keys import Numerics

#: broken-semantics switches (tests only; the tier-4/5 idiom).  One per
#: contract: an off-schedule eps on the run-ahead arm's reduce, the async
#: arm re-using its round-0 derived key, a tainted mmap view, the
#: vectorized arm stacking its fan-in unsorted, and the codec silently
#: dropping a rank.
_BREAK_RUN_AHEAD_EPS = False
_BREAK_ASYNC_REUSED_KEY = False
_BREAK_MMAP_TAINT = False
_BREAK_UNSORTED_FAN_IN = False
_BREAK_RANK_DROP = False

#: the five claimed equivalence contracts, by scenario name
CONTRACTS = (
    "async-k0-pool1-vs-lockstep",
    "codec-full-rank-vs-dense",
    "mmap-vs-copy",
    "run-ahead-0-vs-serial",
    "vectorized-vs-file-transport",
)

PARITY_RULE_IDS = (
    Numerics.CONFIG,
    Numerics.PARITY,
)

_INVARIANTS = {
    "run-ahead-0-vs-serial":
        "run_ahead=0 drains to the serial round schedule bit-identically",
    "async-k0-pool1-vs-lockstep":
        "async k=0 + pool-1 is the lockstep template bit-identically",
    "mmap-vs-copy":
        "mmap fan-in views load bit-identically to heap copies",
    "vectorized-vs-file-transport":
        "the vectorized reduce equals the sequential file-transport reduce",
    "codec-full-rank-vs-dense":
        "the factored codec at full rank reconstructs the dense wire exactly",
}


class ParityConfig:
    """Prover bound: ``sites`` × ``rounds`` per scenario, and the base
    seed every arm's gradient stream derives from."""

    def __init__(self, sites=None, rounds=None, seed=7):
        self.sites = int(sites if sites is not None
                         else Numerics.DEFAULT_SITES)
        self.rounds = int(rounds if rounds is not None
                          else Numerics.DEFAULT_ROUNDS)
        self.seed = int(seed)

    def scenario(self):
        return {"sites": self.sites, "rounds": self.rounds,
                "seed": self.seed}


class ParityResult:
    def __init__(self, findings, plans, report):
        self.findings = findings
        self.plans = plans
        self.report = report


# ------------------------------------------------------ ULP-aware compare
def ulp_diff(a, b):
    """Elementwise ULP distance between two same-shape/same-dtype float
    arrays as exact Python ints (an object array), 0 == bit-identical.
    Any shape/dtype mismatch is ``inf`` — there is no meaningful ULP
    between different types."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return np.array(math.inf)
    if a.dtype.kind not in "f":
        eq = (a == b)
        return np.where(eq, 0, math.inf) if a.size else np.zeros(0, object)
    itype = {2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize]
    min_int = int(np.iinfo(itype).min)
    # IEEE bit patterns → monotonically ordered ints (exact object math:
    # the distance between opposite-sign floats overflows fixed width)
    ia = a.view(itype).ravel().astype(object)
    ib = b.view(itype).ravel().astype(object)
    oa = np.where(ia >= 0, ia, min_int - ia)
    ob = np.where(ib >= 0, ib, min_int - ib)
    return np.abs(oa - ob).reshape(a.shape)


def max_ulp_diff(a, b):
    """The worst elementwise ULP distance (int, or ``math.inf`` on a
    shape/dtype mismatch); 0 means bit-identical."""
    d = ulp_diff(a, b)
    if not d.size:
        return 0
    m = d.max()
    return m if m == math.inf else int(m)


def tree_max_ulp(tree_a, tree_b):
    """Per-tensor worst ULP distance between two ``{name: array}`` dicts;
    a key present on one side only maps to ``inf``."""
    out = {}
    for name in sorted(set(tree_a) | set(tree_b)):
        if name not in tree_a or name not in tree_b:
            out[name] = math.inf
        else:
            out[name] = max_ulp_diff(tree_a[name], tree_b[name])
    return out


# ------------------------------------------------------- gradient streams
def _site_grad(seed, site, rnd, dim=8):
    """Site ``site``'s round-``rnd`` gradient: a seeded deterministic
    stream, magnitude-spread ×10³ per site so summation order changes
    bits (the float64 mantissa holds ~15.9 decimal digits — three sites
    span 10⁶, well inside exact representation but far outside
    order-invariant addition)."""
    gen = np.random.Generator(
        np.random.PCG64(seed * 100003 + site * 31 + rnd)
    )
    scale = 10.0 ** (3 * (site % 5))
    return scale * (1.0 + gen.random(dim))


# ------------------------------------------------------ engine-backed arms
class _InlinePool:
    """Submit-runs-inline executor: the async path's futures are complete
    before the collect phase ever looks — virtual time, zero wall-clock,
    and (with k=0) the exact lockstep delivery the contract claims."""

    def submit(self, fn, *args, **kwargs):
        from concurrent.futures import Future

        fut = Future()
        fut.set_running_or_notify_cancel()
        try:
            fut.set_result(fn(*args, **kwargs))
        except BaseException as exc:  # noqa: BLE001 — future contract
            fut.set_exception(exc)
        return fut

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def _make_parity_engine(workdir, config, arm, **engine_kwargs):
    """A real :class:`~..engine.InProcessEngine` whose node invocations
    are pure-numpy stubs shipping REAL COINNTW2 payloads; the aggregator
    stub runs the sorted-site mean + weight update and records the
    per-round trajectory.  Deferred import so the static tier never pays
    the engine import."""
    from ..config.keys import Mode, Phase
    from ..engine import InProcessEngine
    from ..utils.tensorutils import load_arrays, save_arrays

    seed = config.seed

    class _ParityEngine(InProcessEngine):
        _ASYNC_POOL_CAP = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._parity_pool = _InlinePool()
            self._parity_w = np.zeros(8, dtype=np.float64)
            self.trajectory = []

        def _ensure_async_pool(self, size):
            return self._parity_pool

        def _async_grace(self):
            return None  # virtual time: futures are already complete

        def _site_attempt(self, rnd, s, inp, rec):
            ix = int(s.rsplit("_", 1)[1])
            draw = rnd
            if _BREAK_ASYNC_REUSED_KEY and arm == "async":
                # broken semantics: the async arm re-uses its round-0
                # derived key — every round replays round 0's stream
                draw = 0
            with rec.span(f"invoke:{s}", cat="invoke", round=rnd):
                save_arrays(
                    os.path.join(
                        self.site_states[s]["transferDirectory"],
                        "grads.npy",
                    ),
                    [_site_grad(seed, ix, draw)],
                )
            return {
                "phase": Phase.COMPUTATION.value, "mode": Mode.TRAIN.value,
                "reduce": True, "grads_file": "grads.npy", "wire_round": rnd,
            }

        def _remote_attempt(self, rnd, site_outs, rec):
            with rec.span("invoke:remote", cat="invoke"):
                total, n = np.zeros(8, dtype=np.float64), 0
                for s in sorted(site_outs):
                    out = site_outs[s]
                    if not out.get("reduce"):
                        continue
                    arrays = load_arrays(os.path.join(
                        self.site_states[s]["transferDirectory"],
                        out["grads_file"],
                    ))
                    total = total + np.asarray(arrays[0], dtype=np.float64)
                    n += 1
                avg = total / max(n, 1)
                if _BREAK_RUN_AHEAD_EPS and arm == "run_ahead":
                    # broken semantics: the pipelined arm's reduce drifts
                    # by one eps — d=0 is no longer the serial schedule
                    avg = avg * (1.0 + 2.0 ** -48)
                self._parity_w = self._parity_w - 0.1 * avg
                self.trajectory.append({
                    "avg_grads": avg.copy(), "w": self._parity_w.copy(),
                })
                save_arrays(
                    os.path.join(self.remote_state["transferDirectory"],
                                 "avg_grads.npy"),
                    [avg],
                )
            return {"phase": Phase.COMPUTATION.value, "update": True,
                    "avg_grads_file": "avg_grads.npy"}

    # the stubs are numpy: the engine's own device is the CPU's
    return _ParityEngine(workdir, config.sites, device="cpu", telemetry=True,
                         **engine_kwargs)


def _engine_trajectory(workdir, config, arm, **engine_kwargs):
    eng = _make_parity_engine(workdir, config, arm, **engine_kwargs)
    try:
        for _ in range(config.rounds):
            eng.step_round()
        return list(eng.trajectory)
    finally:
        eng.close()


# --------------------------------------------------------- wire-backed arm
def _mmap_arm(workdir, config, mmap):
    """The real COINNTW2 save → ``load_arrays_many(mmap=...)`` → sorted
    fan-in sum, as a per-round recurrence."""
    from ..utils.tensorutils import load_arrays_many, save_arrays

    os.makedirs(workdir, exist_ok=True)
    w = np.zeros(8, dtype=np.float64)
    traj = []
    for rnd in range(1, config.rounds + 1):
        paths = []
        for i in range(config.sites):
            p = os.path.join(workdir, f"r{rnd}_site_{i}.npy")
            save_arrays(p, [_site_grad(config.seed, i, rnd)])
            paths.append(p)
        arrays = load_arrays_many(sorted(paths), mmap=mmap)
        vals = [np.array(a[0], dtype=np.float64, copy=True) for a in arrays]
        if _BREAK_MMAP_TAINT and mmap:
            # broken semantics: the mapped view is no longer the bytes on
            # disk — the LARGEST operand drifts by an eps (a drift on the
            # smallest would drown below one ulp of the spread-magnitude
            # total, which is the point of the spread)
            vals[-1] = vals[-1] * (1.0 + 2.0 ** -48)
        total = np.zeros(8, dtype=np.float64)
        for v in vals:
            total = total + v
        avg = total / max(config.sites, 1)
        w = w - 0.1 * avg
        traj.append({"avg_grads": avg, "w": w.copy()})
    return traj


# ------------------------------------------------------ transport/codec arms
def _transport_arm(config, vectorized):
    """File transport (sequential per-site loop, ascending site order) vs
    the vectorized engine's stacked reduce of the SAME recurrence."""
    w = np.zeros(8, dtype=np.float64)
    traj = []
    for rnd in range(1, config.rounds + 1):
        grads = [0.5 * w + _site_grad(config.seed, i, rnd)
                 for i in range(config.sites)]
        if vectorized:
            if _BREAK_UNSORTED_FAN_IN:
                # broken semantics: the stacked fan-in loses its sorted
                # site order — fp addition does not commute bitwise
                grads = grads[::-1]
            total = np.add.reduce(np.stack(grads), axis=0)
        else:
            total = np.zeros(8, dtype=np.float64)
            for g in grads:
                total = total + g
        avg = total / max(config.sites, 1)
        w = w - 0.1 * avg
        traj.append({"avg_grads": avg, "w": w.copy()})
    return traj


def _codec_arm(config, codec):
    """Dense wire vs the PowerSGD-shaped P/Q factorization at FULL rank:
    ``P`` is a seeded permutation basis (orthonormal, spans everything),
    so ``P @ (P.T @ G)`` must reproduce ``G`` bit-for-bit."""
    p_dim, q_dim = 6, 3
    gen = np.random.Generator(np.random.PCG64(config.seed * 7919))
    P = np.eye(p_dim, dtype=np.float64)[:, gen.permutation(p_dim)]
    if _BREAK_RANK_DROP and codec:
        # broken semantics: the codec silently drops one rank — full rank
        # is no longer full, the reconstruction zeroes a row
        P = P[:, :-1]
    w = np.zeros((p_dim, q_dim), dtype=np.float64)
    traj = []
    for rnd in range(1, config.rounds + 1):
        G = np.stack([
            _site_grad(config.seed, i, rnd, dim=q_dim)[:q_dim]
            for i in range(p_dim)
        ]) * (1.0 + rnd / 7.0)
        if codec:
            Q = P.T @ G           # wire: the factored payload
            G_recv = P @ Q        # receiver: reconstruct
        else:
            G_recv = G            # dense wire
        w = w - 0.1 * G_recv
        traj.append({"recon_grads": G_recv, "w": w.copy()})
    return traj


# -------------------------------------------------------------- contracts
def _run_contract(name, config, workdir):
    """Both arms of one contract → (trajectory_a, trajectory_b), the
    reference arm first."""
    if name == "run-ahead-0-vs-serial":
        a = _engine_trajectory(os.path.join(workdir, "serial"), config,
                               "serial")
        b = _engine_trajectory(os.path.join(workdir, "run_ahead"), config,
                               "run_ahead", run_ahead=0)
        return a, b
    if name == "async-k0-pool1-vs-lockstep":
        a = _engine_trajectory(os.path.join(workdir, "lockstep"), config,
                               "lockstep")
        b = _engine_trajectory(os.path.join(workdir, "async"), config,
                               "async", async_staleness=0,
                               async_invoke_pool=1)
        return a, b
    if name == "mmap-vs-copy":
        a = _mmap_arm(os.path.join(workdir, "copy"), config, mmap=False)
        b = _mmap_arm(os.path.join(workdir, "mmap"), config, mmap=True)
        return a, b
    if name == "vectorized-vs-file-transport":
        return (_transport_arm(config, vectorized=False),
                _transport_arm(config, vectorized=True))
    if name == "codec-full-rank-vs-dense":
        return (_codec_arm(config, codec=False),
                _codec_arm(config, codec=True))
    raise ValueError(f"unknown parity contract: {name!r}")


def _round_divergence(ta, tb, r, max_ulp):
    """The first diverging tensor of round ``r`` as (tensor, ulp), or
    None when the round matches within ``max_ulp``."""
    per = tree_max_ulp(ta[r], tb[r])
    for tensor in sorted(per):
        if per[tensor] > max_ulp:
            return tensor, per[tensor]
    return None


def _first_divergence(ta, tb, max_ulp=0):
    """Bisect to the FIRST diverging round (the arms are deterministic
    recurrences through the carried weight state — once diverged, every
    later round stays diverged), then scan that round for its first
    diverging tensor.  Returns ``{"round", "tensor", "ulp"}`` (1-based
    round), or None when the trajectories agree."""
    n = min(len(ta), len(tb))
    if n and _round_divergence(ta, tb, n - 1, max_ulp) is None:
        if len(ta) != len(tb):
            return {"round": n + 1, "tensor": "<trajectory>",
                    "ulp": math.inf}
        return None
    if not n:
        return ({"round": 1, "tensor": "<trajectory>", "ulp": math.inf}
                if len(ta) != len(tb) else None)
    lo, hi = 0, n - 1  # invariant: round hi diverges
    while lo < hi:
        mid = (lo + hi) // 2
        if _round_divergence(ta, tb, mid, max_ulp) is not None:
            hi = mid
        else:
            lo = mid + 1
    tensor, ulp = _round_divergence(ta, tb, lo, max_ulp)
    return {"round": lo + 1, "tensor": tensor, "ulp": ulp}


# ---------------------------------------------------------------- anchors
#: contract -> (module kind, class-or-None, function) the finding anchors
#: to — the real seam whose claimed equivalence broke.
def _anchor_for(contract):
    cls = None
    if contract == "run-ahead-0-vs-serial":
        from .. import engine as mod

        cls, func = "InProcessEngine", "_step_round_async"
    elif contract == "async-k0-pool1-vs-lockstep":
        from .. import engine as mod

        cls, func = "InProcessEngine", "_async_config"
    elif contract == "mmap-vs-copy":
        from ..utils import tensorutils as mod

        func = "load_arrays"
    elif contract == "vectorized-vs-file-transport":
        from ..federation import vector as mod

        func = "train_step"
    else:
        from ..parallel import powersgd as mod

        func = "reconstruct"
    path = os.path.relpath(mod.__file__).replace(os.sep, "/")
    line = 1
    try:
        with open(mod.__file__, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read())
        fallback = None
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name == func:
                fallback = fallback or node.lineno
        for node in tree.body:
            if cls and isinstance(node, ast.ClassDef) and node.name == cls:
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) and sub.name == func:
                        return path, sub.lineno
            elif cls is None and isinstance(node, ast.FunctionDef) \
                    and node.name == func:
                return path, node.lineno
        if fallback:
            line = fallback
    except (OSError, SyntaxError, ValueError):
        pass
    return path, line


def _switch_states():
    return {
        "_BREAK_RUN_AHEAD_EPS": _BREAK_RUN_AHEAD_EPS,
        "_BREAK_ASYNC_REUSED_KEY": _BREAK_ASYNC_REUSED_KEY,
        "_BREAK_MMAP_TAINT": _BREAK_MMAP_TAINT,
        "_BREAK_UNSORTED_FAN_IN": _BREAK_UNSORTED_FAN_IN,
        "_BREAK_RANK_DROP": _BREAK_RANK_DROP,
    }


# -------------------------------------------------------------- the prover
def prove_contract(name, config=None, workdir=None, max_ulp=0):
    """Run one contract's two arms and compare.  Returns the divergence
    dict (``{"contract", "round", "tensor", "ulp"}``) or None when the
    contract holds."""
    config = config or ParityConfig()
    if workdir is not None:
        ta, tb = _run_contract(name, config, workdir)
    else:
        with tempfile.TemporaryDirectory(prefix="tier7-parity-") as wd:
            ta, tb = _run_contract(name, config, wd)
    div = _first_divergence(ta, tb, max_ulp=max_ulp)
    if div is None:
        return None
    div = dict(div, contract=name)
    return div


def replay_parity(plan, workdir=None):
    """Re-execute a parity plan JSON under ITS recorded switch states;
    returns the divergence dicts the replay produced (the regression-
    test contract: the same round + tensor diverge again — and a plan
    replayed against the fixed tree, switches off, comes back clean)."""
    import sys

    mod = sys.modules[__name__]
    scenario = dict(plan.get("scenario") or {})
    config = ParityConfig(sites=scenario.get("sites"),
                          rounds=scenario.get("rounds"),
                          seed=scenario.get("seed", 7))
    saved = _switch_states()
    try:
        for switch, value in (plan.get("switches") or {}).items():
            if switch in saved:
                setattr(mod, switch, bool(value))
        div = prove_contract(plan["contract"], config, workdir=workdir)
    finally:
        for switch, value in saved.items():
            setattr(mod, switch, value)
    return [div] if div else []


def run_parity_prover(config=None, plans_dir=None, contracts=None):
    """Prove every claimed equivalence contract; returns a
    :class:`ParityResult` whose findings flow through the same baseline
    machinery as tiers 1–6."""
    config = config or ParityConfig()
    report = {"contracts_run": 0, "violations": 0, "proved": []}
    findings, plans = [], []
    from .core import Finding

    try:
        with tempfile.TemporaryDirectory(prefix="dinulint-tier7-") as root:
            for name in (contracts or CONTRACTS):
                div = prove_contract(
                    name, config,
                    workdir=os.path.join(root, name.replace("/", "_")),
                )
                report["contracts_run"] += 1
                if div is None:
                    report["proved"].append(name)
                    continue
                report["violations"] += 1
                path, line = _anchor_for(name)
                ulp = div["ulp"]
                plan = {
                    "comment": (
                        "dinulint tier-7 parity counterexample — replay "
                        "with coinstac_dinunet_tpu_torch.analysis.parity."
                        "replay_parity(<this file>)"
                    ),
                    "rule": Numerics.PARITY,
                    "contract": name,
                    "invariant": _INVARIANTS[name],
                    "scenario": config.scenario(),
                    "switches": _switch_states(),
                    "violation": {
                        "round": int(div["round"]),
                        "tensor": div["tensor"],
                        "ulp": ("inf" if ulp == math.inf else int(ulp)),
                    },
                }
                findings.append(Finding(
                    rule=Numerics.PARITY, path=path, line=line, col=0,
                    message=(
                        f"parity contract '{name}' "
                        f"({_INVARIANTS[name]}) diverged at round "
                        f"{div['round']}, tensor '{div['tensor']}' "
                        f"(max {plan['violation']['ulp']} ulp) under "
                        f"{config.sites} sites x {config.rounds} rounds "
                        "— replayable parity plan JSON via --parity-plans"
                    ),
                ))
                plans.append(plan)
    except Exception as exc:  # noqa: BLE001 — typed error channel
        f = Finding(
            rule=Numerics.CONFIG, path="coinstac_dinunet_tpu_torch", line=1,
            col=0,
            message=(
                "the tier-7 parity prover could not run: "
                f"{type(exc).__name__}: {exc}"
            ),
        )
        return ParityResult([f], [None], report)

    order = sorted(range(len(findings)), key=lambda i: findings[i].rule)
    findings = [findings[i] for i in order]
    plans = [plans[i] for i in order]
    if plans_dir:
        os.makedirs(plans_dir, exist_ok=True)
        for n, (f, plan) in enumerate(zip(findings, plans)):
            if not plan:
                continue
            name = f"{plan['contract']}-{n:02d}.json"
            with open(os.path.join(plans_dir, name), "w",
                      encoding="utf-8") as fh:
                json.dump(plan, fh, indent=2, sort_keys=True)
                fh.write("\n")
    return ParityResult(findings, plans, report)
