"""Federation engines (in-process simulator, fresh process per invocation)
+ single-site runner.

Port of the JAX package's ``engine.py`` for the lockstep path:
:class:`InProcessEngine` runs N site nodes and one aggregator in one
process, relaying each node's output JSON and transfer files the way an
external COINSTAC engine would; :class:`SubprocessEngine` runs every node
invocation as its own ``python <script>`` process, as the COINSTAC engine
does; :class:`SiteRunner` drives one site through a local pretrain with no
aggregator.  Each takes a ``device`` (``cuda`` unless the caller asks for
the CPU) and hands it to every node and trainer (to a child process as
``--device``).

Directory layout per site ``i`` under ``workdir`` (as in the JAX package)::

    site_<i>/            baseDirectory   (site's private data + inbox)
    site_<i>/out         outputDirectory
    remote_base/site_<i> site's transferDirectory == aggregator's inbox
    remote_xfer          aggregator's transferDirectory (broadcast outbox)

Not ported yet (``ROADMAP.md`` Queue 1: the other engines and their
options): chaos fault plans, invocation retries, quorum, async rounds and
run-ahead, elastic membership, telemetry, the daemon/mesh/site-vectorized
engines.
"""
import json
import os
import subprocess
import sys

from . import config
from .config.keys import Phase
from .data import COINNDataHandle
from .nodes import COINNLocal, COINNRemote
from .resilience import transport as wire_transport
from .trainer import COINNTrainer
from .utils import clean_recursive, logger


class InvokeTimeout(RuntimeError):
    """A fresh-process node invocation exceeded the engine's ``timeout``;
    the message carries the partial stderr the process wrote before it was
    killed."""


def load_inputspec(path, site_index=None):
    """Parse a COINSTAC simulator ``inputspec.json`` into plain args: a list
    of per-site ``{key: {"value": ...}}`` dicts (or one shared dict)."""
    if os.path.isdir(path):
        path = os.path.join(path, "inputspec.json")
    with open(path) as f:
        spec = json.load(f)
    if isinstance(spec, dict):
        spec = [spec]

    def unwrap(site_spec):
        return {
            k: (v["value"] if isinstance(v, dict) and "value" in v else v)
            for k, v in site_spec.items()
        }

    sites = [unwrap(s) for s in spec]
    if site_index is None:
        return sites
    site_index = int(site_index)
    if not 0 <= site_index < len(sites):
        raise IndexError(
            f"site_index {site_index} out of range for {len(sites)}-site inputspec"
        )
    return sites[site_index]


class InProcessEngine:
    """Runs N site nodes + one aggregator, relaying outputs and files.

    ``inputspec`` seeds per-site args like the COINSTAC simulator; explicit
    ``**args`` / ``site_args`` win over it."""

    def __init__(self, workdir, n_sites, trainer_cls=COINNTrainer,
                 dataset_cls=None, datahandle_cls=COINNDataHandle,
                 remote_trainer_cls=None, learner_cls=None, reducer_cls=None,
                 site_args=None, inputspec=None, device=None, **args):
        self.device = config.resolve_device(device)
        self.site_spec = {}
        if inputspec is not None:
            per_site = load_inputspec(inputspec)
            if len(per_site) != 1 and len(per_site) != int(n_sites):
                raise ValueError(
                    f"inputspec has {len(per_site)} per-site entries but the "
                    f"engine was built with n_sites={n_sites}; only a "
                    "single-entry spec broadcasts to every site"
                )
            for i in range(int(n_sites)):
                self.site_spec[f"site_{i}"] = per_site[min(i, len(per_site) - 1)]
        self.workdir = str(workdir)
        self.n_sites = int(n_sites)
        self.trainer_cls = trainer_cls
        self.remote_trainer_cls = remote_trainer_cls or trainer_cls
        self.dataset_cls = dataset_cls
        self.datahandle_cls = datahandle_cls
        self.learner_cls = learner_cls
        self.reducer_cls = reducer_cls
        self.args = args
        self.site_args = site_args or {}

        self.site_ids = [f"site_{i}" for i in range(self.n_sites)]
        self.site_caches = {s: {} for s in self.site_ids}
        self.remote_cache = {}
        self.site_states = {}
        for s in self.site_ids:
            base = os.path.join(self.workdir, s)
            xfer = os.path.join(self.workdir, "remote_base", s)
            outd = os.path.join(base, "out")
            for d in (base, xfer, outd):
                os.makedirs(d, exist_ok=True)
            self.site_states[s] = {
                "baseDirectory": base,
                "outputDirectory": outd,
                "transferDirectory": xfer,
                "clientId": s,
            }
        self.remote_state = {
            "baseDirectory": os.path.join(self.workdir, "remote_base"),
            "transferDirectory": os.path.join(self.workdir, "remote_xfer"),
            "outputDirectory": os.path.join(self.workdir, "remote_out"),
        }
        for d in self.remote_state.values():
            os.makedirs(d, exist_ok=True)

        self.site_inputs = {s: {} for s in self.site_ids}
        self.rounds = 0
        self.success = False
        self.last_remote_out = {}
        # the aggregator judges every round against the full consortium
        self.remote_cache["all_sites"] = list(self.site_ids)

    def site_data_dir(self, site_id, data_dir="data"):
        d = os.path.join(self.site_states[site_id]["baseDirectory"], data_dir)
        os.makedirs(d, exist_ok=True)
        return d

    def _relay_broadcast(self):
        """Copy the aggregator's transfer files into every site's inbox —
        atomically, in sorted order, with the wire manifest LAST so it never
        describes a payload not yet delivered."""
        xfer = self.remote_state["transferDirectory"]
        names = sorted(
            os.listdir(xfer), key=lambda f: (f == wire_transport.MANIFEST_NAME, f)
        )
        for f in names:
            for s in self.site_ids:
                wire_transport.atomic_copy(
                    os.path.join(xfer, f),
                    os.path.join(self.site_states[s]["baseDirectory"], f),
                )

    # What differs between engines is only how one node invocation runs:
    # these three hooks.
    def _site_input(self, s):
        """The input of this round's invocation of site ``s``."""
        return self.site_inputs[s]

    def _site_attempt(self, s, inp):
        """One invocation of site ``s``; returns its output."""
        node = COINNLocal(
            cache=self.site_caches[s], input=inp, state=self.site_states[s],
            device=self.device,
            **{**self.site_spec.get(s, {}), **self.args, **self.site_args.get(s, {})},
        )
        return node(
            trainer_cls=self.trainer_cls,
            dataset_cls=self.dataset_cls,
            datahandle_cls=self.datahandle_cls,
            learner_cls=self.learner_cls,
        )["output"]

    def _remote_attempt(self, site_outs):
        """One invocation of the aggregator; returns its output and records
        ``success``."""
        remote = COINNRemote(
            cache=self.remote_cache, input=site_outs, state=self.remote_state,
            device=self.device,
        )
        result = remote(trainer_cls=self.remote_trainer_cls,
                        reducer_cls=self.reducer_cls)
        self.success = bool(result.get("success"))
        return result["output"]

    def step_round(self):
        """One full round: every site computes, the aggregator computes on
        the sites' outputs and files, its output and files relay back.
        Returns ``(site outputs, aggregator output)``."""
        site_outs = {s: self._site_attempt(s, self._site_input(s)) for s in self.site_ids}
        remote_out = self._remote_attempt(site_outs)
        self.last_remote_out = remote_out
        self._relay_broadcast()
        self.site_inputs = {s: dict(remote_out) for s in self.site_ids}
        self.rounds += 1
        return site_outs, remote_out

    def run(self, max_rounds=100000, verbose=False):
        """Drive rounds until the aggregator reports SUCCESS."""
        while not self.success and self.rounds < max_rounds:
            _, remote_out = self.step_round()
            if verbose and logger.lazy_debug(self.rounds):
                logger.info(
                    f"round {self.rounds}: phase={remote_out.get('phase')} "
                    f"epoch={self.remote_cache.get('epoch')}",
                    True,
                )
        return self


class SubprocessEngine(InProcessEngine):
    """The fresh-process engine: every node invocation is ``python <script>
    --device <cpu|cuda>`` with ``{"cache", "input", "state"}`` on stdin,
    and the last JSON line of its stdout, ``{"output", "cache"}``, is the
    result (the contract of the example entry scripts).  The engine keeps
    each node's JSON cache between invocations, as the COINSTAC engine
    does; the live train state survives through
    ``cache['persist_round_state']`` (``nodes/local.py``).

    ``first_input`` (one dict for every site, or a dict per site id) is
    merged into each site's first input, where the node's arguments
    resolve once.  ``env`` is the children's environment (default this
    process's); ``timeout`` bounds each invocation in seconds."""

    def __init__(self, workdir, n_sites, local_script, remote_script,
                 first_input=None, env=None, timeout=600, device=None, **kw):
        super().__init__(workdir, n_sites, device=device, **kw)
        # the in-process argument channels never reach a child process: a
        # silently different configuration is worse than an error
        if self.args or self.site_args or self.site_spec:
            raise ValueError(
                "SubprocessEngine nodes run in their own processes: engine "
                "**args / site_args / inputspec are not shipped to them; "
                "pass node args via first_input (merged into the first "
                "invocation's input)"
            )
        self.local_script = str(local_script)
        self.remote_script = str(remote_script)
        self.env = env
        self.timeout = timeout
        first_input = first_input or {}
        if not any(s in first_input for s in self.site_ids):
            first_input = {s: dict(first_input) for s in self.site_ids}
        self.first_input = first_input
        self._first_done = set()

    def _invoke(self, script, payload):
        """Run ``script`` once on ``payload``; returns its result dict."""
        try:
            res = subprocess.run(
                [sys.executable, script, "--device", self.device.type],
                input=json.dumps(clean_recursive(payload)),
                capture_output=True, text=True, env=self.env, timeout=self.timeout,
            )
        except subprocess.TimeoutExpired as exc:
            stderr = exc.stderr or ""
            if isinstance(stderr, bytes):
                stderr = stderr.decode("utf-8", "replace")
            raise InvokeTimeout(
                f"{script} timed out after {self.timeout}s\n"
                f"--- partial stderr ---\n{stderr[-4000:]}"
            ) from exc
        if res.returncode != 0:
            raise RuntimeError(
                f"{script} exited rc={res.returncode}\n--- stderr ---\n{res.stderr[-4000:]}"
            )
        # the node may print log lines: the LAST JSON line is the result
        for line in reversed(res.stdout.strip().splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except ValueError:
                    continue
        raise RuntimeError(f"{script} produced no JSON result\n--- stdout ---\n{res.stdout[-2000:]}")

    def _site_input(self, s):
        inp = dict(self.site_inputs[s])
        if s not in self._first_done:
            inp.update(self.first_input.get(s, {}))
            self._first_done.add(s)
        return inp

    def _site_attempt(self, s, inp):
        res = self._invoke(self.local_script, {
            "cache": self.site_caches[s], "input": inp, "state": self.site_states[s],
        })
        self.site_caches[s] = res.get("cache", {})
        return res["output"]

    def _remote_attempt(self, site_outs):
        res = self._invoke(self.remote_script, {
            "cache": self.remote_cache, "input": site_outs, "state": self.remote_state,
        })
        self.remote_cache = res.get("cache", {})
        self.success = bool(res.get("success"))
        return res["output"]


class SiteRunner:
    """Single-site, no-engine debug harness: drives a site through
    INIT_RUNS then NEXT_RUN with ``pretrain=True`` so the full local
    training loop runs without an aggregator.  The directory layout matches
    the COINSTAC simulator's ``input/local{i}/simulatorRun``."""

    def __init__(self, workdir, task_id="task", site_id=None, inputspec=None,
                 site_index=0, device=None, **args):
        self.device = config.resolve_device(device)
        self.workdir = str(workdir)
        if site_id is None:
            site_id = f"local{int(site_index)}"
        if inputspec is not None:
            args = {**load_inputspec(inputspec, site_index=site_index), **args}
        base = os.path.join(self.workdir, "input", site_id, "simulatorRun")
        outd = os.path.join(self.workdir, "output", site_id)
        xfer = os.path.join(self.workdir, "transfer", site_id)
        for d in (base, outd, xfer):
            os.makedirs(d, exist_ok=True)
        self.state = {
            "baseDirectory": base,
            "outputDirectory": outd,
            "transferDirectory": xfer,
            "clientId": site_id,
        }
        args.setdefault("task_id", task_id)
        args.setdefault("pretrain_args", {"epochs": args.get("epochs", 10)})
        self.args = args
        self.cache = {}

    @property
    def data_dir(self):
        d = os.path.join(self.state["baseDirectory"], self.args.get("data_dir", "data"))
        os.makedirs(d, exist_ok=True)
        return d

    def run(self, trainer_cls, dataset_cls=None, datahandle_cls=COINNDataHandle):
        node = COINNLocal(cache=self.cache, input={}, state=self.state,
                          device=self.device, **self.args)
        node(trainer_cls=trainer_cls, dataset_cls=dataset_cls,
             datahandle_cls=datahandle_cls)
        nxt = {
            "phase": Phase.NEXT_RUN.value,
            "global_runs": {
                self.state["clientId"]: {
                    "split_ix": "0", "seed": self.cache.get("seed", 0),
                    "pretrain": True,
                }
            },
        }
        node = COINNLocal(cache=self.cache, input=nxt, state=self.state,
                          device=self.device, **self.args)
        out = node(trainer_cls=trainer_cls, dataset_cls=dataset_cls,
                   datahandle_cls=datahandle_cls)
        return out["output"]
