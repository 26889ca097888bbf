"""COINNReducer — the aggregator-side half of a dSGD round (PyTorch port).

Port of the JAX package's ``parallel/reducer.py``: load every site's
gradient payload (fan-in in sorted order), take the participation-weighted
mean on the device — sites whose payload holds a non-finite value are left
out (``cache['guard_nonfinite']``, default on) — and ship the mean back
through :func:`..utils.tensorutils.save_wire`, so at ``precision_bits=8``
the aggregator quantizes on the device too.  Under staleness-bounded async
rounds a contribution ``j`` rounds stale (``cache['site_staleness']``) is
weighed ``gamma**j`` (``cache['async_stale_discount']``, default 0.5); the
PowerSGD and rankDAD reducers read the same weights.  The opt-in capacity
weighting (``cache['capacity_weight']``) scales each site by its observed
throughput (``cache['site_capacity']``) over the round's mean, and once
the roster has churned (roster epoch > 1) the weights are re-centred to
mean 1 over the round's sites, so ``max(sum(w), 1)`` never floors them.

With ``cache['reduce_fanin'] = k >= 2`` and more than ``k`` sites, the dSGD
mean streams through a k-ary tree (:meth:`COINNReducer._tree_average`):
each group of ``k`` site payloads becomes a weighted partial SUM and its
weight total (:func:`guarded_partial`), committed through the atomic wire
transport into ``.tree_reduce/`` under the output directory; higher levels
add ``k`` partials at a time and the root divides once.  Peak memory is
``k`` payloads, not ``n``, and the result equals the flat guarded mean to
float32 rounding.

The health layer, as in the JAX package.  A site the watchdog quarantined
(``cache['quarantined_sites']``, opt-in ``cache['quarantine_on_anomaly']``)
weighs 0 in the mean (:meth:`COINNReducer._apply_quarantine`), the path the
non-finite guard takes.  With telemetry on, every flat mean records each
site's cosine to the mean (:func:`site_cosines`, NaN for a non-finite
site), the dispersion and the survivors, and runs the watchdog over them;
the quarantine is applied before the series (so they describe the mean
applied) and again after (a quarantine issued on this round's series takes
effect at once).  The tree records the same series from a second streaming
pass against the root mean (:func:`cosine_block`); there a quarantine
issued this round takes effect from the next.  The cosines are float32
sums in torch's order, not XLA's: they agree with the JAX package's to a
stated tolerance, not bit for bit.  A skipped non-finite site is a
``reduce:nonfinite_skip`` event, a reduce a ``reduce:dSGD`` (and a tree one
a ``reduce:tree``) event on the ambient recorder.

The fan-in maps each site payload read-only by default
(``cache['wire_mmap']``, :meth:`COINNReducer._wire_mmap`): the payloads are
verified over the maps, and each leaf's site values are staged from the
read-only views into the reducer's own host buffer (pinned when the
reducer is on the card) and copied to the device from there, so a view is
never handed to torch.  The mean is the heap path's bit for bit.  The
tree drops its views before its spill directory is removed.

What differs from the JAX package: a discounted reduce lands one
``async:discount`` event (``gamma`` and every site's weight) on the
ambient recorder, which the JAX package does not write.
"""
import os
import shutil

import numpy as np
import torch

from .. import config, telemetry
from ..config.keys import Federation, Membership
from ..telemetry import health as _health
from ..resilience.retry import RetryPolicy
from ..utils import logger, tensorutils


def guarded_mean(leaves, w0):
    """Participation-weighted site mean of each ``(n_sites, ...)`` leaf,
    leaving out every site with a non-finite value in any leaf → ``(means,
    site_ok)``.  ``sum(w·x) / max(sum(w), 1)`` as in the JAX package's
    ``_guarded_mean``."""
    ok = torch.ones(leaves[0].shape[0], dtype=torch.bool, device=w0.device)
    for x in leaves:
        ok &= torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
    w = ok.to(torch.float32) * w0
    denom = torch.clamp_min(w.sum(), 1.0)
    means = [
        torch.tensordot(w, torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0),
                        dims=([0], [0])) / denom
        for x in leaves
    ]
    return means, ok


def stacked_mean(leaves, w0):
    """Unguarded participation-weighted site mean of each leaf."""
    denom = torch.clamp_min(w0.sum(), 1.0)
    return [torch.tensordot(w0, x, dims=([0], [0])) / denom for x in leaves]


def guarded_partial(leaves, w0):
    """One tree group's share of :func:`guarded_mean`: the weighted partial
    SUMS of each leaf and the group's weight total, non-finite sites left
    out of both → ``(sums, wtot, site_ok)``.  Partials of any grouping add
    up to the flat numerator and denominator."""
    ok = torch.ones(leaves[0].shape[0], dtype=torch.bool, device=w0.device)
    for x in leaves:
        ok &= torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
    w = ok.to(torch.float32) * w0
    sums = [torch.tensordot(w, torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0),
                            dims=([0], [0]))
            for x in leaves]
    return sums, w.sum(), ok


def _site_ok(leaves):
    """``(n_sites,)`` bool: the sites with no non-finite value in any leaf."""
    ok = torch.ones(leaves[0].shape[0], dtype=torch.bool, device=leaves[0].device)
    for x in leaves:
        ok &= torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
    return ok


def _flat_finite(x, n):
    """A site-stacked leaf as ``(n, -1)`` float32, non-finite values 0."""
    return torch.nan_to_num(x.to(torch.float32).reshape(n, -1),
                            nan=0.0, posinf=0.0, neginf=0.0)


def site_cosines(leaves, w0):
    """Each site's agreement with the consensus: the cosine of its flat
    payload vector against the participation-weighted mean over the finite
    sites, accumulated leaf by leaf in float32 (never a second full copy of
    the payloads).  A non-finite site gets NaN — the attribution of who
    corrupted the round.  The JAX package's ``site_cosines``."""
    n = leaves[0].shape[0]
    ok = _site_ok(leaves)
    w = ok.to(torch.float32) * w0.to(torch.float32)
    denom = torch.clamp_min(w.sum(), 1.0)
    dots = torch.zeros(n, dtype=torch.float32, device=w.device)
    norms2 = torch.zeros(n, dtype=torch.float32, device=w.device)
    mnorm2 = torch.zeros((), dtype=torch.float32, device=w.device)
    for x in leaves:
        v = _flat_finite(x, n)
        mean = torch.tensordot(w, v, dims=([0], [0])) / denom
        dots = dots + v @ mean
        norms2 = norms2 + torch.sum(torch.square(v), dim=1)
        mnorm2 = mnorm2 + torch.sum(torch.square(mean))
    cos = dots / torch.clamp_min(torch.sqrt(norms2) * torch.sqrt(mnorm2), 1e-30)
    return torch.where(ok, cos, torch.full_like(cos, float("nan")))


def mean_norm2(mean_leaves):
    """float32 squared norm of a mean, over its leaves."""
    return sum(torch.sum(torch.square(m.to(torch.float32))) for m in mean_leaves)


def cosine_block(leaves, mean_leaves, mnorm2):
    """Each site's cosine against a given (root) mean whose squared norm
    is ``mnorm2`` — the tree's streaming second pass over one group →
    ``(cos, site_ok)``, NaN marking a non-finite site.  The JAX package's
    ``_cosine_block``."""
    n = leaves[0].shape[0]
    ok = _site_ok(leaves)
    dots = torch.zeros(n, dtype=torch.float32, device=ok.device)
    norms2 = torch.zeros(n, dtype=torch.float32, device=ok.device)
    for x, m in zip(leaves, mean_leaves):
        v = _flat_finite(x, n)
        dots = dots + v @ m.to(torch.float32).reshape(-1)
        norms2 = norms2 + torch.sum(torch.square(v), dim=1)
    cos = dots / torch.clamp_min(torch.sqrt(norms2) * torch.sqrt(mnorm2), 1e-30)
    return torch.where(ok, cos, torch.full_like(cos, float("nan"))), ok


def plain_partial(leaves, w0):
    """Unguarded counterpart of :func:`guarded_partial` → ``(sums, wtot)``."""
    return [torch.tensordot(w0, x, dims=([0], [0])) for x in leaves], w0.sum()


class COINNReducer:
    """Baseline gradient-averaging reducer (runs on the aggregator node)."""

    def __init__(self, trainer=None, **kw):
        self.trainer = trainer
        self.device = trainer.device
        self.cache = trainer.cache
        self.input = trainer.input
        self.state = trainer.state

    @property
    def precision_bits(self):
        return self.cache.get("precision_bits", config.default_precision_bits)

    def _site_path(self, site, fname):
        """Site payloads appear under ``baseDirectory/<site>/``."""
        return os.path.join(self.state.get("baseDirectory", "."), str(site), fname)

    def _wire_mmap(self):
        """Whether fan-in loads map the payload files
        (``cache['wire_mmap']``, default on)."""
        v = self.cache.get(Federation.WIRE_MMAP)
        return True if v is None else bool(v)

    def _load(self, file_key):
        """One payload per site (site order: sorted site id), under the wire
        retry policy."""
        sites = sorted(self.input.keys())
        paths = [self._site_path(s, self.input[s][file_key]) for s in sites]
        return tensorutils.load_arrays_many(paths, retry=RetryPolicy.for_wire(self.cache),
                                            mmap=self._wire_mmap())

    def _save_out(self, fname, arrays):
        """Outbound (aggregator → sites) payload at the wire precision; the
        rounding seed is salted apart from every site's."""
        d = self.state.get("transferDirectory", ".")
        os.makedirs(d, exist_ok=True)
        tensorutils.save_wire(
            os.path.join(d, fname), arrays, salt="remote-aggregator",
            cache=self.cache, precision_bits=self.precision_bits,
        )
        return fname

    def _apply_quarantine(self, weights):
        """Zero the weight of every site the watchdog quarantined
        (``cache['quarantined_sites']``) — the same exclusion as the
        non-finite guard."""
        quarantined = self.cache.get("quarantined_sites")
        if quarantined:
            sites = sorted(self.input.keys())
            weights = weights * torch.tensor(
                [0.0 if s in quarantined else 1.0 for s in sites],
                dtype=torch.float32, device=weights.device)
        return weights

    def _site_weights(self):
        """``(n_sites,)`` participation weights from the sites' ``grad_weight``
        (1.0 when absent), times ``gamma**lag`` for a contribution ``lag``
        rounds stale (``cache['site_staleness']``, recorded by the
        aggregator's window check; ``gamma`` =
        ``cache['async_stale_discount']``, default 0.5)."""
        sites = sorted(self.input.keys())
        weights = [float(self.input[s].get("grad_weight", 1.0)) for s in sites]
        staleness = self.cache.get("site_staleness") or {}
        if staleness:
            gamma = float(self.cache.get(Federation.ASYNC_DISCOUNT) or 0.5)
            weights = [w * (gamma ** int(staleness.get(s, 0) or 0))
                       for w, s in zip(weights, sites)]
            telemetry.get_active().event(
                "async:discount", cat="async", gamma=gamma,
                weights=dict(zip(sites, weights)), stale=dict(staleness),
            )
        caps = self._capacity_factors(sites)
        if caps is not None:
            weights = [w * c for w, c in zip(weights, caps)]
        return self._renormalize_epoch(
            torch.tensor(weights, dtype=torch.float32, device=self.device), sites)

    def _capacity_factors(self, sites):
        """Opt-in capacity weighting (``cache['capacity_weight']``): each
        site's observed throughput (``cache['site_capacity']``) over the
        mean of this round's sites with a reading; a site without one
        weighs 1.0, and equal capacities give exactly 1.0 each.  None when
        off or when no site has a reading."""
        if not self.cache.get(Membership.CAPACITY_WEIGHT):
            return None
        caps = self.cache.get(Membership.SITE_CAPACITY) or {}
        known = [float(caps[s]) for s in sites if caps.get(s)]
        if not known:
            return None
        mean = sum(known) / len(known)
        if mean <= 0.0:
            return None
        return [float(caps[s]) / mean if caps.get(s) else 1.0 for s in sites]

    def _renormalize_epoch(self, weights, sites):
        """Once the roster has churned (epoch > 1) re-centre the weights to
        mean 1 over this round's sites: the mean is scale-free, but a
        shrunken, discounted roster could otherwise fall under the
        ``max(sum(w), 1)`` floor.  The identity at epoch 1, so a fixed
        roster's trajectory is unchanged."""
        roster = self.cache.get(Membership.ROSTER)
        if not (isinstance(roster, dict) and int(roster.get("epoch", 1) or 1) > 1):
            return weights
        total = float(weights.sum())
        if total <= 0.0:
            return weights
        return weights * torch.tensor(float(len(sites)) / total, dtype=torch.float32,
                                      device=weights.device)

    def _average(self, site_leaves, weights=None, payload=None):
        """Stack each leaf across sites on the device and take the
        participation-weighted mean (weights: :meth:`_site_weights`, the
        quarantined sites at 0); the means stay on the device, in the wire
        dtype.  With telemetry on, the site-agreement series of ``payload``
        (grads, powerSGD_P, ...) and the watchdog over them."""
        n_leaves = len(site_leaves[0])
        if n_leaves == 0:  # e.g. rankDAD's rest payload of an all-dense model
            return []
        if weights is None:
            weights = self._site_weights()
        stacked = self._stack(site_leaves)
        # already-quarantined sites drop out BEFORE the health series, so
        # the recorded consensus describes the mean actually applied
        weights = self._apply_quarantine(weights)
        rec = telemetry.get_active()
        if rec.enabled:
            _health.record_site_agreement(
                self.cache, sorted(self.input.keys()), site_cosines(stacked, weights),
                weights=weights, recorder=rec, payload=payload)
            # a quarantine the watchdog issued on THIS round's series takes
            # effect at once
            weights = self._apply_quarantine(weights)
        wire = config.wire_torch_dtype(self.precision_bits)
        if self.cache.get("guard_nonfinite", True):
            means, ok = guarded_mean(stacked, weights)
            self._record_skipped(ok)
        else:
            means = stacked_mean(stacked, weights)
        return [m.to(wire) for m in means]

    def _record_skipped(self, ok):
        """Sites left out by the non-finite guard land in
        ``cache['skipped_sites']``."""
        ok = ok.cpu().numpy()
        self.cache["_reduce_round"] = int(self.cache.get("_reduce_round", 0)) + 1
        if not ok.all():
            sites = sorted(self.input.keys())
            bad = [s for s, good in zip(sites, ok) if not good]
            self.cache.setdefault("skipped_sites", []).append({
                "reduce_round": self.cache["_reduce_round"],
                "epoch": int(self.cache.get("epoch", 0)),
                "sites": bad,
            })
            telemetry.get_active().event(
                "reduce:nonfinite_skip", cat="reduce", sites=bad,
                reduce_round=self.cache["_reduce_round"],
            )
            # a failure event is never verbosity-gated
            logger.warn(
                f"non-finite gradients from sites {bad}; excluded this round", True,
            )

    # ----------------------------------------------------- hierarchical tree
    def _tree_fanin(self):
        """The tree fan-in ``k`` (``cache['reduce_fanin']``); 0 = the flat
        stacked mean."""
        try:
            k = int(self.cache.get(Federation.REDUCE_FANIN) or 0)
        except (TypeError, ValueError):
            return 0
        return k if k >= 2 else 0

    def _tree_average(self, file_key, payload=None):
        """The k-ary streaming reduce over the site payload files: groups
        of ``k`` sites load, stack on the device and become a weighted
        partial sum and weight total (:func:`guarded_partial`, or
        :func:`plain_partial` without the non-finite guard), committed with
        :func:`~..utils.tensorutils.save_arrays` into ``.tree_reduce/``;
        each level adds ``k`` partials (a lone trailing one carries
        forward), and the root divides by ``max(total, 1)``.  Equal to the
        flat mean to float32 rounding for any grouping, an all-dead subtree
        and a single survivor included; the spill directory is removed.
        Quarantined sites weigh 0; with telemetry on, a second pass records
        the site-agreement series against the root mean
        (:meth:`_tree_health`)."""
        sites = sorted(self.input.keys())
        k = self._tree_fanin() or 2
        paths = [self._site_path(s, self.input[s][file_key]) for s in sites]
        weights = self._apply_quarantine(self._site_weights())
        retry = RetryPolicy.for_wire(self.cache)
        use_mmap = self._wire_mmap()
        guard = bool(self.cache.get("guard_nonfinite", True))
        rec = telemetry.get_active()
        spill = os.path.join(self.state.get("outputDirectory", "."), ".tree_reduce")
        os.makedirs(spill, exist_ok=True)
        ok = torch.ones(len(sites), dtype=torch.bool, device=self.device)
        site_leaves = partials = root = None
        try:
            entries = []
            for g in range(0, len(paths), k):
                site_leaves = tensorutils.load_arrays_many(paths[g:g + k], retry=retry,
                                                           mmap=use_mmap)
                n_leaves = len(site_leaves[0])
                if n_leaves == 0:
                    return []
                stacked = self._stack(site_leaves)
                site_leaves = None
                w = weights[g:g + k]
                if guard:
                    sums, wtot, ok[g:g + k] = guarded_partial(stacked, w)
                else:
                    sums, wtot = plain_partial(stacked, w)
                part = os.path.join(spill, f"l0_{g // k}.npy")
                tensorutils.save_arrays(part, [*sums, wtot.reshape(1)])
                entries.append(part)
            levels = 1
            while len(entries) > 1:
                nxt = []
                for g in range(0, len(entries), k):
                    chunk = entries[g:g + k]
                    if len(chunk) == 1:
                        nxt.append(chunk[0])
                        continue
                    partials = tensorutils.load_arrays_many(chunk, retry=retry,
                                                            mmap=use_mmap)
                    total = [sum(self._tensor(p[i]) for p in partials)
                             for i in range(len(partials[0]))]
                    partials = None
                    part = os.path.join(spill, f"l{levels}_{g // k}.npy")
                    tensorutils.save_arrays(part, total)
                    nxt.append(part)
                entries = nxt
                levels += 1
            root = tensorutils.load_arrays(entries[0], retry=retry, mmap=use_mmap)
            denom = torch.tensor(max(float(np.asarray(root[-1]).ravel()[0]), 1.0),
                                 dtype=torch.float32, device=self.device)
            means = [self._tensor(x) / denom for x in root[:-1]]
            root = None
            if rec.enabled:
                self._tree_health(paths, weights, means, retry, payload, k)
            if guard:
                self._record_skipped(ok)
            rec.event("reduce:tree", cat="reduce", sites=len(sites), fanin=k,
                      levels=levels, payload=payload)
            wire = config.wire_torch_dtype(self.precision_bits)
            return [m.to(wire) for m in means]
        finally:
            # no view may outlive the spill files it maps
            site_leaves = partials = root = None
            shutil.rmtree(spill, ignore_errors=True)

    def _tree_health(self, paths, weights, mean_leaves, retry, payload, k):
        """The tree's streaming second pass: each site's cosine to the root
        mean, group by group (the series the flat path records through
        :func:`site_cosines`)."""
        sites = sorted(self.input.keys())
        mnorm2 = mean_norm2(mean_leaves)
        cos = torch.empty(len(sites), dtype=torch.float32, device=self.device)
        for g in range(0, len(paths), k):
            stacked = self._stack(tensorutils.load_arrays_many(
                paths[g:g + k], retry=retry, mmap=self._wire_mmap()))
            cos[g:g + k], _ = cosine_block(stacked, mean_leaves, mnorm2)
        _health.record_site_agreement(self.cache, sites, cos, weights=weights,
                                      recorder=telemetry.get_active(), payload=payload)

    def _staged(self, arrays):
        """``arrays`` (each a payload array, maybe a read-only view of a
        mapped file) stacked as one float32 tensor on the reducer's device:
        copied into a host buffer of the reducer's own, pinned when the
        device is the card, then to the device."""
        pin = self.device.type == "cuda"
        buf = torch.empty((len(arrays), *np.shape(arrays[0])), dtype=torch.float32,
                          pin_memory=pin)
        host = buf.numpy()
        for j, a in enumerate(arrays):
            host[j] = a
        return buf.to(self.device, non_blocking=pin)

    def _tensor(self, a):
        """A loaded (read-only) payload array as a float32 device tensor."""
        return self._staged([a])[0]

    def _stack(self, site_leaves):
        """``(n_sites, ...)`` float32 device tensors, one per leaf."""
        return [self._staged([site[i] for site in site_leaves])
                for i in range(len(site_leaves[0]))]

    def reduce(self):
        """Average all sites' gradients → ship ``avg_grads`` + signal update.
        With ``reduce_fanin`` ``k >= 2`` and more than ``k`` sites the mean
        streams through the tree (:meth:`_tree_average`)."""
        k = self._tree_fanin()
        if k and len(self.input) > k:
            avg = self._tree_average("grads_file", payload="grads")
        else:
            avg = self._average(self._load("grads_file"), payload="grads")
        telemetry.get_active().event("reduce:dSGD", cat="reduce", sites=len(self.input),
                                     leaves=len(avg))
        fname = self._save_out(config.avg_grads_file, avg)
        return {"avg_grads_file": fname, "update": True}
