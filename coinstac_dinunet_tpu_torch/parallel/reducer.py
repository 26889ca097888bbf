"""COINNReducer — the aggregator-side half of a dSGD round (PyTorch port).

Port of the JAX package's ``parallel/reducer.py``: load every site's
gradient payload (fan-in in sorted order), take the participation-weighted
mean on the device — sites whose payload holds a non-finite value are left
out (``cache['guard_nonfinite']``, default on) — and ship the mean back
through :func:`..utils.tensorutils.save_wire`, so at ``precision_bits=8``
the aggregator quantizes on the device too.  The k-ary tree fan-in, watchdog
quarantine, staleness discount and capacity weighting wait for their slices
(``ROADMAP.md``).
"""
import os

import numpy as np
import torch

from .. import config
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

    def _load(self, file_key):
        """One payload per site (site order: sorted site id), under the wire
        retry policy."""
        sites = sorted(self.input.keys())
        paths = [self._site_path(s, self.input[s][file_key]) for s in sites]
        return tensorutils.load_arrays_many(paths, retry=RetryPolicy.for_wire(self.cache))

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

    def _site_weights(self):
        """``(n_sites,)`` participation weights from the sites' ``grad_weight``
        (1.0 when absent)."""
        sites = sorted(self.input.keys())
        return torch.tensor(
            [float(self.input[s].get("grad_weight", 1.0)) for s in sites],
            dtype=torch.float32, device=self.device,
        )

    def _average(self, site_leaves):
        """Stack each leaf across sites on the device and take the
        participation-weighted mean (weights: :meth:`_site_weights`); the
        means stay on the device, in the wire dtype."""
        n_leaves = len(site_leaves[0])
        if n_leaves == 0:  # e.g. rankDAD's rest payload of an all-dense model
            return []
        weights = self._site_weights()
        stacked = [
            torch.from_numpy(np.stack([np.asarray(site[i], np.float32)
                                       for site in site_leaves])).to(self.device)
            for i in range(n_leaves)
        ]
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
            logger.warn(
                f"non-finite gradients from sites {bad}; excluded this round", True,
            )

    def reduce(self):
        """Average all sites' gradients → ship ``avg_grads`` + signal update."""
        avg = self._average(self._load("grads_file"))
        fname = self._save_out(config.avg_grads_file, avg)
        return {"avg_grads_file": fname, "update": True}
