"""PowerSGD learner/reducer — rank-r gradient compression with error
feedback (PyTorch port).

Port of the JAX package's ``parallel/powersgd.py`` for the file wire:
``start_powerSGD_iter`` rounds of plain dSGD (default 10), then a two-round
protocol per update — the P-sync round ships ``P = M Q`` of every ≥ 2-D
leaf, the aggregator averages it, the Q-sync round ships ``Q = Mᵀ P̂`` (P̂
the orthogonalized mean P) with the rank-1 leaves, and the update applies
``P̂ Qᵀ``.  Each site keeps the error ``M − P̂ Qᵀ`` (error feedback) and
warm-starts Q from the last mean Q; ``powerSGD_phase`` rides the wire and
``grad_weight`` rides both rounds.  P, Q, M, the errors and the rank-1
leaves stay on the trainer's device and go to ``save_wire`` as device
tensors, so at ``precision_bits=8`` K1 quantizes each payload on the card
in one launch.

Kept from the JAX package on purpose:

- ``_as_matrix`` reshapes each leaf **in the flax layout** to
  ``(shape[0], -1)``: a 3-D convolution kernel ``(3, 3, 3, cin, cout)``
  becomes a ``(3, 9·cin·cout)`` matrix (its depth axis of 3 as the rows),
  not torch's ``(cout, ·)``.  That is the reference's behaviour and what
  makes the P and Q payloads the same as the JAX package's.

What differs:

- :func:`seeded_Q` draws the start Q of leaf ``j`` from a CPU
  ``torch.Generator`` seeded ``seed*1000 + j`` and moves it to the device:
  every site, on the card or the CPU, starts from the same Q, but not from
  the JAX package's (threefry), so a mixed JAX/port PowerSGD federation
  starts its sites from different Qs.
- The telemetry events and the compression-health records of the JAX file
  are left out (the port has no ``telemetry/`` package yet).
- :meth:`_PowerSGDState.serialize` gives CPU float32 tensors where the JAX
  package gives numpy arrays (the same keys and shapes): the state goes
  into a ``torch.save`` file, which is read back with ``weights_only``.
"""
import numpy as np
import torch

from .. import config
from ..ops.power_iteration import float32_math, orthogonalize
from ..utils import tensorutils
from .learner import COINNLearner
from .reducer import COINNReducer

PHASE_P_SYNC = "phase_P_sync"
PHASE_Q_SYNC = "phase_Q_sync"
rank1_file = "powerSGD_rank1.npy"

_STATE_KEY = "_powersgd_state"


def _split_leaves(flat):
    """Indices of the ≥ 2-D (compressed) and the rank ≤ 1 (shipped raw)
    leaves of a wire list."""
    hi = [i for i, g in enumerate(flat) if g.ndim >= 2]
    lo = [i for i, g in enumerate(flat) if g.ndim < 2]
    return hi, lo


def _as_matrix(g):
    """A flax-layout leaf as the float32 ``(shape[0], -1)`` matrix (see the
    module docstring: the reference's reshape, kept)."""
    g = g.to(torch.float32)
    return g.reshape(g.shape[0], -1)


def compress_P(M, Q):
    """P-sync payload: ``P = M Q``."""
    return M @ Q


def compress_Q(M, Phat):
    """Q-sync payload: ``Q = Mᵀ P̂``."""
    return M.T @ Phat


def reconstruct(Phat, Q):
    """The rank-r gradient estimate ``P̂ Qᵀ``."""
    return Phat @ Q.T


def seeded_Q(seed, j, ncols, rank):
    """The start Q ``(ncols, rank)`` of the ``j``-th compressed leaf, from a
    CPU generator seeded ``seed*1000 + j``: the same on every site and
    every device."""
    gen = torch.Generator().manual_seed(int(seed) * 1000 + int(j))
    return torch.randn((int(ncols), int(rank)), generator=gen, dtype=torch.float32)


class _PowerSGDState:
    """A site's compression state, kept in its cache between invocations."""

    def __init__(self):
        self.iteration = 0  # completed update rounds (drives the warm-up)
        self.errors = None  # error-feedback matrix per compressed leaf
        self.Qs = None  # warm-started Q per compressed leaf
        self.Ms = None  # error-fed gradient matrices, P-sync → Q-sync
        self.Phats = None  # orthogonalized mean P, Q-sync → step
        self.rank1 = None  # the raw rank ≤ 1 leaves riding along
        self.shapes = None  # flax-layout shapes of the compressed leaves
        self.hi = self.lo = None  # the leaf index split
        self.weight = 1.0  # this round's participation (P-sync → Q-sync)

    # Across rounds only the error feedback, the warm-started Qs and the
    # warm-up counter carry over (the epoch-barrier autosave); ``full=True``
    # adds the mid-protocol fields, so that a fresh process can take over
    # between the P-sync and the Q-sync invocations of one update
    # (``persist_round_state``).
    def serialize(self, full=False):
        """The state as plain values and CPU tensors (see the JAX
        package's ``_PowerSGDState.serialize`` for the keys)."""
        def cpu(ts, dtype=torch.float32):
            return [t.detach().to("cpu", dtype) for t in ts]

        out = {
            "iteration": int(self.iteration),
            "weight": float(self.weight),
            "errors": cpu(self.errors) if self.errors is not None else [],
            "Qs": cpu(self.Qs) if self.Qs is not None else [],
        }
        if full:
            if self.Ms is not None:
                out["Ms"] = cpu(self.Ms)
            if self.Phats is not None:
                out["Phats"] = cpu(self.Phats)
            if self.rank1 is not None:
                out["rank1"] = [r.detach().cpu() for r in self.rank1]
            if self.shapes is not None:
                out["shapes"] = [list(s) for s in self.shapes]
            if self.hi is not None:
                out["hi"] = [int(i) for i in self.hi]
                out["lo"] = [int(i) for i in self.lo]
        return out

    @classmethod
    def deserialize(cls, payload, device="cpu"):
        """The inverse of :meth:`serialize`, its tensors on ``device``."""
        def dev(ts, dtype=torch.float32):
            return [torch.as_tensor(t).to(device, dtype) for t in tensorutils.aslist(ts)]

        st = cls()
        st.iteration = int(payload.get("iteration", 0))
        st.weight = float(payload.get("weight", 1.0))
        st.errors = dev(payload.get("errors")) or None
        st.Qs = dev(payload.get("Qs")) or None
        if payload.get("Ms") is not None:
            st.Ms = dev(payload["Ms"])
        if payload.get("Phats") is not None:
            st.Phats = dev(payload["Phats"])
        if payload.get("rank1") is not None:
            st.rank1 = [torch.as_tensor(r).to(device)
                        for r in tensorutils.aslist(payload["rank1"])]
        if payload.get("shapes") is not None:
            st.shapes = [tuple(int(d) for d in s) for s in tensorutils.aslist(payload["shapes"])]
        if payload.get("hi") is not None:
            st.hi = [int(i) for i in tensorutils.aslist(payload["hi"])]
            st.lo = [int(i) for i in tensorutils.aslist(payload["lo"])]
        return st


class PowerSGDLearner(COINNLearner):
    """Site-side PowerSGD."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.rank = int(self.cache.get("matrix_approximation_rank", 1))
        self.start_iter = int(self.cache.get("start_powerSGD_iter", 10))

    @property
    def psgd(self):
        st = self.cache.get(_STATE_KEY)
        if st is None:
            st = self.cache[_STATE_KEY] = _PowerSGDState()
        return st

    def _seeded_Q(self, i, shape):
        return seeded_Q(self.cache.get("seed", 0), i, shape[1], self.rank).to(
            self.trainer.device)

    def _device_tensors(self, arrays):
        """Wire arrays as float32 tensors on the trainer's device."""
        return [torch.from_numpy(np.array(a, np.float32)).to(self.trainer.device)
                for a in arrays]

    # ---------------------------------------------------------------- phases
    def to_reduce(self):
        st = self.psgd
        if st.iteration < self.start_iter:
            # dSGD warm-up round
            out = super().to_reduce()
            out["powerSGD_phase"] = "dSGD"
            return out
        if self.input.get("powerSGD_phase", PHASE_P_SYNC) == PHASE_P_SYNC:
            return self._phase_P()
        return self._phase_Q()

    def _phase_P(self):
        """One batch: ship ``P = (M + error) Q`` of every compressed leaf."""
        grads, out, aux = self.backward()
        if grads is None:
            return out
        self._track_train_scores(aux)
        flat = tensorutils.extract_grads(self.trainer.nn)
        st = self.psgd
        # participation rides BOTH wire rounds of this update
        st.weight = 1.0 if aux.get("participation", 1.0) > 0 else 0.0
        st.hi, st.lo = _split_leaves(flat)
        wire = config.wire_torch_dtype(self.precision_bits)
        st.rank1 = [flat[i].to(wire) for i in st.lo]
        st.shapes = [tuple(flat[i].shape) for i in st.hi]
        with float32_math(self.trainer.device):
            Ms = [_as_matrix(flat[i]) for i in st.hi]
            if st.errors is None:
                st.errors = [torch.zeros_like(M) for M in Ms]
            if st.Qs is None:
                st.Qs = [self._seeded_Q(i, M.shape) for i, M in enumerate(Ms)]
            st.Ms = [M + e for M, e in zip(Ms, st.errors)]
            Ps = [compress_P(M, Q) for M, Q in zip(st.Ms, st.Qs)]
        self._save_wire(config.powersgd_P_file, [P.to(wire) for P in Ps])
        out["powerSGD_P_file"] = config.powersgd_P_file
        out["powerSGD_phase"] = PHASE_P_SYNC
        out["reduce"] = True
        out["grad_weight"] = st.weight
        return out

    def _phase_Q(self):
        """The mean P arrived: orthogonalize it, ship ``Q = Mᵀ P̂`` and the
        rank-1 leaves.  Takes no batch."""
        out = {}
        st = self.psgd
        avg_P = self._device_tensors(
            self._load_wire(self._base_path(self.input["powerSGD_P_file"])))
        with float32_math(self.trainer.device):
            st.Phats = [orthogonalize(P) for P in avg_P]
            Qs = [compress_Q(M, Ph) for M, Ph in zip(st.Ms, st.Phats)]
        wire = config.wire_torch_dtype(self.precision_bits)
        self._save_wire(config.powersgd_Q_file, [Q.to(wire) for Q in Qs])
        self._save_wire(rank1_file, st.rank1)
        out["powerSGD_Q_file"] = config.powersgd_Q_file
        out["rank1_file"] = rank1_file
        out["powerSGD_phase"] = PHASE_Q_SYNC
        out["reduce"] = True
        out["grad_weight"] = st.weight
        return out

    def step(self):
        """Apply ``P̂ Qᵀ`` (mean Q) and the mean rank-1 leaves; keep the
        error and warm-start the next Q."""
        st = self.psgd
        if st.iteration < self.start_iter:
            out = super().step()
            st.iteration += 1
            return out
        avg_Q = self._device_tensors(
            self._load_wire(self._base_path(self.input["powerSGD_Q_file"])))
        avg_rank1 = self._load_wire(self._base_path(self.input["rank1_file"]))
        with float32_math(self.trainer.device):
            recon = [reconstruct(Ph, Q) for Ph, Q in zip(st.Phats, avg_Q)]
            st.errors = [M - R for M, R in zip(st.Ms, recon)]
        st.Qs = avg_Q
        flat = [None] * (len(st.hi) + len(st.lo))
        for j, i in enumerate(st.hi):
            flat[i] = recon[j].reshape(st.shapes[j])
        for j, i in enumerate(st.lo):
            flat[i] = avg_rank1[j]
        self.trainer.apply_grads(tensorutils.grads_like(self.trainer.nn, flat))
        st.Ms = st.Phats = None
        st.iteration += 1
        return {}


class PowerSGDReducer(COINNReducer):
    """Aggregator-side PowerSGD: the mean of whatever the phase ships."""

    def reduce(self):
        phases = {self.input[s].get("powerSGD_phase") for s in self.input}
        if phases == {"dSGD"}:
            # warm-up round: plain gradient averaging
            out = super().reduce()
            out["powerSGD_phase"] = PHASE_P_SYNC
            return out
        if phases == {PHASE_P_SYNC}:
            avg_P = self._average(self._load("powerSGD_P_file"))
            fname = self._save_out(config.powersgd_P_file, avg_P)
            return {"powerSGD_P_file": fname, "powerSGD_phase": PHASE_Q_SYNC}
        if phases == {PHASE_Q_SYNC}:
            qname = self._save_out(config.powersgd_Q_file,
                                   self._average(self._load("powerSGD_Q_file")))
            rname = self._save_out(rank1_file, self._average(self._load("rank1_file")))
            return {
                "powerSGD_Q_file": qname,
                "rank1_file": rname,
                "update": True,
                "powerSGD_phase": PHASE_P_SYNC,
            }
        raise RuntimeError(f"Sites disagree on powerSGD phase: {phases}")
