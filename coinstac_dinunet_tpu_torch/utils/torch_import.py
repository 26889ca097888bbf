"""Torch checkpoint import — warm start from the reference ecosystem
(PyTorch port).

Port of the JAX package's ``utils/torch_import.py``.  The reference
framework writes ``weights.tar`` files with ``torch.save``: either a
``source='coinstac'`` payload (``{"models": {name: state_dict},
"optimizers": {name: Adam state_dict}}``) or a raw ``state_dict`` for the
first model.  ``NNTrainer.load_checkpoint`` (and so
``cache['pretrained_path']``) accepts both.

Pairing is positional, as in the JAX package: a torch module registers its
parameters in definition order and a flax module creates its own in call
order, so for the same architecture the two lists correspond.  The port
pairs the file's entries against its model's parameters in the flax
model's creation order (:func:`..interop.creation_order`), whatever the
file's names; running statistics pair separately, against the model's
batch statistics, of which the port's models (GroupNorm and LayerNorm
only) have none.  Where the JAX package transposes every tensor into
flax's layout, the port takes it as it is: the file and the port are both
in torch's layout.  A shape mismatch, or a count mismatch (with both
inventories), aborts the load before any weight changes.

``cache['torch_name_map']`` (``{torch name: flax path}``, the JAX
package's ``/``-joined paths such as ``"params/Dense_0/kernel"``, so one
map serves both packages) overrides the positional pairing.  A value may
be ``{"path": ..., "conv_transpose": ...}``: in the JAX package the flag
picks the permutation of a transposed convolution's kernel into flax's
layout; the port moves no axes, so the flag changes nothing here.
"""
import pickle

import torch

from .. import interop
from . import logger

__all__ = [
    "is_torch_file",
    "read_torch_file",
    "split_payload",
    "convert_state_dict",
    "convert_torch_adam_state",
    "graft_adam_state",
]


def is_torch_file(path):
    """Whether ``path`` holds a ``torch.save`` payload: a zip archive with a
    ``data.pkl`` member (a bare ``PK`` header is any zip), or a legacy
    pickle (first byte ``0x80``, which is also msgpack's empty map — no
    checkpoint is one)."""
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


def read_torch_file(path, allow_unsafe=False):
    """``torch.load`` with ``weights_only=True`` (data only, no code runs).
    A file the weights-only unpickler rejects (it pickles classes or other
    globals) is refused unless ``allow_unsafe``: full unpickling executes
    code from the file, so it is for files the operator trusts
    (``cache['allow_unsafe_torch_pickle']``), never for anything received
    over the wire."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        if not allow_unsafe:
            raise RuntimeError(
                f"torch checkpoint {path!r} is not loadable with "
                "weights_only=True (it pickles non-tensor globals). "
                "Loading it requires full unpickling, which EXECUTES CODE "
                "from the file.  If — and only if — this file comes from a "
                "source you trust (your own legacy training run), set "
                "cache['allow_unsafe_torch_pickle']=True and retry."
            ) from exc
        return torch.load(path, map_location="cpu", weights_only=False)
    except Exception as exc:
        # a 0x80-sniffed file that is not torch's: a format error, not the
        # unpickler's internals
        raise RuntimeError(
            f"{path!r} looked like a torch checkpoint (magic bytes) but "
            f"torch.load failed: {exc}"
        ) from exc


def split_payload(payload):
    """The reference's two shapes: ``({model: state_dict}, optimizers or
    None)`` for a ``source='coinstac'`` payload (any case), ``({None:
    state_dict}, None)`` for anything else, a raw state dict the caller
    gives its first model."""
    if isinstance(payload, dict) and str(payload.get("source", "")).lower() == "coinstac":
        return dict(payload.get("models", {})), payload.get("optimizers")
    return {None: payload}, None


def _is_running_stat(name):
    return str(name).endswith(("running_mean", "running_var"))


def convert_state_dict(model, state_dict, name_map=None):
    """Map a torch ``state_dict`` onto port model ``model``: returns
    ``{param name: tensor}`` (on the CPU, in each parameter's dtype) for
    ``model.load_state_dict``.  ``name_map`` entries are placed first, the
    rest pair positionally per collection (see the module docstring);
    ``num_batches_tracked`` is skipped."""
    params = dict(model.named_parameters())
    order = interop.creation_order(model)
    path_of = {p: "/".join(interop.flax_path(model, p)) for p in order}
    by_path = {v: k for k, v in path_of.items()}
    out = {}

    def place(name, tensor, pname):
        tensor = torch.as_tensor(tensor)
        if tuple(tensor.shape) != tuple(params[pname].shape):
            raise ValueError(
                f"cannot convert {name!r} {tuple(tensor.shape)} to {path_of[pname]!r} "
                f"{tuple(params[pname].shape)} — definition orders may diverge; "
                "supply name_map={torch_name: 'flax/path'}"
            )
        out[pname] = tensor.detach().to(device="cpu", dtype=params[pname].dtype).clone()

    remaining = []
    for name, tensor in state_dict.items():
        if str(name).endswith("num_batches_tracked"):
            continue
        if name not in (name_map or {}):
            remaining.append((name, tensor))
            continue
        spec = name_map[name]
        path = str(spec["path"] if isinstance(spec, dict) else spec)
        if path not in by_path:
            raise KeyError(f"name_map[{name!r}] -> {path!r} is not a param path; "
                           f"known: {list(by_path)}")
        place(name, tensor, by_path[path])

    # running statistics pair with batch statistics (none in the port's
    # models), everything else with the parameters not yet placed
    streams = (([x for x in remaining if _is_running_stat(x[0])], []),
               ([x for x in remaining if not _is_running_stat(x[0])],
                [p for p in order if p not in out]))
    for torch_stream, port_stream in streams:
        if len(torch_stream) != len(port_stream):
            raise ValueError(
                "torch checkpoint does not match the model: "
                f"{len(torch_stream)} torch entries vs {len(port_stream)} "
                f"flax params.\n torch: {[n for n, _ in torch_stream]}\n "
                f"flax: {[path_of[p] for p in port_stream]}"
            )
        for (name, tensor), pname in zip(torch_stream, port_stream):
            place(name, tensor, pname)
    return {p: out[p] for p in params}


def convert_torch_adam_state(model, opt_sd, name_map=None):
    """One model's torch ``Adam`` ``state_dict`` → ``({param name:
    (exp_avg, exp_avg_sq)}, count)`` for :func:`graft_adam_state`.

    torch keys the state by the index of the parameter in its model's
    ``parameters()`` order, the same positional pairing as the weights, so
    a ``name_map`` cannot reroute it and is refused.  A tracked parameter
    without state (frozen, or added just before the save) gets zero
    moments, with a warning.  The JAX package keeps one Adam count for a
    model; per-parameter steps that differ by more than 1 cannot become
    one and are refused.  Raises ``ValueError`` when the state does not
    line up (the caller starts that optimizer fresh)."""
    if name_map:
        raise ValueError(
            "optimizer import cannot honor torch_name_map (torch optimizer "
            "state is index-keyed, not name-keyed)"
        )
    params = dict(model.named_parameters())
    order = interop.creation_order(model)
    ordered_ix = [i for g in opt_sd.get("param_groups") or [] for i in g.get("params", [])]
    if len(ordered_ix) != len(order):
        raise ValueError(f"torch optimizer tracks {len(ordered_ix)} params, model has "
                         f"{len(order)}")
    state = opt_sd.get("state", {})
    moments, steps, stateless = {}, [], []
    for pname, ix in zip(order, ordered_ix):
        p = params[pname]
        st = state.get(ix, state.get(str(ix)))
        if st is None:
            # zero moments under the global count: its first updates run
            # smaller than a fresh Adam's until the bias correction washes
            # out; refusing would throw away every other parameter's moments
            moments[pname] = (torch.zeros_like(p, device="cpu"),) * 2
            stateless.append("/".join(interop.flax_path(model, pname)))
            continue
        pair = []
        for key in ("exp_avg", "exp_avg_sq"):
            t = torch.as_tensor(st[key])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"optimizer moment {key}[{ix}] {tuple(t.shape)} does not fit "
                                 f"{pname!r} {tuple(p.shape)}")
            pair.append(t.detach().to(device="cpu", dtype=p.dtype).clone())
        moments[pname] = tuple(pair)
        step = st.get("step", 0)
        steps.append(int(step.item() if hasattr(step, "item") else step))
    count = max(steps, default=0)
    if steps and count - min(steps) > 1:
        raise ValueError(
            f"torch per-param step counts disagree (min {min(steps)}, max "
            f"{count}) — a single optax count would mis-apply Adam bias "
            "correction; starting the optimizer fresh instead"
        )
    if stateless:
        logger.warn(
            f"{len(stateless)} tracked param(s) carry no torch optimizer "
            f"state ({stateless[:3]}…); imported with zero moments under "
            f"count={count} — their early updates run smaller than a fresh "
            "Adam's until the bias correction washes out"
        )
    return moments, count


def graft_adam_state(optimizer, model, moments, count):
    """Give every parameter of ``model`` in ``torch.optim.Adam``
    ``optimizer`` its imported moments and the one global ``count`` as its
    ``step``: the JAX package's optax state has one count, and the next
    update must be the same."""
    optimizer.state.clear()
    for pname, p in model.named_parameters():
        m, v = moments[pname]
        optimizer.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                              "exp_avg": m.to(p.device), "exp_avg_sq": v.to(p.device)}
