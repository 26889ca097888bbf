"""Carrying parameters and gradients between the port and the JAX package.

Both packages ship gradients as one wire list per model dict, and a payload
from one package must mean the same thing to the other.  So the port uses
the JAX package's order and layout on the wire:

- **order** — ``jax.tree_util.tree_leaves`` of ``{model: {"params": ...}}``
  flax dicts, i.e. keys sorted at every level;
- **layout** — flax's: a convolution kernel ``(*k, cin, cout)``, a dense
  kernel ``(in, out)``, GroupNorm/LayerNorm ``scale``/``bias``.  torch keeps
  ``(cout, cin, *k)``, ``(out, in)`` and ``weight``/``bias``.

A port model names its flax counterpart's modules in ``FLAX_NAMES``
(``{torch module prefix: flax module path}``; the ``""`` entry holds the
model's own top-level parameters, such as a positional table), listed in
the order the flax model creates them (:func:`creation_order`).  The layout
follows the parameter's kind, never its rank: only the ``weight`` of an
``nn.Linear`` or ``nn.Conv*`` is a flax ``kernel`` and is transposed;
every other parameter (norm scales, biases, a ``(max_len, d)`` embedding
table) crosses as it is.  This is the inverse of the JAX package's
checkpoint importer (``utils/torch_import.py::_convert_tensor``).
"""
import numpy as np
import torch
from torch import nn

_KERNEL_MODULES = (nn.Linear, nn.modules.conv._ConvNd)


def is_kernel(model, param_name):
    """Whether ``param_name`` of ``model`` is a dense or convolution kernel
    (the ``weight`` of an ``nn.Linear`` or ``nn.Conv*``)."""
    prefix, _, leaf = param_name.rpartition(".")
    return leaf == "weight" and isinstance(model.get_submodule(prefix), _KERNEL_MODULES)


def flax_path(model, param_name):
    """The flax path (tuple of keys under the model's variables dict) of
    torch parameter ``param_name`` of ``model``."""
    prefix, _, leaf = param_name.rpartition(".")
    module = tuple(model.FLAX_NAMES[prefix])
    if leaf == "weight":
        leaf = "kernel" if is_kernel(model, param_name) else "scale"
    return ("params", *module, leaf)


def creation_order(model):
    """``model``'s parameter names in the order its flax counterpart
    creates its leaves (the order of a torch ``state_dict`` of the same
    architecture): the modules in ``FLAX_NAMES`` order, each module's own
    parameters in registration order (``weight`` before ``bias``, as flax
    makes ``kernel``/``scale`` before ``bias``)."""
    by_module = {}
    for pname, _ in model.named_parameters():
        by_module.setdefault(pname.rpartition(".")[0], []).append(pname)
    order = [p for prefix in model.FLAX_NAMES for p in by_module.pop(prefix, [])]
    if by_module:
        raise ValueError(f"modules missing from FLAX_NAMES: {sorted(by_module)}")
    return order


def wire_leaves(models):
    """``[(model name, param name)]`` in the JAX package's leaf order for a
    dict of models."""
    keyed = [
        ((name, *flax_path(m, pname)), (name, pname))
        for name, m in models.items()
        for pname, _ in m.named_parameters()
    ]
    return [pair for _, pair in sorted(keyed)]


def to_flax_layout(t):
    """A kernel in torch layout → flax layout: conv ``(cout, cin, *k)`` →
    ``(*k, cin, cout)``, dense ``(out, in)`` → ``(in, out)``.  Works on
    torch tensors (a view) and numpy arrays."""
    nd = t.ndim
    perm = (*range(2, nd), 1, 0)
    return t.permute(*perm) if hasattr(t, "permute") else np.transpose(t, perm)


def from_flax_layout(t, torch_shape):
    """Inverse of :func:`to_flax_layout` for a kernel of ``torch_shape``."""
    nd = len(torch_shape)
    perm = (nd - 1, nd - 2, *range(nd - 2))
    out = t.permute(*perm) if hasattr(t, "permute") else np.transpose(t, perm)
    return out.reshape(torch_shape)


def to_flax(model, param_name, t):
    """Parameter (or gradient) ``t`` of ``param_name`` in flax layout: a
    kernel is transposed, anything else is returned as it is."""
    return to_flax_layout(t) if is_kernel(model, param_name) else t


def from_flax(model, param_name, t):
    """Inverse of :func:`to_flax`: ``t`` in the torch shape of
    ``param_name``."""
    shape = tuple(model.get_parameter(param_name).shape)
    if is_kernel(model, param_name):
        return from_flax_layout(t, shape)
    # a rank ≤ 1 leaf may come off the wire flattened; a table never may
    if t.ndim > 1 and tuple(t.shape) != shape:
        raise ValueError(f"{param_name}: flax shape {tuple(t.shape)} is not {shape}")
    return t.reshape(shape)


def params_to_jax(model):
    """A port model's parameters as the flax variables dict (nested dicts of
    float32 numpy arrays in flax layout), e.g. ``{"params": {...}}``."""
    out = {}
    for pname, p in model.named_parameters():
        node = out
        *mods, leaf = flax_path(model, pname)
        for k in mods:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(
            to_flax(model, pname, p.detach().cpu().float().numpy()))
    return out


def params_from_jax(flax_params, model):
    """A flax variables dict (numpy or jax arrays, ``{"params": ...}``) as a
    state dict for the port model ``model`` — load it with
    ``model.load_state_dict``."""
    state = {}
    for pname in dict(model.named_parameters()):
        node = flax_params
        for k in flax_path(model, pname):
            node = node[k]
        a = np.asarray(node, dtype=np.float32)
        # np.array copies: the source may be a read-only (jax) buffer
        state[pname] = torch.from_numpy(np.array(from_flax(model, pname, a)))
    return state


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def tsp_params_from_jax(tree, device):
    """The JAX package's sharded-transformer parameter tree (``parallel/
    sequence.py`` ``init_tsp_params``, or after ``stack_layers``; numpy or
    jax arrays) as the port's: the same dicts and lists, every leaf a
    float32 tensor on ``device`` (the JAX tree's norms and biases are
    float64 under x64)."""
    return _tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device),
                     tree)


def tsp_params_to_jax(tree):
    """The port's whole (unsharded) sharded-transformer tree as the JAX
    package's: float32 numpy arrays (``parallel.sequence.gather_tsp_params``
    first for a sharded one)."""
    return _tree_map(lambda t: t.detach().cpu().float().numpy(), tree)
