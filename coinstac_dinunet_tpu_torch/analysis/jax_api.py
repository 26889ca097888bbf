"""torch-api-drift: references to ``torch`` symbols that do not exist (or
are deprecated) at the pinned torch version — the port's counterpart of the
JAX package's ``analysis/jax_api.py`` (``jax-api-drift``).

The construct is the JAX rule's: a declarative table gives each
drift-prone dotted path the version window it exists in (``added`` /
``removed``), an optional ``deprecated`` bound and a replacement hint; the
pinned version is read from installed package metadata
(``importlib.metadata`` — no ``import torch``) and ``--torch-version``
overrides it (``--jax-version`` is a usage error that names it).  The rule
id and the flag name the package they read.  The table lists the torch
APIs the port (and ``chip_smoke.py``) calls whose window is narrower than
the port's support, and the deprecated spellings it must not drift back
to.  The same guards as the JAX rule are sanctioned: the body of ``if
hasattr(torch..., "x"):`` exempts ``torch....x``, its ``else:`` branch
everything, and operands after a torch-rooted ``getattr(mod, "x", ...)``
probe in an ``or`` chain everything.
"""
import ast

from .core import Finding, Rule, dotted_name, register_rule

#: version -> status windows for drift-prone dotted paths.  ``added``: first
#: version the name exists at; ``removed``: first version it no longer
#: exists at; ``deprecated``: first version it warns at.  All bounds
#: optional.  Read against torch 2.11 (the card's machine) and 2.13.
SYMBOL_TABLE = {
    "torch.library.custom_op": {
        "added": "2.4.0",
        "hint": "the operator wrappers of ops/flash_attention.py need it",
    },
    "torch.library.register_fake": {"added": "2.4.0"},
    "torch.library.impl_abstract": {
        "added": "2.2.0",
        "deprecated": "2.4.0",
        "hint": "use torch.library.register_fake (or a custom_op's .register_fake)",
    },
    "torch.utils.flop_counter.FlopCounterMode": {"added": "2.1.0"},
    "torch.utils.flop_counter.register_flop_formula": {"added": "2.3.0"},
    "torch.cuda.set_sync_debug_mode": {"added": "1.10.0"},
    "torch.cuda.get_sync_debug_mode": {"added": "1.10.0"},
    "torch.cuda.mem_get_info": {"added": "1.11.0"},
    "torch.func.functional_call": {"added": "2.0.0"},
    "torch.nn.utils.stateless.functional_call": {
        "deprecated": "2.0.0",
        "hint": "use torch.func.functional_call",
    },
    "torch.amp.autocast": {"added": "1.10.0"},
    "torch.cuda.amp.autocast": {
        "deprecated": "2.4.0",
        "hint": "use torch.amp.autocast('cuda', ...)",
    },
    "torch.cuda.amp.GradScaler": {
        "deprecated": "2.4.0",
        "hint": "use torch.amp.GradScaler('cuda', ...)",
    },
    "torch.amp.GradScaler": {"added": "2.3.0"},
    "torch.compile": {"added": "2.0.0"},
    "torch.set_default_device": {"added": "2.0.0"},
    "torch.Tensor.untyped_storage": {"added": "2.0.0"},
    "torch.nn.functional.scaled_dot_product_attention": {"added": "2.0.0"},
    "torch.utils._python_dispatch.TorchDispatchMode": {"added": "1.13.0"},
    "torch.profiler.profile": {"added": "1.8.1"},
    "torch._six": {
        "removed": "2.0.0",
        "hint": "use the standard library (math.inf, str, collections.abc)",
    },
}

DEFAULT_TORCH_VERSION = "2.11.0"  # the card machine's torch, when metadata is missing


def parse_version(v):
    parts = []
    for tok in str(v).split("."):
        num = ""
        for ch in tok:
            if ch.isdigit():
                num += ch
            else:
                break
        parts.append(int(num or 0))
    return tuple((parts + [0, 0, 0])[:3])


def installed_torch_version():
    """Pinned torch version from package metadata (never imports torch)."""
    try:
        from importlib.metadata import version

        return version("torch")
    except Exception:  # noqa: BLE001 — metadata missing in odd installs
        return DEFAULT_TORCH_VERSION


def symbol_status(dotted, version):
    """('missing'|'deprecated'|'ok', entry) for ``dotted`` at ``version``.

    Longest-prefix match, so ``torch._six.inf`` resolves through the
    ``torch._six`` entry.
    """
    v = parse_version(version)
    probe = dotted
    while probe:
        entry = SYMBOL_TABLE.get(probe)
        if entry is not None:
            added = entry.get("added")
            removed = entry.get("removed")
            deprecated = entry.get("deprecated")
            if added and v < parse_version(added):
                return "missing", probe, entry
            if removed and v >= parse_version(removed):
                return "missing", probe, entry
            if deprecated and v >= parse_version(deprecated):
                return "deprecated", probe, entry
            return "ok", probe, entry
        probe = probe.rpartition(".")[0]
    return "ok", dotted, None


@register_rule
class TorchApiDriftRule(Rule):
    id = "torch-api-drift"
    doc = ("References to torch symbols absent (or deprecated) at the pinned "
           "torch version, resolved through a version->symbol table.")

    def __init__(self, torch_version=None):
        self.torch_version = torch_version or installed_torch_version()

    def _module_aliases(self, tree):
        """name -> dotted module path for torch-rooted imports."""
        aliases = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch" or a.name.startswith("torch."):
                        aliases[a.asname or a.name.split(".")[0]] = (
                            a.name if a.asname else a.name.split(".")[0]
                        )
                        if a.asname:
                            aliases[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.module == "torch" or node.module.startswith("torch."):
                    for a in node.names:
                        aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def _hasattr_guards(self, tree, aliases):
        """(guarded_dotted, first_line, last_line) exemption spans.

        Three sanctioned version-gating shapes (``guarded_dotted is None``
        exempts every symbol in the span, a dotted string only that symbol):

        - the body of ``if hasattr(torch, "x"):`` exempts ``torch.x``;
        - its ``else:`` branch exempts everything — it only runs when the
          probe failed, i.e. on the complement version line, so any torch
          reference there is a deliberate old/new-API fallback;
        - operands after a torch-rooted ``getattr(mod, "x", ...)`` probe in an
          ``or`` chain exempt everything — they only evaluate when the probe
          came back falsy.
        """
        guards = []

        def torch_base(expr):
            base = dotted_name(expr)
            if base is None:
                return None
            root = base.split(".", 1)[0]
            target = aliases.get(root)
            if target is not None:
                base = base.replace(root, target, 1)
            if base == "torch" or base.startswith("torch."):
                return base
            return None

        def span(nodes):
            last = nodes[-1]
            return nodes[0].lineno, getattr(last, "end_lineno", None) or last.lineno

        def probe(call, func_name):
            """base dotted path if ``call`` is hasattr/getattr(<torch>, "str")."""
            if not (
                isinstance(call, ast.Call)
                and isinstance(call.func, ast.Name)
                and call.func.id == func_name
                and len(call.args) >= 2
                and isinstance(call.args[1], ast.Constant)
                and isinstance(call.args[1].value, str)
            ):
                return None
            return torch_base(call.args[0])

        for node in ast.walk(tree):
            if isinstance(node, ast.If) and node.body:
                for call in ast.walk(node.test):
                    base = probe(call, "hasattr")
                    if base is None:
                        continue
                    guards.append((f"{base}.{call.args[1].value}",
                                   *span(node.body)))
                    if node.orelse:
                        guards.append((None, *span(node.orelse)))
            elif isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or):
                for i, value in enumerate(node.values[:-1]):
                    if probe(value, "getattr") is not None:
                        guards.append((None, *span(node.values[i + 1:])))
                        break
        return guards

    @staticmethod
    def _guarded(dotted, lineno, guards):
        return any(
            (g is None or dotted == g or dotted.startswith(g + "."))
            and start <= lineno <= end
            for g, start, end in guards
        )

    def _check(self, dotted, module, node, findings, seen, guards=()):
        status, sym, entry = symbol_status(dotted, self.torch_version)
        if status == "ok" or entry is None:
            return
        if self._guarded(dotted, node.lineno, guards):
            return
        key = (sym, node.lineno)
        if key in seen:
            return
        seen.add(key)
        hint = entry.get("hint")
        if status == "missing":
            msg = f"{sym} does not exist in torch {self.torch_version}"
        else:
            msg = f"{sym} is deprecated in torch {self.torch_version}"
        if hint:
            msg += f" — {hint}"
        findings.append(Finding(
            rule=self.id, path=module.path, line=node.lineno,
            col=node.col_offset, message=msg,
        ))

    def visit_module(self, module):
        findings, seen = [], set()
        aliases = self._module_aliases(module.tree)
        guards = self._hasattr_guards(module.tree, aliases)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "torch" or node.module.startswith("torch.")
            ):
                for a in node.names:
                    self._check(f"{node.module}.{a.name}", module, node,
                                findings, seen, guards)
                self._check(node.module, module, node, findings, seen, guards)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch" or a.name.startswith("torch."):
                        self._check(a.name, module, node, findings, seen,
                                    guards)
            elif isinstance(node, ast.Attribute):
                dotted = dotted_name(node)
                if dotted is None:
                    continue
                root = dotted.split(".", 1)[0]
                target = aliases.get(root)
                if target is None:
                    continue
                resolved = dotted.replace(root, target, 1)
                if resolved == "torch" or resolved.startswith("torch."):
                    self._check(resolved, module, node, findings, seen, guards)
        return findings


def resolve_symbol(dotted):
    """Whether ``dotted`` resolves in the installed torch: its longest
    importable module prefix, then attributes (imports torch)."""
    import importlib

    parts = dotted.split(".")
    for n in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:n]))
        except ImportError:
            continue
        for attr in parts[n:]:
            if not hasattr(obj, attr):
                return False
            obj = getattr(obj, attr)
        return True
    return False


def table_resolution(version=None):
    """``{dotted: (status at version, resolves here)}`` for every table
    entry, ``version`` the installed torch's by default (imports torch)."""
    version = version or installed_torch_version()
    return {dotted: (symbol_status(dotted, version)[0], resolve_symbol(dotted))
            for dotted in sorted(SYMBOL_TABLE)}
