"""wire-atomic-commit: payloads bound for a transfer directory must commit
through ``resilience/transport.py`` — the JAX package's rule over the port,
which also writes with ``torch.save``.

A direct ``open(path, "wb")`` or ``np.save`` aimed at a transfer directory
reintroduces the exact failure mode the resilience layer exists to close: a
reader (the aggregator, or a site consuming a broadcast) that opens the file
mid-write trains on a partial payload — silently when the payload predates
the checksummed wire format.  The transport's commit path (tmp + fsync +
atomic rename + directory manifest) is the single sanctioned writer, so this
rule flags any other write whose target expression implicates a transfer
directory:

- a string constant mentioning ``transferDirectory`` (the COINSTAC state
  key) or a ``transfer``/``xfer`` path fragment,
- a name/attribute whose spelling contains ``transfer`` or ``xfer``
  (``xfer``, ``transfer_dir``, ``self.transfer_path`` …),
- a call to a ``*transfer_path*`` helper (``self._transfer_path("g.npy")``),
- a local name assigned from any of the above (one-hop taint:
  ``p = os.path.join(state["transferDirectory"], f); open(p, "wb")``).

Checked write shapes: ``open(target, "wb"|"ab"|"xb"|"w+b"|...)`` (positional
or ``mode=`` keyword) and ``np.save(target, ...)`` / ``numpy.save`` /
``jnp.save`` / ``torch.save``.  ``resilience/transport.py`` itself is
exempt — it IS the sanctioned writer.  Reads (``"rb"``) are never flagged.
"""
import ast

from .core import Finding, Rule, dotted_name, register_rule

#: the only module allowed to write transfer-directory payloads directly
_EXEMPT_SUFFIX = "resilience/transport.py"

#: the array writers' module roots (``jnp`` kept so a source either package
#: lints gives both analyzers the same findings)
_NP_ROOTS = {"np", "numpy", "jnp", "torch"}


def save_target(call, func_name):
    """The path argument of an ``np.save``-family call, or None: the first
    argument, except ``torch.save(obj, f)``'s second (or ``f=``)."""
    if func_name.rsplit(".", 1)[-1] != "save" or func_name.split(".")[0] not in _NP_ROOTS:
        return None
    if func_name.split(".")[0] == "torch":
        if len(call.args) > 1:
            return call.args[1]
        return next((kw.value for kw in call.keywords if kw.arg == "f"), None)
    return call.args[0] if call.args else None
_TRANSFER_MARKERS = ("transfer", "xfer")


def _mentions_transfer(node, tainted=()):
    """True when the path expression implicates a transfer directory
    (directly, or through a name in the ``tainted`` alias set)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            low = sub.value.lower()
            if any(m in low for m in _TRANSFER_MARKERS):
                return True
        elif isinstance(sub, ast.Name):
            low = sub.id.lower()
            if sub.id in tainted or any(m in low for m in _TRANSFER_MARKERS):
                return True
        elif isinstance(sub, ast.Attribute):
            low = sub.attr.lower()
            if any(m in low for m in _TRANSFER_MARKERS):
                return True
        elif isinstance(sub, ast.Call):
            name = (dotted_name(sub.func, require_name_root=False) or "").lower()
            if any(m in name for m in _TRANSFER_MARKERS):
                return True
    return False


def _tainted_names(tree):
    """Names assigned (anywhere in the module) from a transfer-mentioning
    expression — the ``p = join(transferDirectory, f)`` alias hop.  Iterated
    to a fixed point so a chain of plain-name aliases stays tainted."""
    tainted = set()
    assigns = []
    for node in ast.walk(tree):
        value = None
        if isinstance(node, ast.Assign):
            value = node.value
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            value = node.value
            targets = [node.target]
        else:
            continue
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if names:
            assigns.append((names, value))
    changed = True
    while changed:
        changed = False
        for names, value in assigns:
            if _mentions_transfer(value, tainted):
                for n in names:
                    if n not in tainted:
                        tainted.add(n)
                        changed = True
    return tainted


def _open_write_mode(call):
    """The write-mode string of an ``open`` call, or None (read/unknown)."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)):
        return None
    m = mode.value
    return m if ("b" in m and any(c in m for c in "wax+")) else None


@register_rule
class WireAtomicCommitRule(Rule):
    id = "wire-atomic-commit"
    doc = ("direct open(..., 'wb')/np.save writes targeting a transfer "
           "directory bypass the atomic, checksummed, manifest-recorded "
           "commit path in resilience/transport.py — a reader can observe "
           "a partial payload")

    def visit_module(self, module):
        if module.path.replace("\\", "/").endswith(_EXEMPT_SUFFIX):
            return []
        findings = []
        tainted = _tainted_names(module.tree)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            target = None
            how = None
            func_name = dotted_name(node.func, require_name_root=False) or ""
            if isinstance(node.func, ast.Name) and node.func.id == "open":
                mode = _open_write_mode(node)
                if mode and node.args:
                    target = node.args[0]
                    how = f"open(..., {mode!r})"
            elif save_target(node, func_name) is not None:
                target = save_target(node, func_name)
                how = f"{func_name}(...)"
            if target is None or not _mentions_transfer(target, tainted):
                continue
            findings.append(Finding(
                rule=self.id, path=module.path, line=node.lineno,
                col=node.col_offset,
                message=(
                    f"{how} writes a transfer-directory payload directly — "
                    "commit it through resilience/transport.py "
                    "(tensorutils.save_wire/save_arrays or "
                    "transport.commit_bytes/atomic_copy) so readers can "
                    "never observe a partial payload"
                ),
            ))
        return findings
