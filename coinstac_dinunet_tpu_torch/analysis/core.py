"""dinulint rule engine of the PyTorch port: findings, rule registry,
baseline, suppressions — the JAX package's ``analysis/core.py``, with the
same ``Finding`` shape, suppression comments, baseline format and exit
codes, so a finding of one analyzer can be held against the other's.

Design (mirrors the shape of flake8/ruff internals at 1% of the size):

- A :class:`Rule` sees one parsed module at a time (``visit_module``) — the
  telemetry-name and wire-atomic families live here.
- A :class:`ProjectRule` additionally gets a ``finalize`` pass over ALL
  scanned modules — protocol conformance needs the producer AND consumer
  files together before it can report an unmatched key.
- Findings are matched against a checked-in **baseline** by a line-number-free
  fingerprint ``(rule, path, message)`` so legacy findings never block CI
  while anything new does.  ``--write-baseline`` refreshes it.
- Inline escapes: a ``# dinulint: disable=rule-id[,rule-id...]`` comment
  suppresses on that source line; a ``# dinulint: disable-file=rule-id[,...]``
  comment anywhere in a file suppresses the rule(s) for the whole file.
  Only real comment tokens count — a docstring that merely *documents* the
  syntax (like this one) activates nothing.

The engine is pure stdlib ``ast`` — no ``torch`` import, so a whole-package
run stays in the tens of milliseconds and is safe inside any CI container.
"""
import ast
import dataclasses
import io
import json
import os
import re
import tokenize

_SUPPRESS_LINE = re.compile(r"#\s*dinulint:\s*disable=([\w,\-]+)")
_SUPPRESS_FILE = re.compile(r"#\s*dinulint:\s*disable-file=([\w,\-]+)")


def dotted_name(node, require_name_root=True):
    """Attribute/Name chain → dotted string (shared by the rule families).

    With ``require_name_root`` (the default) returns None unless the chain
    bottoms out at a plain Name.  Without it, joins whatever attribute tail
    is resolvable (``''`` for none): the display name of expressions like
    ``self.nn["net"].apply`` → ``"apply"``.
    """
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif require_name_root:
        return None
    return ".".join(reversed(parts))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str
    path: str
    line: int
    col: int
    message: str

    def fingerprint(self):
        """Line-free identity used for baseline matching (survives edits
        elsewhere in the file)."""
        return (self.rule, self.path.replace(os.sep, "/"), self.message)

    def to_dict(self):
        return dataclasses.asdict(self)

    def render(self):
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class Module:
    """One parsed source file handed to rules."""

    def __init__(self, path, source, tree):
        self.path = path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self._comments = None

    def comments(self):
        """line -> comment text, via ``tokenize`` so string literals that
        merely mention the suppression syntax cannot activate it."""
        if self._comments is None:
            found = {}
            try:
                tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
                for tok in tokens:
                    if tok.type == tokenize.COMMENT:
                        found[tok.start[0]] = tok.string
            except (tokenize.TokenError, IndentationError, SyntaxError):
                pass  # unparsable tail: keep the comments seen so far
            self._comments = found
        return self._comments

    @classmethod
    def parse(cls, path, display_path=None):
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
        return cls(display_path or path, source, tree)


class Rule:
    """Per-module rule.  Subclasses set ``id``/``doc`` and implement
    :meth:`visit_module` returning an iterable of findings."""

    id = "abstract"
    doc = ""

    def visit_module(self, module):  # pragma: no cover - interface
        return []


class ProjectRule(Rule):
    """Whole-project rule: ``visit_module`` collects, ``finalize`` reports."""

    def visit_module(self, module):
        return []

    def finalize(self, modules):  # pragma: no cover - interface
        return []


_REGISTRY = {}


def register_rule(cls):
    """Class decorator adding a rule to the default rule set."""
    _REGISTRY[cls.id] = cls
    return cls


def default_rules():
    """Fresh instances of every registered rule, importing the built-in rule
    modules on first use (registration happens at import)."""
    from . import (  # noqa: F401 (register)
        jax_api,
        protocol,
        sharding,
        telemetry_names,
        trace_hazards,
        wire_atomic,
    )

    return [cls() for _, cls in sorted(_REGISTRY.items())]


def _suppressed(finding, module_by_path):
    mod = module_by_path.get(finding.path)
    if mod is None:
        return False
    comments = mod.comments()
    for text in comments.values():
        m = _SUPPRESS_FILE.search(text)
        if m and finding.rule in m.group(1).split(","):
            return True
    m = _SUPPRESS_LINE.search(comments.get(finding.line, ""))
    if m and finding.rule in m.group(1).split(","):
        return True
    return False


def iter_python_files(paths):
    """Expand directories into their .py files (stable order, deduped).
    Explicitly listed files are always included regardless of extension —
    silently skipping one would report a clean exit for a path that was
    never scanned."""
    seen, out = set(), []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", ".venv", "node_modules")
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        fp = os.path.join(root, name)
                        if fp not in seen:
                            seen.add(fp)
                            out.append(fp)
        elif p not in seen:
            seen.add(p)
            out.append(p)
    return out


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def display_path(path):
    """A finding's path: relative to the repository root for a file of the
    checkout (so a baseline matches from any working directory), else to
    the working directory."""
    full = os.path.abspath(path)
    base = _REPO_ROOT if full.startswith(_REPO_ROOT + os.sep) else os.getcwd()
    return os.path.relpath(full, base).replace(os.sep, "/")


def run_lint(paths, rules=None, rule_ids=None):
    """Lint ``paths`` (files or directories).

    Returns ``(findings, errors)`` — ``errors`` are files that failed to
    parse (reported, never crash the run), each under the class of what
    ``ast.parse`` raised: a NUL byte in the source is a ``ValueError`` before
    Python 3.12 and a ``SyntaxError`` from it on.  ``rule_ids`` filters the
    default rule set by id.
    """
    rules = list(rules) if rules is not None else default_rules()
    if rule_ids:
        wanted = set(rule_ids)
        rules = [r for r in rules if r.id in wanted]
    files = iter_python_files(paths)
    modules, errors = [], []
    for path in files:
        display = display_path(path)
        try:
            modules.append(Module.parse(path, display))
        except (SyntaxError, UnicodeDecodeError, OSError, ValueError) as exc:
            errors.append((display, f"{type(exc).__name__}: {exc}"))
    findings = []
    for mod in modules:
        for rule in rules:
            findings.extend(rule.visit_module(mod))
    for rule in rules:
        if isinstance(rule, ProjectRule):
            findings.extend(rule.finalize(modules))
    module_by_path = {m.path: m for m in modules}
    findings = [f for f in findings if not _suppressed(f, module_by_path)]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, errors


# ------------------------------------------------------------------ baseline
def load_baseline(path):
    """Baseline file → fingerprint → allowed count."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    counts = {}
    for entry in data.get("findings", []):
        fp = (entry["rule"], entry["path"], entry["message"])
        counts[fp] = counts.get(fp, 0) + int(entry.get("count", 1))
    return counts


def write_baseline(path, findings, extra_entries=()):
    """Write the baseline for ``findings``; ``extra_entries`` are existing
    baseline entry dicts to carry over verbatim — the CLI uses this to
    preserve a tier's accepted findings when a refresh didn't run that tier
    (a static-only ``--write-baseline`` must not drop ``deep-*`` entries)."""
    grouped = {}
    for f in findings:
        grouped[f.fingerprint()] = grouped.get(f.fingerprint(), 0) + 1
    for entry in extra_entries:
        fp = (entry["rule"], entry["path"], entry["message"])
        grouped[fp] = grouped.get(fp, 0) + int(entry.get("count", 1))
    entries = [
        {"rule": rule, "path": p, "message": msg, "count": n}
        for (rule, p, msg), n in sorted(grouped.items())
    ]
    payload = {
        "comment": (
            "dinulint baseline of the PyTorch port: legacy findings that do "
            "not fail CI.  Refresh with: python -m "
            "coinstac_dinunet_tpu_torch.analysis coinstac_dinunet_tpu_torch "
            "--model --wire --tier5 --tier7 --device cpu --write-baseline "
            "--baseline "
            + os.path.basename(path)
        ),
        "findings": entries,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def filter_baselined(findings, baseline_counts):
    """Split findings into (new, baselined) honoring per-fingerprint counts."""
    budget = dict(baseline_counts)
    new, baselined = [], []
    for f in findings:
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            baselined.append(f)
        else:
            new.append(f)
    return new, baselined
