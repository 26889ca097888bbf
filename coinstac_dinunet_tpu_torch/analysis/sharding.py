"""sharding-*: mesh/axis conformance across the port's parallel layer.

Axis names ("site", "sp", "pp", …) are the port's second wire protocol: a
rank mesh (``parallel/mesh.py`` :class:`Mesh`) names its axes on one line
and its consumers — the axis lookups ``mesh.axis(NAME, row)`` and
``mesh.shape[NAME]``, the ``RankAxis(NAME, devices)`` views whose methods
are the collectives, the ``sp_axis=``/``tp_axis=`` hooks and the
``split=`` of the sharded steps' meshes — must agree with it.  A typo'd
axis only surfaces when that line runs on a mesh.  These rules, the JAX
package's ``analysis/sharding.py`` over the port's constructs, make it a
millisecond-scale static finding:

- ``sharding-unknown-axis`` — an axis name (in a mesh definition, an axis
  lookup, a ``RankAxis`` or an ``*_axis``/``axis_name(s)``/mesh ``split``
  kwarg) that the :class:`~coinstac_dinunet_tpu_torch.config.keys.MeshAxis`
  vocabulary does not declare: the typo case.
- ``sharding-mesh-arity`` — a mesh whose axis-name tuple cannot match its
  device array: ``Mesh(arr.reshape(a, b), names)`` or ``build_mesh((a, b),
  names)`` with another count of names, ``grid(...)`` (always two axes)
  with another count, or a mesh naming the same axis twice.
- ``sharding-axis-literal`` — a bare string literal in an axis position
  where the :class:`MeshAxis` constant exists: the vocabulary is only a
  single source of truth if call sites go through it.

Mesh constructors recognized: ``Mesh(devices, axis_names)``,
``grid(devices, rows, per_row, axis_names)``, ``build_mesh(sizes,
axis_names, ...)`` (the one the sharded steps' ``build_tsp_mesh`` and
``build_pp_mesh`` call), ``mesh.rename(axis_names)`` and the JAX spelling
``make_mesh(shape, names)``.  An axis tuple may be written inline or as a
module-level tuple of the same module (``TSP_AXES``).

Two rules of the JAX package have no counterpart construct in the port and
are not ported:

- ``sharding-spec-arity`` reads ``PartitionSpec`` literals (an axis used
  twice, or axes no mesh defines together).  The port has no
  ``PartitionSpec``: a tensor's placement is the list of its per-rank
  shards, built by the code that splits it.
- ``sharding-collective-scope`` flags a collective over a named axis
  outside any ``shard_map``/``pmap``, where the name is unbound.  The
  port's collectives are methods of the :class:`RankAxis` that names
  them (``mesh.axis(NAME, row).psum(xs)``), so a collective cannot run
  outside its binding, and the lookup raises at once for a name the mesh
  lacks.

Axis resolution understands both spellings — ``"site"`` (a *bare* literal)
and ``MeshAxis.SITE`` (the sanctioned constant, resolved by *parsing* the
port's ``config/keys.py``, never importing it) — so the conformance rules
keep checking migrated call sites while the literal rule enforces the
migration.
"""
import ast
import os

from .core import Finding, ProjectRule, register_rule, dotted_name

MESH_AXIS_CLASS = "MeshAxis"

#: callables that *define* a mesh: last dotted component -> index of the
#: axis-names argument (kwarg spelling: ``axis_names``)
_MESH_CTORS = {"Mesh": 1, "make_mesh": 1, "build_mesh": 1, "grid": 3, "rename": 0}

#: mesh constructors whose device array has a fixed rank
_FIXED_RANK = {"grid": 2}

#: constructors that are methods of an existing mesh: only a literal axis
#: tuple marks the call as a mesh (``os.rename(a, b)`` is not one)
_TUPLE_ONLY = {"rename"}

#: calls that *take* one axis name as their first argument: ``mesh.axis(
#: NAME, row)`` (attribute spelling only) and ``RankAxis(NAME, devices)``
_AXIS_LOOKUPS = {"axis": "lookup", "RankAxis": "rank-axis"}

#: kwargs naming axes on any call, and on the ``build_*`` mesh builders
#: only (``build_tsp_mesh(..., split="ep")``)
_AXIS_KWARGS = {"axis_name", "axis_names"}
_MESH_AXIS_KWARGS = {"split"}


def _keys_module_path():
    return os.path.normpath(
        os.path.join(os.path.dirname(__file__), "..", "config", "keys.py")
    )


def load_mesh_axes(keys_source=None):
    """Parse ``config/keys.py`` (source text or the port's own copy) into
    the ``{member: value}`` map of the :class:`MeshAxis` vocabulary."""
    if keys_source is None:
        with open(_keys_module_path(), "r", encoding="utf-8") as f:
            keys_source = f.read()
    tree = ast.parse(keys_source)
    axes = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == MESH_AXIS_CLASS:
            for stmt in node.body:
                if (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)
                ):
                    axes[stmt.targets[0].id] = stmt.value.value
    return axes


def _last(name):
    return name.rsplit(".", 1)[-1] if name else ""


class _AxisUse:
    """One statically-resolved axis name at a source position."""

    __slots__ = ("value", "node", "kind", "bare")

    def __init__(self, value, node, kind, bare):
        self.value = value    # resolved axis string
        self.node = node      # ast node carrying the position
        self.kind = kind      # 'mesh' | 'lookup' | 'rank-axis' | 'axis-kwarg'
        self.bare = bare      # True for a raw string literal


class _MeshDef:
    __slots__ = ("axes", "node", "ctor_rank")

    def __init__(self, axes, node, ctor_rank):
        self.axes = axes          # tuple of resolved names (None = dynamic)
        self.node = node
        self.ctor_rank = ctor_rank  # device-array rank when inferable


class _ModuleShardingInfo:
    def __init__(self):
        self.uses = []            # [_AxisUse]
        self.meshes = []          # [_MeshDef]


def _resolve_axis(node, axis_members):
    """expr -> (axis string, bare) or None when dynamic/unresolvable.

    Accepts a raw string literal or a ``MeshAxis.X`` attribute chain (any
    prefix: ``keys.MeshAxis.X`` resolves too).
    """
    if isinstance(node, ast.Constant):
        if isinstance(node.value, str):
            return node.value, True
        return None
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    parts.reverse()
    if len(parts) >= 2 and parts[-2] == MESH_AXIS_CLASS:
        value = axis_members.get(parts[-1])
        if value is not None:
            return value, False
    return None


def _module_axis_tuples(tree):
    """Module-level ``NAME = (axis, ...)`` tuples: name -> the tuple node."""
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, (ast.Tuple, ast.List))):
            out[node.targets[0].id] = node.value
    return out


class _Collector(ast.NodeVisitor):
    def __init__(self, axis_members, axis_tuples):
        self.axis_members = axis_members
        self.axis_tuples = axis_tuples
        self.info = _ModuleShardingInfo()

    def _record_use(self, resolved, node, kind):
        value, bare = resolved
        self.info.uses.append(_AxisUse(value, node, kind, bare))

    def _record_axis_arg(self, arg, kind):
        """One axis argument: a single name or a tuple of names; uses anchor
        to the innermost resolvable node."""
        elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
        for elt in elts:
            hit = _resolve_axis(elt, self.axis_members)
            if hit is not None:
                self._record_use(hit, elt, kind)

    def _handle_mesh(self, call, last):
        axes_ix = _MESH_CTORS[last]
        axes_arg = None
        if len(call.args) > axes_ix:
            axes_arg = call.args[axes_ix]
        else:
            for kw in call.keywords:
                if kw.arg == "axis_names":
                    axes_arg = kw.value
        if isinstance(axes_arg, ast.Name) and axes_arg.id in self.axis_tuples:
            # a module-level axis tuple; its uses anchor where it is written
            axes_arg = self.axis_tuples[axes_arg.id]
        if axes_arg is None:
            return
        if isinstance(axes_arg, (ast.Tuple, ast.List)):
            axes = []
            for elt in axes_arg.elts:
                hit = _resolve_axis(elt, self.axis_members)
                if hit is None:
                    axes.append(None)
                else:
                    self._record_use(hit, elt, "mesh")
                    axes.append(hit[0])
            self.info.meshes.append(
                _MeshDef(tuple(axes), call, self._ctor_rank(call, last))
            )
            return
        if last in _TUPLE_ONLY:
            return
        hit = _resolve_axis(axes_arg, self.axis_members)
        if hit is not None:  # Mesh(devs, "x") single-axis spelling
            self._record_use(hit, axes_arg, "mesh")
            self.info.meshes.append(
                _MeshDef((hit[0],), call, self._ctor_rank(call, last))
            )

    @staticmethod
    def _ctor_rank(call, last):
        """Rank of the device array when visible: a fixed-rank constructor,
        a ``....reshape(a, b, ...)`` first argument, or the sizes tuple of
        ``build_mesh``/``make_mesh``."""
        if last in _FIXED_RANK:
            return _FIXED_RANK[last]
        if not call.args:
            return None
        first = call.args[0]
        if last in ("make_mesh", "build_mesh"):
            if isinstance(first, (ast.Tuple, ast.List)):
                return len(first.elts)
            return None
        if (
            isinstance(first, ast.Call)
            and isinstance(first.func, ast.Attribute)
            and first.func.attr == "reshape"
        ):
            args = first.args
            if len(args) == 1 and isinstance(args[0], (ast.Tuple, ast.List)):
                return len(args[0].elts)
            if args and all(not isinstance(a, ast.Starred) for a in args):
                return len(args)
        return None

    def visit_Subscript(self, node):
        # mesh.shape[NAME]: the size of one axis
        if (isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "shape"):
            hit = _resolve_axis(node.slice, self.axis_members)
            if hit is not None:
                self._record_use(hit, node.slice, "lookup")
        self.generic_visit(node)

    def visit_Call(self, call):
        name = dotted_name(call.func, require_name_root=False)
        last = _last(name)
        consumed = set()  # kwargs the dedicated handlers already recorded
        if last in _MESH_CTORS:
            self._handle_mesh(call, last)
            consumed.add("axis_names")
        elif last in _AXIS_LOOKUPS and call.args and (
                last != "axis" or isinstance(call.func, ast.Attribute)):
            hit = _resolve_axis(call.args[0], self.axis_members)
            if hit is not None:
                self._record_use(hit, call.args[0], _AXIS_LOOKUPS[last])
        for kw in call.keywords:
            if kw.arg in consumed or not kw.arg:
                continue
            if (kw.arg in _AXIS_KWARGS or kw.arg.endswith("_axis")
                    or (kw.arg in _MESH_AXIS_KWARGS and last.startswith("build_"))):
                if isinstance(kw.value, (ast.Constant, ast.Tuple, ast.List,
                                         ast.Attribute)):
                    # ints and None resolve to None and are ignored
                    self._record_axis_arg(kw.value, "axis-kwarg")
        self.generic_visit(call)


def _collect(module, axis_members):
    """Per-module collection, cached on the Module object: the sharding
    rules share one AST walk per file (the cache key carries the axis
    vocabulary, so fixture rules with a custom ``keys_source`` never see a
    stale vocabulary's info)."""
    key = tuple(sorted(axis_members.items()))
    cache = getattr(module, "_sharding_info_cache", None)
    if cache is None:
        cache = module._sharding_info_cache = {}
    info = cache.get(key)
    if info is not None:
        return info
    collector = _Collector(axis_members, _module_axis_tuples(module.tree))
    collector.visit(module.tree)
    info = cache[key] = collector.info
    return info


class _ShardingBase(ProjectRule):
    """Shared collection; subclasses own one finding family each.

    ``keys_source`` overrides the ``config/keys.py`` source for fixture
    tests (mirroring :class:`~.protocol.ProtocolConformanceRule`).
    """

    def __init__(self, keys_source=None):
        self._keys_source = keys_source
        self._axis_members = None

    def axis_members(self):
        if self._axis_members is None:
            self._axis_members = load_mesh_axes(self._keys_source)
        return self._axis_members

    def vocab(self):
        return set(self.axis_members().values())

    def member_for(self, value):
        for member, v in self.axis_members().items():
            if v == value:
                return member
        return None

    def visit_module(self, module):
        return self.module_findings(module, _collect(module, self.axis_members()))

    def module_findings(self, module, info):
        return []

    def finalize(self, modules):
        return []

    def _finding(self, module, node, message):
        return Finding(
            rule=self.id, path=module.path, line=node.lineno,
            col=node.col_offset, message=message,
        )


@register_rule
class UnknownAxisRule(_ShardingBase):
    id = "sharding-unknown-axis"
    doc = ("Axis names in mesh definitions, axis lookups, RankAxis views, "
           "or *_axis kwargs that the config/keys.py MeshAxis vocabulary "
           "does not declare (typos).")

    def module_findings(self, module, info):
        vocab = self.vocab()
        findings = []
        for use in info.uses:
            if use.value not in vocab:
                findings.append(self._finding(
                    module, use.node,
                    f"axis name '{use.value}' ({use.kind}) is not declared "
                    "in the config/keys.py MeshAxis vocabulary "
                    f"(known: {', '.join(sorted(vocab))})",
                ))
        return findings


@register_rule
class MeshArityRule(_ShardingBase):
    id = "sharding-mesh-arity"
    doc = ("Mesh definitions whose axis-name tuple cannot match the device "
           "array (rank != axis count, or a duplicated axis name).")

    def module_findings(self, module, info):
        findings = []
        for mesh in info.meshes:
            named = [a for a in mesh.axes if a is not None]
            dupes = sorted({a for a in named if named.count(a) > 1})
            for a in dupes:
                findings.append(self._finding(
                    module, mesh.node,
                    f"mesh names axis '{a}' more than once",
                ))
            if mesh.ctor_rank is not None and mesh.ctor_rank != len(mesh.axes):
                findings.append(self._finding(
                    module, mesh.node,
                    f"mesh axis tuple has {len(mesh.axes)} name(s) but the "
                    f"device array is reshaped to rank {mesh.ctor_rank}",
                ))
        return findings


@register_rule
class AxisLiteralRule(_ShardingBase):
    id = "sharding-axis-literal"
    doc = ("Bare mesh-axis string literals in axis positions — use the "
           "MeshAxis constants from config/keys.py (the single source of "
           "truth the sharding rules check against).")

    def module_findings(self, module, info):
        findings = []
        for use in info.uses:
            if use.bare and use.value in self.vocab():
                member = self.member_for(use.value)
                findings.append(self._finding(
                    module, use.node,
                    f"bare mesh-axis literal '{use.value}' ({use.kind}) — "
                    f"use MeshAxis.{member} from config/keys.py",
                ))
        return findings
