"""trace-*: host hazards inside the port's step functions — the JAX
package's ``analysis/trace_hazards.py``.

Eager PyTorch traces nothing, so the JAX rules' "traced context" becomes
the port's **step functions**:

- the callables the deep entries return (the functions and lambdas built
  inside ``analysis/deepcheck.py``'s ``*_entry*`` builders);
- the ``step``/``*_step`` functions built inside ``make_*``/``build_*``/
  ``_build_*`` functions;
- ``forward`` and ``backward`` of each ``torch.autograd.Function``;

and, for the rules that follow calls, every function of the scanned tree
those reach through calls the analysis can resolve by name (``self.m()``
in the class and its relatives, same-module and imported functions,
``module.f()``, and methods of the package called on other receivers
unless the name is a container's, a tensor's or a recorder's).

- ``trace-host-sync`` — a synchronizing host↔device transfer in a step:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``float()``/``int()``/``bool()``
  of a tensor, ``np.asarray``/``np.array`` of a tensor (device→host), and
  ``torch.tensor``/``torch.as_tensor`` with a ``device=``, or ``.to(dev)``/
  ``.cuda()`` of a tensor made on the host in the same function
  (host→device, a pageable copy).  A value counts as a tensor when it
  comes from a ``torch`` call in the same function; the rest is host data.
  The static counterpart of ``perf-host-sync``, which observes the syncs
  of the deep entries' runs on the card (this rule finds the seven sites
  that one reports, without a card: ``PERF.md``).
- ``trace-impure`` — a draw from process-global random state in a step:
  ``np.random.*`` and stdlib ``random.*`` draws, ``os.urandom``, and the
  ``torch`` samplers called without ``generator=``.  Eager code reads them
  at every call (nothing is frozen as under ``jit``), but the step's result
  then depends on the process that ran it, which breaks the replay and
  parity contracts the engines pin.  A seeded ``np.random.default_rng(s)``
  is deterministic and exempt.
- ``trace-py-control`` — a Python ``if``/``while`` on a step function's
  tensor argument (the root functions only, as the JAX rule): the test
  calls ``bool()`` on the tensor, a device→host sync on the card
  (shape/dtype/``is None``/``isinstance`` tests are static and exempt).
- ``trace-set-iter`` — iterating a ``set`` in a step: the order varies
  across processes, so the processes of ``parallel/hosts.py`` build their
  leaves, and make their moves, in different orders.

``trace-telemetry`` is not carried: under ``jit`` a recorder call is
traced away, but eager code runs it where it stands and records what it
measures, so the construct the JAX rule checks does not exist here
(``PERF.md`` "Port faults").  Nor are wall-clock reads ``trace-impure``
findings: eager code reads the clock at every call.

Pure ``ast``; no torch import.
"""
import ast
import os

from .core import Finding, ProjectRule, dotted_name, register_rule

#: root step functions: names built inside these builders
_BUILDER_PREFIXES = ("make_", "build_", "_build_")
#: deepcheck's entry builders (their inner defs and lambdas are the steps)
_DEEPCHECK_SUFFIX = "analysis/deepcheck.py"

#: method names never resolved on an unknown receiver: containers', tensors',
#: modules', optimizers', files', threads', futures' and recorders' verbs
_COMMON_METHODS = frozenset({
    "add", "add_", "append", "apply", "backward", "cat", "clamp", "clear", "clone",
    "close", "contiguous", "copy", "copy_", "count", "cpu", "cuda", "detach", "dim",
    "discard", "div", "event", "eval", "expand", "extend", "fill_", "flatten", "float",
    "flush", "format", "forward", "get", "index", "insert", "item", "items", "join",
    "keys", "load", "load_state_dict", "mean", "modules", "mul", "mul_", "named_parameters",
    "numel", "numpy", "parameters", "permute", "pop", "put", "read", "register_buffer",
    "remove", "replace", "reshape", "result", "run", "save", "set_context", "setdefault",
    "size", "span", "split", "squeeze", "start", "state_dict", "step", "strip", "sub",
    "sub_", "submit", "sum", "to", "tolist", "train", "transpose", "type", "unsqueeze",
    "update", "values", "view", "wire", "write", "zero_", "zero_grad",
})

#: torch factories that make a tensor on the host unless given device=
_HOST_FACTORIES = frozenset({
    "arange", "as_tensor", "empty", "eye", "from_numpy", "full", "ones", "rand", "randint",
    "randn", "randperm", "tensor", "zeros",
})
#: torch samplers that draw from the global generator without generator=
_SAMPLERS = frozenset({
    "bernoulli", "multinomial", "normal", "rand", "rand_like", "randint", "randint_like",
    "randn", "randn_like", "randperm",
})
_INPLACE_SAMPLERS = frozenset({"bernoulli_", "exponential_", "normal_", "random_", "uniform_"})
#: seeded constructors of a deterministic host generator
_SEEDED = frozenset({"default_rng", "SeedSequence", "Generator", "PCG64", "Philox", "seed"})
_HOST_CASTS = {"float", "int", "bool"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda", "requires_grad"}


def _name(node):
    return dotted_name(node, require_name_root=False) or ""


def _module_dotted(path):
    p = path.replace(os.sep, "/")
    if p.endswith("/__init__.py"):
        p = p[: -len("/__init__.py")]
    elif p.endswith(".py"):
        p = p[:-3]
    return p.replace("/", ".")


class _Func:
    """One def (or lambda) of the scanned tree."""

    __slots__ = ("module", "node", "name", "cls", "parents")

    def __init__(self, module, node, name, cls, parents):
        self.module, self.node, self.name = module, node, name
        self.cls, self.parents = cls, parents


class _Index:
    """Defs, classes and imports of every scanned module, and the calls
    between them that resolve by name."""

    def __init__(self, modules):
        self.funcs = []
        self.by_module = {}    # (module path, name) -> [_Func] (module level)
        self.nested = {}       # (id(parent def node), name) -> _Func
        self.methods = {}      # name -> [_Func]
        self.class_methods = {}  # (module path, class) -> {name: _Func}
        self.module_paths = {}   # dotted module name -> module path
        self.imports = {}      # module path -> {alias: (dotted module, name or None)}
        for mod in modules:
            self.module_paths[_module_dotted(mod.path)] = mod.path
            self.imports[mod.path] = self._imports(mod)
            self._collect(mod, mod.tree.body, cls=None, parents=())

    def _imports(self, mod):
        here = _module_dotted(mod.path).split(".")
        pkg = here if mod.path.endswith("__init__.py") else here[:-1]
        out = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (a.name if a.asname else
                                                            a.name.split(".")[0], None)
            elif isinstance(node, ast.ImportFrom):
                base = pkg[: len(pkg) - node.level + 1] if node.level else []
                source = ".".join(base + ([node.module] if node.module else []))
                for a in node.names:
                    out[a.asname or a.name] = (source, a.name)
        return out

    def _collect(self, mod, body, cls, parents):
        for node in body:
            if isinstance(node, ast.ClassDef):
                methods = self.class_methods.setdefault((mod.path, node.name), {})
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        f = self._add(mod, sub, node, parents)
                        methods[sub.name] = f
                        self.methods.setdefault(sub.name, []).append(f)
                        self._collect(mod, sub.body, None, parents + (sub,))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                f = self._add(mod, node, cls, parents)
                if parents:
                    self.nested[(id(parents[-1]), node.name)] = f
                else:
                    self.by_module.setdefault((mod.path, node.name), []).append(f)
                self._collect(mod, node.body, None, parents + (node,))
            else:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, ast.stmt):
                        self._collect(mod, [child], cls, parents)

    def _add(self, mod, node, cls, parents):
        f = _Func(mod, node, node.name, cls, parents)
        self.funcs.append(f)
        return f

    def lambdas(self, mod, within):
        """Lambdas inside ``within`` (a def node), as pseudo-functions."""
        out = []
        for node in ast.walk(within):
            if isinstance(node, ast.Lambda):
                out.append(_Func(mod, node, "<lambda>", None, (within,)))
        return out

    # ------------------------------------------------------------ resolution
    def _module_funcs(self, dotted, name):
        path = self.module_paths.get(dotted)
        if path is None:
            return []
        found = self.by_module.get((path, name), [])
        if found:
            return found
        # a package re-export: follow the package's own import of the name
        target = self.imports.get(path, {}).get(name)
        if target and target[1] and target[0] != dotted:
            return self._module_funcs(target[0], target[1])
        return []

    def callees(self, f):
        """The defs the calls in ``f``'s own body resolve to, and the
        methods and functions it hands on as values (``fn=self._step``)."""
        out = []
        imports = self.imports.get(f.module.path, {})
        called = set()
        for call in _own_calls(f.node):
            called.add(id(call.func))
        own = self.class_methods.get((f.module.path, getattr(f.cls, "name", None)), {})
        for node in _own_nodes(f.node):
            if id(node) in called:
                continue
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and \
                    node.value.id in ("self", "cls") and node.attr in own:
                out.append(own[node.attr])
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                for parent in reversed((f.node,) + f.parents):
                    found = self.nested.get((id(parent), node.id))
                    if found:
                        out.append(found)
                        break
        for call in _own_calls(f.node):
            func = call.func
            if isinstance(func, ast.Name):
                found = None
                for parent in reversed((f.node,) + f.parents):
                    found = self.nested.get((id(parent), func.id))
                    if found:
                        break
                if found:
                    out.append(found)
                    continue
                local = self.by_module.get((f.module.path, func.id))
                if local:
                    out += local
                elif func.id in imports and imports[func.id][1]:
                    out += self._module_funcs(*imports[func.id])
            elif isinstance(func, ast.Attribute):
                recv = func.value
                if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
                    own = self.class_methods.get((f.module.path, getattr(f.cls, "name", None)),
                                                 {}).get(func.attr)
                    out += [own] if own else self.methods.get(func.attr, [])
                elif isinstance(recv, ast.Name) and recv.id in imports:
                    source, name = imports[recv.id]
                    dotted = f"{source}.{name}" if name else source
                    if dotted in self.module_paths:
                        out += self._module_funcs(dotted, func.attr)
                    elif func.attr not in _COMMON_METHODS:
                        out += self.methods.get(func.attr, [])
                elif func.attr not in _COMMON_METHODS:
                    out += self.methods.get(func.attr, [])
        return out


def _own_calls(node):
    """Calls in a def's (or lambda's) own body: nested defs, lambdas and
    classes are their own functions."""
    body = node.body if isinstance(node.body, list) else [node.body]
    stack, out = list(body), []
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(n, ast.Call):
            out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    out.sort(key=lambda c: (c.lineno, c.col_offset))
    return out


def _own_nodes(node):
    body = node.body if isinstance(node.body, list) else [node.body]
    stack = list(body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _is_autograd_function(cls):
    return any(_name(b).rsplit(".", 1)[-1] == "Function" for b in cls.bases)


def _roots(index):
    """The step functions: ``{_Func: reason}``."""
    roots = {}
    for f in index.funcs:
        node = f.node
        if f.cls is not None and _is_autograd_function(f.cls) and f.name in (
                "forward", "backward"):
            roots[f] = f"{f.name} of torch.autograd.Function `{f.cls.name}`"
        elif (f.name == "step" or f.name.endswith("_step")) and any(
                p.name.startswith(_BUILDER_PREFIXES) for p in f.parents):
            builder = next(p.name for p in reversed(f.parents)
                           if p.name.startswith(_BUILDER_PREFIXES))
            roots[f] = f"step built by `{builder}`"
        elif f.module.path.replace(os.sep, "/").endswith(_DEEPCHECK_SUFFIX) and any(
                "entry" in p.name for p in f.parents):
            roots[f] = "a deep entry's step"
    for f in list(index.funcs):
        if f.module.path.replace(os.sep, "/").endswith(_DEEPCHECK_SUFFIX) and \
                "entry" in f.name and not f.parents:
            for lam in index.lambdas(f.module, f.node):
                roots[lam] = "a deep entry's step"
    return roots


def _reach(index, roots):
    """Every function the roots reach, each with the root it came from."""
    seen = {f: f for f in roots}
    frontier = list(roots)
    while frontier:
        f = frontier.pop()
        for g in index.callees(f):
            if g not in seen:
                seen[g] = seen[f]
                frontier.append(g)
    return seen


# ------------------------------------------------------------- the checks
def _torch_call(node):
    return isinstance(node, ast.Call) and _name(node.func).split(".")[0] == "torch"


def _tensor_names(fn, before):
    """Names assigned in ``fn``'s own body, on lines before ``before``, from
    an expression holding a ``torch`` call or a method call on such a name
    (tensors), and the subset made on the host (a ``torch`` factory without
    ``device=``)."""
    tensors, host = set(), set()
    assigns = sorted((n for n in _own_nodes(fn) if isinstance(n, ast.Assign)
                      and n.end_lineno < before), key=lambda n: n.lineno)
    for node in assigns:
        value = node.value
        is_tensor = any(_torch_call(c) or (
            isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
            and isinstance(c.func.value, ast.Name) and c.func.value.id in tensors)
            for c in ast.walk(value))
        on_host = (_torch_call(value) and _name(value.func).rsplit(".", 1)[-1] in _HOST_FACTORIES
                   and not any(kw.arg == "device" for kw in value.keywords))
        for t in node.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    (tensors.add if is_tensor else tensors.discard)(n.id)
                    (host.add if on_host else host.discard)(n.id)
    return tensors, host


def _mentions(node, names):
    return any(isinstance(n, ast.Name) and n.id in names for n in ast.walk(node))


def _device_arg(call):
    """The device a ``.to(...)`` call names, or None (a dtype-only cast)."""
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    for a in call.args:
        name = _name(a)
        if not (name.startswith("torch.") and name != "torch.device"):
            return a
    return None


def _cpu_literal(node):
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _host_syncs(f):
    """``(node, message)`` of each host↔device transfer in ``f``."""
    out = []
    for call in _own_calls(f.node):
        tensors, host = _tensor_names(f.node, call.lineno)
        func = call.func
        name = _name(func)
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(func, ast.Attribute) and func.attr in ("item", "tolist", "cpu") \
                and not call.args:
            out.append((call, f"`.{func.attr}()` copies a tensor to the host and waits "
                              "for the card"))
        elif isinstance(func, ast.Name) and func.id in _HOST_CASTS and call.args and (
                _torch_call(call.args[0]) or _mentions(call.args[0], tensors)):
            out.append((call, f"`{func.id}()` of a tensor reads it on the host (a "
                              "device->host sync)"))
        elif name in ("np.asarray", "np.array", "numpy.asarray", "numpy.array") and \
                call.args and (_torch_call(call.args[0]) or _mentions(call.args[0], tensors)):
            out.append((call, f"`{name}()` of a tensor pulls it to host memory"))
        elif name in ("torch.tensor", "torch.as_tensor") and any(
                kw.arg == "device" and not _cpu_literal(kw.value) for kw in call.keywords):
            out.append((call, f"`{name}(..., device=...)` copies host data to the device "
                              "(a pageable host->device copy waits)"))
        elif isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name) and \
                func.value.id in host and (leaf == "cuda" or (
                    leaf == "to" and _device_arg(call) is not None
                    and not _cpu_literal(_device_arg(call)))):
            out.append((call, f"`{func.value.id}.{leaf}(...)` copies a tensor made on the "
                              "host to the device (a pageable host->device copy waits)"))
    return out


def _impure(f):
    imports = {}
    for node in ast.walk(f.module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imports[a.asname or a.name] = a.name
    out = []
    for call in _own_calls(f.node):
        name = _name(call.func)
        parts = name.split(".")
        leaf = parts[-1]
        has_gen = any(kw.arg == "generator" for kw in call.keywords)
        if leaf in _SEEDED and (call.args or call.keywords):
            continue
        if name.startswith(("np.random.", "numpy.random.")) or name == "os.urandom" or (
                len(parts) == 2 and parts[0] == "random" and imports.get("random") == "random"):
            out.append((call, f"`{name}()` draws from process-global host random state"))
        elif parts[0] == "torch" and leaf in _SAMPLERS and not has_gen:
            out.append((call, f"`{name}()` without generator= draws from torch's global "
                              "generator"))
        elif isinstance(call.func, ast.Attribute) and leaf in _INPLACE_SAMPLERS and not has_gen:
            out.append((call, f"`.{leaf}()` without generator= draws from torch's global "
                              "generator"))
    return out


def _test_is_static(test):
    if isinstance(test, ast.BoolOp):
        return all(_test_is_static(v) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _test_is_static(test.operand)
    for node in ast.walk(test):
        if isinstance(node, ast.Compare):
            comps = [node.left] + list(node.comparators)
            if any(isinstance(c, ast.Constant) and c.value is None for c in comps):
                return True
        if isinstance(node, ast.Call):
            if _name(node.func).rsplit(".", 1)[-1] in {"isinstance", "len", "hasattr",
                                                        "callable"}:
                return True
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return True
    return False


def _py_control(f):
    node = f.node
    if isinstance(node, ast.Lambda):
        return []
    args = node.args
    params = {a.arg for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
              } - {"self", "cls", "ctx"}
    out = []
    for n in _own_nodes(node):
        if isinstance(n, (ast.If, ast.While)) and not _test_is_static(n.test):
            hit = sorted({x.id for x in ast.walk(n.test) if isinstance(x, ast.Name)} & params)
            if hit:
                kind = "if" if isinstance(n, ast.If) else "while"
                out.append((n, f"Python `{kind}` on `{', '.join(hit)}` — `bool()` of a "
                               "tensor argument waits for the card (a device->host sync); "
                               "use torch.where or keep the test on host values"))
    return out


def _set_iters(f):
    out = []
    for n in _own_nodes(f.node):
        it = n.iter if isinstance(n, (ast.For, ast.comprehension)) else None
        if it is not None and (isinstance(it, ast.Set) or (
                isinstance(it, ast.Call) and _name(it.func).rsplit(".", 1)[-1] == "set")):
            out.append((it, "iterating a `set` in a step: its order varies across "
                            "processes, so the processes of a multi-process mesh build "
                            "leaves and make moves in different orders — sort it first"))
    return out


#: the last scan's step functions: the four rules of one run share them
_LAST = [None, None]


def _step_functions(modules):
    """``(roots, reach)`` of a scan, computed once for the rules of a run."""
    if _LAST[0] is not modules:
        index = _Index(modules)
        roots = _roots(index)
        _LAST[:] = [modules, (roots, _reach(index, roots))]
    return _LAST[1]


class _StepHazardBase(ProjectRule):
    """Shared machinery: the step functions of the whole scan, then one
    check per rule."""

    check = None
    roots_only = False

    def finalize(self, modules):
        roots, reach = _step_functions(modules)
        reached = roots if self.roots_only else reach
        findings, seen = [], set()
        for f, root in sorted(reached.items(), key=lambda kv: (kv[0].module.path,
                                                                 kv[0].node.lineno)):
            root = f if self.roots_only else root
            where = (f"in step `{f.name}`, {roots[root]}" if f is root else
                     f"in `{f.name}`, called from a step function")
            for node, message in type(self).check(f):
                # a method call's line is its name's (``.tolist()`` on the
                # continuation line of a chained call), as a traceback's
                line = (node.func.end_lineno if isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute) else node.lineno)
                key = (f.module.path, line, node.col_offset)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(rule=self.id, path=f.module.path, line=line,
                                        col=node.col_offset, message=f"{message} ({where})"))
        return findings


@register_rule
class HostSyncRule(_StepHazardBase):
    id = "trace-host-sync"
    doc = (".item()/.tolist()/.cpu()/float() of a tensor and host->device copies "
           "inside the port's step functions — synchronizing transfers.")
    check = staticmethod(_host_syncs)


@register_rule
class ImpureCallRule(_StepHazardBase):
    id = "trace-impure"
    doc = "process-global random draws inside the port's step functions."
    check = staticmethod(_impure)


@register_rule
class PyControlFlowRule(_StepHazardBase):
    id = "trace-py-control"
    doc = "Python if/while on a step function's tensor arguments (a bool() sync)."
    check = staticmethod(_py_control)
    roots_only = True


@register_rule
class SetIterationRule(_StepHazardBase):
    id = "trace-set-iter"
    doc = ("set iteration inside the port's step functions — cross-process "
           "order divergence.")
    check = staticmethod(_set_iters)
