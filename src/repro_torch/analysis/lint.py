"""repro-lint for the port: static analysis that locks in the hot-path
rules of ``repro_torch`` (port of ``repro/analysis/lint.py``).

The port's speed rests on invariants kept by hand: every CUDA graph goes
through ``core.compile_cache.GraphCache``, so captures stay counted and
bounded and a replay never meets a value baked in by another call;
captured bodies never wait on the host; storage handed over for writing
in place is not read again as if it held the old values; and library
code never guards correctness behind a bare ``assert`` (it vanishes under
``python -O``). The reference's rules restated for PyTorch:

R1  capture hazards
    A CUDA graph (``torch.cuda.CUDAGraph``, ``torch.cuda.graph``,
    ``torch.cuda.make_graphed_callables``) or ``torch.compile`` outside
    ``core/compile_cache.py``; a ``GraphCache`` built inside a ``for`` /
    ``while`` body (a fresh cache per pass captures every pass); and a
    Python scalar (``len(x)``, ``x.shape[i]``, ``int(...)``) passed to
    ``GraphCache.call`` as a non-tensor leaf of its arguments — it is
    baked into the graph and every distinct value keys a new capture, so
    it belongs in a tensor.

R2  host syncs in captured code
    ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
    ``torch.cuda.synchronize()`` and ``int()`` / ``float()`` / ``bool()``
    on non-constant values inside functions reachable from a body passed
    to ``GraphCache.call`` (a call-graph walk over the scanned tree), plus
    ``if`` statements on parameters of such a body (a tensor's truth
    value is a sync). Scalar conversions of ``.shape`` / ``len()``
    expressions are host values already and exempt.

R3  donation misuse
    A name handed over for writing in place and then read later in the
    same scope — its storage then holds the new values. Donated are: the
    first two arguments (params, optimizer state) of a function that
    ``jit_train_step`` built and the third (the cache) of one
    ``jit_serve_step`` built, unless built with ``donate=False``; and
    the engines' ``donate=True`` (the stack, 2nd positional) and
    ``donate_params=True`` (the params, 1st positional) keywords. The
    check is linear within a statement list; a statement that rebinds the
    name clears it.

R4  dead public API / drift
    Public functions of the kernel package (``repro_torch/kernels/*.py``)
    and the model registry (``models/registry.py``) referenced from no
    other scanned module.

R5  bare ``assert`` in library code
    Disabled under ``python -O``. Library invariants raise ``ValueError``
    / ``RuntimeError``.

Suppression: append ``# repro-lint: disable=R1`` (comma-separate multiple
rules, or ``disable=all``) to the offending line, or put the comment alone
on the line directly above. Findings are matched against the baseline
(``tools/lint_baseline_torch.json``) by ``(rule, path, key)`` where
``key`` is the stripped source line (or the symbol name, for R4) —
line-number-free, so baselines survive unrelated edits and diff cleanly.

The module is dependency-free (stdlib ``ast`` / ``tokenize`` only) and
keeps its own copy of the reference's engine: it imports neither torch
nor the reference.
"""
from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES = {
    "R1": "capture hazard (CUDA graph / torch.compile outside GraphCache, "
          "GraphCache in a loop, python scalar into GraphCache.call)",
    "R2": "host sync reachable from captured code",
    "R3": "donated storage read after donation",
    "R4": "dead public API (kernel/registry orphan)",
    "R5": "bare assert in library code",
}

PACKAGE = "repro_torch"

# graph constructors that belong in core/compile_cache.py alone
_GRAPH_APIS = {"torch.cuda.CUDAGraph", "torch.cuda.graph",
               "torch.cuda.graphs.CUDAGraph", "torch.cuda.graphs.graph",
               "torch.cuda.make_graphed_callables", "torch.compile"}

# mesh-step makers: the positions of the made function's donated args
_DONATING_MAKERS = {"jit_train_step": (0, 1), "jit_serve_step": (2,)}

_HOST_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*disable=((?:R\d+|all)(?:\s*,\s*(?:R\d+|all))*)")


@dataclass
class Finding:
    rule: str
    path: str          # posix path relative to the scan root's repo
    line: int
    message: str
    key: str           # line-number-free baseline key
    baselined: bool = False

    def sort_key(self):
        return (self.path, self.line, self.rule, self.key)

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "key": self.key,
                "baselined": self.baselined}


def baseline_key(f: Finding) -> Tuple[str, str, str]:
    return (f.rule, f.path, f.key)


# ---------------------------------------------------------------------------
# Per-module model
# ---------------------------------------------------------------------------

class _Module:
    def __init__(self, relpath: str, source: str):
        self.relpath = relpath.replace("\\", "/")
        self.source = source
        self.tree = ast.parse(source)
        self.lines = source.splitlines()
        self.imports = self._imports(self.tree)
        self.suppress = self._suppressions(source)
        # dotted module path for cross-module resolution:
        # "src/repro_torch/core/fedavg.py" -> "repro_torch.core.fedavg"
        p = self.relpath[:-3] if self.relpath.endswith(".py") else self.relpath
        parts = p.split("/")
        if PACKAGE in parts:
            parts = parts[parts.index(PACKAGE):]
        self.modpath = ".".join(parts)
        if self.modpath.endswith(".__init__"):
            self.modpath = self.modpath[:-len(".__init__")]
        self.graph_caches = self._graph_caches(self.tree)

    @staticmethod
    def _imports(tree) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    @staticmethod
    def _suppressions(source: str) -> Dict[int, Set[str]]:
        out: Dict[int, Set[str]] = {}
        try:
            toks = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if m:
                    out[tok.start[0]] = {r.strip() for r in
                                         m.group(1).split(",") if r.strip()}
        except tokenize.TokenError:
            pass
        return out

    def _graph_caches(self, tree) -> Set[str]:
        """Names (the last part of a name or attribute chain) that hold a
        ``GraphCache``: assigned ``GraphCache()`` anywhere in the module,
        or a parameter annotated ``GraphCache``."""
        out: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    and isinstance(node.value, (ast.Call, ast.Tuple)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    pairs = (zip(t.elts, node.value.elts)
                             if isinstance(t, ast.Tuple)
                             and isinstance(node.value, ast.Tuple)
                             else [(t, node.value)])
                    for tgt, val in pairs:
                        if self.is_graph_cache_ctor(val):
                            name = _terminal(tgt)
                            if name:
                                out.add(name)
            elif isinstance(node, ast.arg) and node.annotation is not None \
                    and _terminal(node.annotation) == "GraphCache":
                out.add(node.arg)
        return out

    def is_graph_cache_ctor(self, node) -> bool:
        return isinstance(node, ast.Call) and (
            (self.resolve(node.func) or "").endswith("GraphCache")
            or _terminal(node.func) == "GraphCache")

    def graph_call(self, node) -> bool:
        """Is ``node`` a ``<GraphCache>.call(name, fn, args, ...)``?"""
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "call"
                and _terminal(node.func.value) in self.graph_caches)

    def resolve(self, node) -> Optional[str]:
        """Dotted path of a Name/Attribute chain via the import map."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.imports.get(node.id)
        if base is None:
            return None
        return ".".join([base] + parts[::-1])

    def suppressed(self, line: int, rule: str) -> bool:
        for ln in (line, line - 1):
            rs = self.suppress.get(ln)
            if not rs or not (rule in rs or "all" in rs):
                continue
            if ln == line:
                return True
            # the preceding line counts only if it is a pure comment line
            if 1 <= ln <= len(self.lines) \
                    and self.lines[ln - 1].lstrip().startswith("#"):
                return True
        return False

    def key_for(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return " ".join(self.lines[line - 1].split())
        return ""


def _terminal(node) -> Optional[str]:
    """The last name of a Name / Attribute chain (``self._graphs`` ->
    ``_graphs``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _graph_call_parts(call: ast.Call):
    """(fn expression, args expression) of a ``GraphCache.call``."""
    fn = call.args[1] if len(call.args) > 1 else None
    args = call.args[2] if len(call.args) > 2 else None
    for kw in call.keywords:
        if kw.arg == "fn":
            fn = kw.value
        elif kw.arg == "args":
            args = kw.value
    return fn, args


# ---------------------------------------------------------------------------
# Function index + call graph (R2)
# ---------------------------------------------------------------------------

@dataclass
class _Func:
    uid: str
    node: object                      # FunctionDef / AsyncFunctionDef / Lambda
    mod: _Module
    name: str
    class_name: Optional[str]
    params: List[str] = field(default_factory=list)
    nested: Dict[str, "_Func"] = field(default_factory=dict)


class _Index:
    """Project-wide function/lambda index with name-resolution helpers."""

    def __init__(self, modules: Sequence[_Module]):
        self.modules = modules
        self.funcs: Dict[str, _Func] = {}          # uid -> _Func
        self.by_node: Dict[int, _Func] = {}        # id(ast node) -> _Func
        self.top: Dict[Tuple[str, str], _Func] = {}       # (modpath, name)
        self.methods: Dict[Tuple[str, str, str], _Func] = {}
        for mod in modules:
            self._index_module(mod)

    def _index_module(self, mod: _Module):
        def visit(node, class_name, parent: Optional[_Func]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name, None)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    f = self._add(child, mod, child.name, class_name)
                    if parent is not None:
                        parent.nested[child.name] = f
                    elif class_name is not None:
                        self.methods[(mod.modpath, class_name,
                                      child.name)] = f
                    else:
                        self.top[(mod.modpath, child.name)] = f
                    visit(child, None, f)
                else:
                    # lambdas anywhere (call args, assignments, ...)
                    for sub in ast.walk(child):
                        if isinstance(sub, ast.Lambda):
                            self._add(sub, mod, "<lambda>", class_name)
                    visit(child, class_name, parent)
        visit(mod.tree, None, None)

    def _add(self, node, mod: _Module, name: str,
             class_name: Optional[str]) -> _Func:
        if id(node) in self.by_node:
            return self.by_node[id(node)]
        uid = f"{mod.relpath}:{name}:{node.lineno}"
        a = node.args
        params = [p.arg for p in
                  list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]
        if a.vararg:
            params.append(a.vararg.arg)
        f = _Func(uid, node, mod, name, class_name, params)
        self.funcs[uid] = f
        self.by_node[id(node)] = f
        return f

    def resolve_callee(self, expr, mod: _Module,
                       scope: Optional[_Func]) -> Optional[_Func]:
        """Best-effort: map a callee/argument expression to an indexed
        function (nested def, module-level def, method via self, or an
        imported project function)."""
        if isinstance(expr, ast.Lambda):
            return self.by_node.get(id(expr))
        if isinstance(expr, ast.Call):            # functools.partial(f, ...)
            if mod.resolve(expr.func) == "functools.partial" and expr.args:
                return self.resolve_callee(expr.args[0], mod, scope)
            return None
        if isinstance(expr, ast.Name):
            if scope is not None and expr.id in scope.nested:
                return scope.nested[expr.id]
            hit = self.top.get((mod.modpath, expr.id))
            if hit is not None:
                return hit
            dotted = mod.imports.get(expr.id)
            if dotted:
                return self._by_dotted(dotted)
            return None
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                    and scope is not None and scope.class_name:
                return self.methods.get((mod.modpath, scope.class_name,
                                         expr.attr))
            dotted = mod.resolve(expr)
            if dotted:
                return self._by_dotted(dotted)
        return None

    def _by_dotted(self, dotted: str) -> Optional[_Func]:
        if "." not in dotted:
            return None
        modpath, name = dotted.rsplit(".", 1)
        return self.top.get((modpath, name))


def _body_nodes(func: _Func):
    """AST nodes of a function body, not descending into nested function
    definitions or lambdas (those are separate indexed functions)."""
    node = func.node
    roots = node.body if isinstance(node.body, list) else [node.body]
    stack = list(roots)
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


# ---------------------------------------------------------------------------
# Rule implementations
# ---------------------------------------------------------------------------

def _scalar_shaped(expr, mod: _Module) -> bool:
    """Does ``expr`` itself evaluate to a Python scalar derived from
    shapes/lengths (a value a graph bakes in)?  Top-level structure only —
    a ``len()`` buried inside another call's arguments produces whatever
    that call returns, not a scalar."""
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and expr.func.id in ("len", "int") \
            and expr.func.id not in mod.imports:
        return True
    if isinstance(expr, ast.Attribute) and expr.attr in ("shape", "ndim"):
        return True
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr in ("size", "dim", "numel"):
        return True
    if isinstance(expr, ast.Subscript):
        return _scalar_shaped(expr.value, mod)
    if isinstance(expr, ast.BinOp):
        return (_scalar_shaped(expr.left, mod)
                or _scalar_shaped(expr.right, mod))
    if isinstance(expr, ast.UnaryOp):
        return _scalar_shaped(expr.operand, mod)
    return False


def _rule_r1(mod: _Module, findings: List[Finding]):
    in_cache = mod.relpath.endswith("core/compile_cache.py")
    loop_stack: List[object] = []

    def visit(node):
        is_loop = isinstance(node, (ast.For, ast.While))
        if is_loop:
            loop_stack.append(node)
        r = mod.resolve(node) if isinstance(node, (ast.Attribute, ast.Name)) \
            else None
        if not in_cache and r in _GRAPH_APIS \
                and not isinstance(getattr(node, "ctx", None), ast.Store):
            findings.append(Finding(
                "R1", mod.relpath, node.lineno,
                f"{r} outside core.compile_cache.GraphCache — captures are "
                "uncounted and their baked-in values unchecked; route "
                "through a GraphCache (or suppress with justification)",
                mod.key_for(node.lineno)))
        if loop_stack and mod.is_graph_cache_ctor(node):
            findings.append(Finding(
                "R1", mod.relpath, node.lineno,
                "GraphCache built inside a loop body: a fresh cache every "
                "pass captures every pass; hoist it", mod.key_for(
                    node.lineno)))
        for child in ast.iter_child_nodes(node):
            visit(child)
        if is_loop:
            loop_stack.pop()

    visit(mod.tree)

    # python scalars baked into a GraphCache.call's graph
    for node in ast.walk(mod.tree):
        if not mod.graph_call(node):
            continue
        _, args = _graph_call_parts(node)
        elts = args.elts if isinstance(args, (ast.Tuple, ast.List)) else []
        if any(_scalar_shaped(a, mod) for a in elts):
            findings.append(Finding(
                "R1", mod.relpath, node.lineno,
                "python scalar argument to GraphCache.call is baked into "
                "the graph — every distinct value captures anew; pass it "
                "as a tensor", mod.key_for(node.lineno)))


def _rule_r5(mod: _Module, findings: List[Finding]):
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assert):
            findings.append(Finding(
                "R5", mod.relpath, node.lineno,
                "bare assert in library code vanishes under python -O; "
                "raise ValueError/RuntimeError instead",
                mod.key_for(node.lineno)))


def _donating_maker(call) -> Optional[Tuple[int, ...]]:
    """The donated positions of the function a ``jit_*`` maker call
    returns (None: not a maker, or made with ``donate=False``)."""
    if not isinstance(call, ast.Call):
        return None
    pos = _DONATING_MAKERS.get(_terminal(call.func))
    if pos is None:
        return None
    for kw in call.keywords:
        if kw.arg == "donate" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return None
    return pos


def _donated_names(stmt, donors: Dict[str, Tuple[int, ...]]
                   ) -> List[Tuple[str, int]]:
    """(name, line) pairs donated by calls inside ``stmt``."""
    out: List[Tuple[str, int]] = []
    for call in (n for n in ast.walk(stmt) if isinstance(n, ast.Call)):
        # a function a jit_* maker returned donating
        if isinstance(call.func, ast.Name) and call.func.id in donors:
            for i in donors[call.func.id]:
                if i < len(call.args) and isinstance(call.args[i], ast.Name):
                    out.append((call.args[i].id, call.lineno))
        # engine keywords: donate=True donates the stack (2nd positional),
        # donate_params=True the params (1st positional).  The jit_*
        # makers take ``donate`` for the function they RETURN.
        if _terminal(call.func) in _DONATING_MAKERS:
            continue
        for kw in call.keywords:
            if not (isinstance(kw.value, ast.Constant)
                    and kw.value.value is True):
                continue
            pos = {"donate": 1, "donate_params": 0}.get(kw.arg)
            if pos is not None and pos < len(call.args) \
                    and isinstance(call.args[pos], ast.Name):
                out.append((call.args[pos].id, call.lineno))
    return out


def _assigned_names(stmt) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(stmt):
        if isinstance(n, ast.Name) and isinstance(n.ctx,
                                                  (ast.Store, ast.Del)):
            out.add(n.id)
    return out


def _maker_targets(stmt) -> Dict[str, Tuple[int, ...]]:
    """Names bound to a donating function by ``stmt``: ``fn = jit_*(...)``
    or ``fn, specs = jit_*(...)``."""
    if not isinstance(stmt, ast.Assign):
        return {}
    pos = _donating_maker(stmt.value)
    if pos is None:
        return {}
    out = {}
    for t in stmt.targets:
        first = t.elts[0] if isinstance(t, ast.Tuple) and t.elts else t
        if isinstance(first, ast.Name):
            out[first.id] = pos
    return out


def _rule_r3(mod: _Module, findings: List[Finding]):
    def check_body(body: List):
        live: Dict[str, int] = {}            # donated name -> donation line
        donors: Dict[str, Tuple[int, ...]] = {}
        for stmt in body:
            if live:
                reads = [n for n in ast.walk(stmt)
                         if isinstance(n, ast.Name)
                         and isinstance(n.ctx, ast.Load) and n.id in live]
                for n in reads:
                    if n.id not in live:     # already reported this stmt
                        continue
                    findings.append(Finding(
                        "R3", mod.relpath, n.lineno,
                        f"'{n.id}' was donated at line {live[n.id]} and is "
                        "read afterwards — its storage now holds the new "
                        "values; copy before donating or drop the donation",
                        mod.key_for(n.lineno)))
                    live.pop(n.id, None)
            donated = _donated_names(stmt, donors)
            assigned = _assigned_names(stmt)
            for name, line in donated:
                if name not in assigned:     # rebinding clears the hazard
                    live[name] = line
            for name in assigned:
                live.pop(name, None)
                donors.pop(name, None)
            donors.update(_maker_targets(stmt))

    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            check_body(node.body)
    check_body(mod.tree.body)


def _host_sync(n, mod: _Module) -> Optional[str]:
    """The host sync ``n`` is, if any."""
    if not isinstance(n, ast.Call):
        return None
    if isinstance(n.func, ast.Attribute) \
            and n.func.attr in _HOST_SYNC_METHODS:
        return f".{n.func.attr}()"
    if isinstance(n.func, ast.Name) and n.func.id in ("int", "float", "bool") \
            and n.func.id not in mod.imports and n.args \
            and not isinstance(n.args[0], ast.Constant) \
            and not _scalar_shaped(n.args[0], mod):
        return f"{n.func.id}()"
    if mod.resolve(n.func) == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    return None


def _rule_r2(modules: Sequence[_Module], index: _Index,
             findings: List[Finding]):
    roots: Dict[str, str] = {}               # uid -> why it is captured

    def scan_calls(owner: Optional[_Func], nodes, mod: _Module):
        for n in nodes:
            if not mod.graph_call(n):
                continue
            fn, _ = _graph_call_parts(n)
            f = index.resolve_callee(fn, mod, owner) if fn is not None \
                else None
            if f is not None:
                roots.setdefault(f.uid, "GraphCache.call")

    for f in index.funcs.values():
        scan_calls(f, _body_nodes(f), f.mod)
    for mod in modules:
        top_nodes = []
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            top_nodes.extend(ast.walk(stmt))
        scan_calls(None, top_nodes, mod)

    # reachability over intra-project call edges
    reach: Dict[str, str] = dict(roots)
    frontier = list(roots)
    while frontier:
        uid = frontier.pop()
        f = index.funcs[uid]
        for n in _body_nodes(f):
            if not isinstance(n, ast.Call):
                continue
            callee = index.resolve_callee(n.func, f.mod, f)
            if callee is not None and callee.uid not in reach:
                reach[callee.uid] = reach[uid]
                frontier.append(callee.uid)

    # host syncs inside reachable functions
    for uid, why in sorted(reach.items()):
        f = index.funcs[uid]
        for n in _body_nodes(f):
            sync = _host_sync(n, f.mod)
            if sync:
                findings.append(Finding(
                    "R2", f.mod.relpath, n.lineno,
                    f"host sync {sync} inside code reachable from a "
                    f"captured body ({why}) waits on the card and fails a "
                    "capture — hoist it out of the graph",
                    f.mod.key_for(n.lineno)))

    # `if` on parameters of the bodies handed to GraphCache.call
    for uid in sorted(roots):
        f = index.funcs[uid]
        params = {p for p in f.params if p not in ("self", "cls")}
        if not params:
            continue
        for n in _body_nodes(f):
            if not isinstance(n, ast.If):
                continue
            hits = [x.id for x in ast.walk(n.test)
                    if isinstance(x, ast.Name) and x.id in params]
            # exclude names only used as attribute bases (static config
            # branching like `cfg.sliding_window`) or in `is None` tests
            bases = {x.value.id for x in ast.walk(n.test)
                     if isinstance(x, ast.Attribute)
                     and isinstance(x.value, ast.Name)}
            nones = {x.left.id for x in ast.walk(n.test)
                     if isinstance(x, ast.Compare)
                     and isinstance(x.left, ast.Name)
                     and all(isinstance(o, (ast.Is, ast.IsNot))
                             for o in x.ops)}
            hits = [h for h in hits if h not in bases | nones]
            if hits:
                findings.append(Finding(
                    "R2", f.mod.relpath, n.lineno,
                    f"`if` on captured value '{hits[0]}' inside a body "
                    f"handed to {roots[uid]} — a tensor's truth value is a "
                    "host sync; use torch.where, or pass the flag as a "
                    "non-tensor leaf", f.mod.key_for(n.lineno)))


def _rule_r4(modules: Sequence[_Module], findings: List[Finding]):
    api_mods = [m for m in modules
                if ("/kernels/" in m.relpath
                    and not m.relpath.endswith("__init__.py"))
                or m.relpath.endswith("models/registry.py")]
    if not api_mods:
        return
    refs: Dict[str, Set[str]] = {}           # identifier -> modules using it
    for m in modules:
        for n in ast.walk(m.tree):
            name = None
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                name = n.id
            elif isinstance(n, ast.Attribute):
                name = n.attr
            elif isinstance(n, ast.alias):
                name = n.name
            if name:
                refs.setdefault(name, set()).add(m.relpath)
    for m in api_mods:
        for stmt in m.tree.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name.startswith("_"):
                continue
            users = refs.get(stmt.name, set()) - {m.relpath}
            if not users:
                stem = m.relpath.rsplit("/", 1)[-1][:-3]
                findings.append(Finding(
                    "R4", m.relpath, stmt.lineno,
                    f"public '{stem}.{stmt.name}' is referenced by no other"
                    " library module (comments/docstrings/tests only) — "
                    "wire it into the hot path or track it as an open "
                    "item", key=f"{stem}.{stmt.name}"))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def scan_sources(sources: Dict[str, str]) -> List[Finding]:
    """Lint a mapping of ``relpath -> source``. Cross-module rules (R2 call
    graph, R4 references) see exactly the modules passed in."""
    modules = []
    for relpath, src in sorted(sources.items()):
        try:
            modules.append(_Module(relpath, src))
        except SyntaxError as e:
            raise ValueError(f"{relpath}: cannot parse: {e}") from e
    findings: List[Finding] = []
    for mod in modules:
        _rule_r1(mod, findings)
        _rule_r3(mod, findings)
        _rule_r5(mod, findings)
    index = _Index(modules)
    _rule_r2(modules, index, findings)
    _rule_r4(modules, findings)
    by_mod = {m.relpath: m for m in modules}
    kept = [f for f in findings
            if not by_mod[f.path].suppressed(f.line, f.rule)]
    # identical (rule, line, key) duplicates add noise, not information
    seen: Set[Tuple] = set()
    out = []
    for f in sorted(kept, key=Finding.sort_key):
        k = (f.rule, f.path, f.line, f.key)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


def scan_paths(root, paths: Optional[Iterable] = None) -> List[Finding]:
    """Lint ``.py`` files under ``root`` (default scope: ``src/repro_torch``).

    ``root`` is the repo root; findings carry repo-relative posix paths.
    """
    root = Path(root)
    targets = [Path(p) for p in paths] if paths else [root / "src" / PACKAGE]
    sources: Dict[str, str] = {}
    for t in targets:
        t = t if t.is_absolute() else root / t
        files = sorted(t.rglob("*.py")) if t.is_dir() else [t]
        for fp in files:
            rel = fp.relative_to(root).as_posix()
            sources[rel] = fp.read_text()
    return scan_sources(sources)


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def load_baseline(path) -> Set[Tuple[str, str, str]]:
    p = Path(path)
    if not p.exists():
        return set()
    data = json.loads(p.read_text())
    return {(e["rule"], e["path"], e["key"]) for e in data.get("findings",
                                                              [])}


def make_baseline(findings: Sequence[Finding]) -> str:
    """Deterministic baseline JSON: sorted, deduped, repo-relative paths."""
    entries = sorted({baseline_key(f) for f in findings})
    payload = {
        "comment": "repro-lint baseline of the PyTorch port: pre-existing "
                   "findings tracked but not blocking. Regenerate with "
                   "`python tools/repro_lint_torch.py --fix-baseline`.",
        "findings": [{"rule": r, "path": p, "key": k}
                     for (r, p, k) in entries],
    }
    return json.dumps(payload, indent=2, sort_keys=True) + "\n"


def mark_baselined(findings: Sequence[Finding],
                   baseline: Set[Tuple[str, str, str]]) -> List[Finding]:
    """Mark findings present in the baseline; return the NEW ones."""
    new = []
    for f in findings:
        f.baselined = baseline_key(f) in baseline
        if not f.baselined:
            new.append(f)
    return new
