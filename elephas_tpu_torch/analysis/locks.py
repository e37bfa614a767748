"""Concurrency analyzers: the package-wide lock-acquisition graph
(counterpart of ``elephas_tpu/analysis/locks.py``).

Two rules share one extraction pass:

**lock-order** — every ``with <lock>:`` / ``.acquire()`` site in the
package is extracted and named by its defining ``(module, class, attr)``
(aliases through ``self._lock``-style fields, module-level locks, and
function locals all resolve to one identity per lock object class).
Nested acquisitions — lexical, AND through method calls resolved across
modules — become directed edges ``A -> B`` ("A is held while B is
acquired"). A cycle in that graph is deadlock potential: two threads
entering the cycle from different nodes can block each other forever.
The rule fails on every cycle with the full witness path (file:line of
each acquisition / call hop). A ``# lock-ok`` pragma on the inner
acquisition or call line excludes that edge (recorded as a suppression,
so the dead-pragma rule audits it).

**lock-blocking** — blocking operations executed while a lock is held:
socket sends/recvs, ``fsync``/``flush``, ``time.sleep``, wire
encode/decode, HTTP request/dispatch, thread joins, and ``.wait()`` on
a foreign condition. Holding a registry/buffer lock across I/O turns
every reader into a convoy and every flaky peer into a server stall.
The vocabulary is the reference's and holds no CUDA call: a device→host
sync is the ``host-sync`` rule's business. Direct hits are flagged at
the blocking line; a call made under a lock to a method whose body
blocks (one level, pragma-free sites only) is flagged at the call site
with the chain. Escape: ``# lock-ok`` with a reason.

Resolution is deliberately conservative — an unresolvable callee adds
no edge (a missed edge is a missed warning; an invented edge is a false
deadlock). Method calls resolve through ``self``, through attribute
types inferred from ``self.x = ClassName(...)`` constructor
assignments, and through a global method-name match only when exactly
one class in the package defines that name.

The same extraction also cross-checks the RUNTIME sanitizer's naming:
a ``make_lock("…")``/``make_condition("…")`` literal that doesn't match
the statically derived identity of the field it's assigned to is a
violation — the static graph and the sanitizer must speak one language.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from elephas_tpu_torch.analysis.core import (PACKAGE, Finding, Repo, Rule,
                                             SourceFile)

LOCK_PRAGMA = "lock-ok"

# threading.<factory>() and the sanitizer's wrappers.
_THREADING_FACTORIES = {"Lock": "lock", "RLock": "rlock",
                        "Condition": "condition"}
_SANITIZER_FACTORIES = {"make_lock": "lock", "make_rlock": "rlock",
                        "make_condition": "condition"}
_LOCK_CLASS_CTORS = {"RWLock": "rwlock"}
_NULL_LOCK_CTORS = {"NullLock"}

_ACQUIRE_METHODS = {"acquire", "acquire_read", "acquire_write"}
_CTX_ACQUIRE_METHODS = {"reading", "writing"}
_LOCK_NOISE_METHODS = {"release", "locked", "notify", "notify_all",
                       "notify_one"}

# -- blocking-operation matchers --------------------------------------------

# attr-call names flagged on ANY receiver.
_BLOCK_ANY_RECV = {
    "sendall": "socket send", "sendto": "socket send",
    "recv": "socket recv", "recv_into": "socket recv",
    "recvfrom": "socket recv", "accept": "socket accept",
    "connect": "socket connect", "connect_ex": "socket connect",
    "fsync": "fsync", "fdatasync": "fsync",
    "flush": "flush",
    "urlopen": "http request", "getresponse": "http response",
    "serve_forever": "http dispatch", "handle_request": "http dispatch",
    "receive": "socket recv",
}
# attr-call names flagged only for specific receiver module names.
_BLOCK_MODULE_RECV = {
    ("time", "sleep"): "sleep",
    ("os", "fsync"): "fsync",
    ("os", "fdatasync"): "fsync",
    ("select", "select"): "select",
    ("subprocess", "run"): "subprocess",
    ("subprocess", "check_call"): "subprocess",
    ("subprocess", "check_output"): "subprocess",
}
# wire codec entry points (attr or imported bare call).
_WIRE_NAMES = {"encode_tree", "decode_tree", "decode_payload",
               "decode_payload_traced", "encode_pickle", "decode_pickle"}
# bare names that count when they were imported from somewhere.
_BLOCK_BARE_IMPORTED = {
    "send": "socket send", "recv": "socket recv", "receive": "socket recv",
    "urlopen": "http request", "sleep": "sleep", "fsync": "fsync",
}
_BLOCK_BARE_IMPORTED.update({n: "wire codec" for n in _WIRE_NAMES})
# .send( on any receiver is too noisy only for generators; in this
# package every .send is a socket or a socket-module helper.
_THREADY = ("thread", "proc", "worker", "streamer", "monitor")

# Method names owned by builtin collections/strings/files: never
# resolved through the unique-method-name fallback (typed attribute
# resolution may still reach a repo class method of the same name).
_BUILTIN_METHOD_NAMES = {
    "append", "appendleft", "add", "clear", "copy", "count", "discard",
    "extend", "get", "index", "insert", "items", "keys", "values",
    "pop", "popleft", "popitem", "put", "remove", "reverse", "sort",
    "setdefault", "update", "join", "split", "strip", "startswith",
    "endswith", "format", "encode", "decode", "read", "readline",
    "write", "writelines", "open", "close", "seek", "tell", "submit",
    "result", "cancel", "done", "get_nowait", "put_nowait", "qsize",
    "empty", "full", "isoformat", "lower", "upper", "replace",
}


def _expr_name(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


@dataclass
class LockDef:
    key: str               # canonical identity, e.g. "ParameterBuffer._lock"
    kind: str              # lock | rlock | condition | rwlock
    path: str
    lineno: int
    declared_name: Optional[str] = None   # make_lock("…") literal, if any


@dataclass
class AcqEvent:
    lock: str              # lock key (possibly unresolved "~Class.attr")
    lineno: int
    held: Tuple[str, ...]
    pragma: bool
    via: str               # "with" | "acquire" | "ctx"


@dataclass
class CallEvent:
    callee: Tuple          # ("self", m) | ("selfattr", a, m) |
                           # ("name", f) | ("attr", base, m)
    lineno: int
    held: Tuple[str, ...]
    pragma: bool


@dataclass
class BlockEvent:
    desc: str
    ident: str
    lineno: int
    held: Tuple[str, ...]
    pragma: bool
    receiver_lock: Optional[str] = None   # for .wait() on a known lock


@dataclass
class FuncInfo:
    module: str
    cls: Optional[str]
    name: str
    qual: str
    path: str
    acqs: List[AcqEvent] = field(default_factory=list)
    calls: List[CallEvent] = field(default_factory=list)
    blocks: List[BlockEvent] = field(default_factory=list)


@dataclass
class ClassInfo:
    name: str
    module: str
    path: str
    bases: List[str] = field(default_factory=list)
    lock_fields: Dict[str, LockDef] = field(default_factory=dict)
    attr_types: Dict[str, str] = field(default_factory=dict)
    methods: Dict[str, FuncInfo] = field(default_factory=dict)


def _module_short(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    if parts and parts[0] == PACKAGE:
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else Path(rel).stem


def _lock_ctor_kind(expr: ast.expr) -> Optional[Tuple[str, Optional[str]]]:
    """``(kind, declared_name)`` if the expression constructs a lock.

    Handles ``threading.Lock()``, ``RWLock(...)``, the sanitizer's
    ``make_lock("…")`` factories, ``Condition(Lock())``, and either
    branch of an ``A() if c else B()`` conditional (the buffer's
    ``RWLock() if lock else NullLock()`` idiom).
    """
    if isinstance(expr, ast.IfExp):
        return _lock_ctor_kind(expr.body) or _lock_ctor_kind(expr.orelse)
    if not isinstance(expr, ast.Call):
        return None
    fn = expr.func
    name = None
    if isinstance(fn, ast.Attribute):
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    if name in _THREADING_FACTORIES:
        # only threading.X / X — any receiver accepted (locksan alias)
        return _THREADING_FACTORIES[name], None
    if name in _LOCK_CLASS_CTORS:
        declared = None
        for kw in expr.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                declared = kw.value.value
        return _LOCK_CLASS_CTORS[name], declared
    if name in _SANITIZER_FACTORIES:
        declared = None
        if expr.args and isinstance(expr.args[0], ast.Constant) \
                and isinstance(expr.args[0].value, str):
            declared = expr.args[0].value
        return _SANITIZER_FACTORIES[name], declared
    return None


class _FileExtractor:
    """One pass over a module: lock definitions, attr types, and every
    function's acquisition/call/blocking events with lexical held
    stacks."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.module = _module_short(sf.rel)
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: List[FuncInfo] = []      # module-level + nested
        self.module_locks: Dict[str, LockDef] = {}
        self.imported_from: Dict[str, str] = {}  # name -> module
        self._extract()

    # -- helpers -------------------------------------------------------------

    def _pragma(self, lineno: int) -> bool:
        return LOCK_PRAGMA in self.sf.line(lineno)

    def _extract(self):
        tree = self.sf.tree
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._record_import(node)
        # collect classes + their fields first (methods may `with` a
        # field assigned later in __init__)
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self._collect_class(node)
            elif isinstance(node, ast.Assign):
                self._collect_module_lock(node)
        # then walk bodies for events
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                ci = self.classes[node.name]
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        fi = self._walk_function(item, ci, item.name)
                        ci.methods[item.name] = fi
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.append(
                    self._walk_function(node, None, node.name))

    def _record_import(self, node):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                self.imported_from[alias.asname or alias.name] = node.module
        elif isinstance(node, ast.Import):
            for alias in node.names:
                short = (alias.asname or alias.name).split(".")[0]
                self.imported_from[short] = alias.name

    def _collect_module_lock(self, node: ast.Assign):
        ctor = _lock_ctor_kind(node.value)
        if ctor is None:
            return
        kind, declared = ctor
        for t in node.targets:
            if isinstance(t, ast.Name):
                key = f"{self.module}.{t.id}"
                self.module_locks[t.id] = LockDef(
                    key, kind, self.sf.rel, node.lineno, declared)

    def _collect_class(self, node: ast.ClassDef):
        ci = ClassInfo(name=node.name, module=self.module, path=self.sf.rel,
                       bases=[b.id for b in node.bases
                              if isinstance(b, ast.Name)])
        self.classes[node.name] = ci
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Assign):
                continue
            for t in sub.targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                ctor = _lock_ctor_kind(sub.value)
                if ctor is not None:
                    kind, declared = ctor
                    key = f"{node.name}.{t.attr}"
                    ci.lock_fields[t.attr] = LockDef(
                        key, kind, self.sf.rel, sub.lineno, declared)
                    continue
                # plain constructor assignment -> attribute type
                v = sub.value
                if isinstance(v, ast.Call):
                    fn = v.func
                    ctor_name = None
                    if isinstance(fn, ast.Name):
                        ctor_name = fn.id
                    elif isinstance(fn, ast.Attribute):
                        ctor_name = fn.attr
                    if ctor_name and ctor_name[:1].isupper() \
                            and ctor_name not in _NULL_LOCK_CTORS:
                        ci.attr_types.setdefault(t.attr, ctor_name)

    # -- function walking ----------------------------------------------------

    def _walk_function(self, node, ci: Optional[ClassInfo],
                       qual: str) -> FuncInfo:
        fi = FuncInfo(module=self.module, cls=ci.name if ci else None,
                      name=node.name, qual=qual, path=self.sf.rel)
        local_locks: Dict[str, LockDef] = {}
        self._walk_stmts(node.body, (), fi, ci, local_locks, qual)
        return fi

    def _resolve_lock_expr(self, expr: ast.expr, ci: Optional[ClassInfo],
                           local_locks: Dict[str, LockDef]) -> Optional[str]:
        """Lock key for an expression naming a lock, else None."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            if ci is not None:
                ld = ci.lock_fields.get(expr.attr)
                if ld is not None:
                    return ld.key
                # unresolved self attr that LOOKS like a lock usage gets
                # a per-class placeholder (resolved against bases later)
                return f"~{ci.name}.{expr.attr}"
            return None
        if isinstance(expr, ast.Name):
            if expr.id in local_locks:
                return local_locks[expr.id].key
            if expr.id in self.module_locks:
                return self.module_locks[expr.id].key
        return None

    def _classify_withitem(self, item: ast.withitem, ci, local_locks
                           ) -> Optional[Tuple[str, str]]:
        """``(lock_key, via)`` if the context expr acquires a lock."""
        expr = item.context_expr
        # with self._lock: / with cond: / with local_lock:
        key = self._resolve_lock_expr(expr, ci, local_locks)
        if key is not None and not key.startswith("~"):
            return key, "with"
        # with self._lock.reading() / .writing():
        if isinstance(expr, ast.Call) and isinstance(expr.func,
                                                     ast.Attribute):
            if expr.func.attr in _CTX_ACQUIRE_METHODS | _ACQUIRE_METHODS:
                inner = self._resolve_lock_expr(expr.func.value, ci,
                                                local_locks)
                if inner is not None and not inner.startswith("~"):
                    return inner, "ctx"
        return None

    def _walk_stmts(self, stmts, held: Tuple[str, ...], fi: FuncInfo,
                    ci, local_locks, qual: str):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested function: its body runs later (thread targets,
                # callbacks) — own FuncInfo, empty held stack.
                nested = self._walk_function(st, ci, f"{qual}.{st.name}")
                self.functions.append(nested)
                continue
            if isinstance(st, ast.ClassDef):
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in st.items:
                    got = self._classify_withitem(item, ci, local_locks)
                    # the context expression itself may contain calls
                    self._scan_expr(item.context_expr, new_held, fi, ci,
                                    local_locks, skip_lock_call=got
                                    is not None)
                    if got is not None:
                        lock, via = got
                        fi.acqs.append(AcqEvent(
                            lock, st.lineno, new_held,
                            self._pragma(st.lineno), via))
                        new_held = new_held + (lock,)
                self._walk_stmts(st.body, new_held, fi, ci, local_locks,
                                 qual)
                continue
            # local lock construction
            if isinstance(st, ast.Assign):
                ctor = _lock_ctor_kind(st.value)
                if ctor is not None:
                    kind, declared = ctor
                    for t in st.targets:
                        if isinstance(t, ast.Name):
                            key = f"{self.module}.{qual}.{t.id}"
                            local_locks[t.id] = LockDef(
                                key, kind, self.sf.rel, st.lineno, declared)
            # expressions of this statement
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.stmt):
                    continue
                if isinstance(child, ast.ExceptHandler):
                    continue
                self._scan_expr(child, held, fi, ci, local_locks)
            # nested statement lists (if/for/while/try bodies)
            for fname in ("body", "orelse", "finalbody"):
                sub = getattr(st, fname, None)
                if isinstance(sub, list) and sub \
                        and isinstance(sub[0], ast.stmt):
                    self._walk_stmts(sub, held, fi, ci, local_locks, qual)
            for handler in getattr(st, "handlers", []):
                self._walk_stmts(handler.body, held, fi, ci, local_locks,
                                 qual)

    def _scan_expr(self, expr, held, fi, ci, local_locks,
                   skip_lock_call: bool = False):
        for node in ast.walk(expr):
            if isinstance(node, ast.Lambda):
                continue
            if not isinstance(node, ast.Call):
                continue
            self._classify_call(node, held, fi, ci, local_locks,
                                skip_lock_call=skip_lock_call
                                and node is expr)

    def _classify_call(self, node: ast.Call, held, fi: FuncInfo, ci,
                       local_locks, skip_lock_call: bool = False):
        fn = node.func
        pragma = self._pragma(node.lineno)
        # lock-method calls
        if isinstance(fn, ast.Attribute):
            recv_lock = self._resolve_lock_expr(fn.value, ci, local_locks)
            if recv_lock is not None and not recv_lock.startswith("~"):
                if fn.attr in _ACQUIRE_METHODS and not skip_lock_call:
                    # raw .acquire(): an ordering event; a NONBLOCKING
                    # try-acquire (blocking=False / 0) is deadlock-free
                    # by construction and adds no edge.
                    nonblocking = any(
                        isinstance(a, ast.Constant)
                        and a.value in (False, 0)
                        for a in node.args) or any(
                        kw.arg == "blocking"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value in (False, 0)
                        for kw in node.keywords)
                    if not nonblocking:
                        fi.acqs.append(AcqEvent(
                            recv_lock, node.lineno, held, pragma,
                            "acquire"))
                    return
                if fn.attr == "wait":
                    others = tuple(h for h in held if h != recv_lock)
                    if others:
                        fi.blocks.append(BlockEvent(
                            "condition wait while holding another lock",
                            f".wait() on {recv_lock}", node.lineno,
                            others, pragma, receiver_lock=recv_lock))
                    return
                if fn.attr in _LOCK_NOISE_METHODS \
                        or fn.attr in _CTX_ACQUIRE_METHODS:
                    return
            # blocking matchers ------------------------------------------
            base = _expr_name(fn.value) if isinstance(
                fn.value, (ast.Name, ast.Attribute)) else None
            # Blocking events are recorded even with an EMPTY held
            # stack: the direct rule only flags held ones, but a caller
            # holding a lock inherits the callee's blocking body
            # through the one-level interprocedural pass.
            if isinstance(fn.value, ast.Name) \
                    and (fn.value.id, fn.attr) in _BLOCK_MODULE_RECV:
                fi.blocks.append(BlockEvent(
                    _BLOCK_MODULE_RECV[(fn.value.id, fn.attr)],
                    f"{fn.value.id}.{fn.attr}", node.lineno, held,
                    pragma))
                return
            if fn.attr in _WIRE_NAMES:
                fi.blocks.append(BlockEvent(
                    "wire codec", f".{fn.attr}", node.lineno, held,
                    pragma))
                return
            if fn.attr in _BLOCK_ANY_RECV:
                fi.blocks.append(BlockEvent(
                    _BLOCK_ANY_RECV[fn.attr], f".{fn.attr}",
                    node.lineno, held, pragma))
                return
            if fn.attr == "send":
                fi.blocks.append(BlockEvent(
                    "socket send", ".send", node.lineno, held, pragma))
                return
            if fn.attr == "wait" and held:
                # wait() on a non-lock receiver (Event, Thread queue…)
                fi.blocks.append(BlockEvent(
                    "wait while holding a lock", ".wait", node.lineno,
                    held, pragma))
                return
            if fn.attr == "join" and held:
                rname = (_expr_name(fn.value) or "").lower()
                if any(t in rname for t in _THREADY):
                    fi.blocks.append(BlockEvent(
                        "thread join", f".{rname}.join", node.lineno,
                        held, pragma))
                    return
            # ordinary attribute call -> call event
            if isinstance(fn.value, ast.Attribute) \
                    and isinstance(fn.value.value, ast.Name) \
                    and fn.value.value.id == "self":
                fi.calls.append(CallEvent(
                    ("selfattr", fn.value.attr, fn.attr), node.lineno,
                    held, pragma))
            elif isinstance(fn.value, ast.Name) and fn.value.id == "self":
                fi.calls.append(CallEvent(
                    ("self", fn.attr), node.lineno, held, pragma))
            elif isinstance(fn.value, ast.Name):
                fi.calls.append(CallEvent(
                    ("attr", fn.value.id, fn.attr), node.lineno, held,
                    pragma))
            return
        if isinstance(fn, ast.Name):
            name = fn.id
            if name in _BLOCK_BARE_IMPORTED and name in self.imported_from:
                fi.blocks.append(BlockEvent(
                    _BLOCK_BARE_IMPORTED[name], name, node.lineno,
                    held, pragma))
                return
            fi.calls.append(CallEvent(("name", name), node.lineno, held,
                                      pragma))


# -- global analysis ---------------------------------------------------------


@dataclass
class LockEdge:
    src: str
    dst: str
    chain: Tuple[str, ...]
    lineno: int
    path: str
    pragma: bool


class LockAnalysis:
    """Whole-package extraction + graph. Built once, consumed by both
    lock rules and exported into ANALYSIS_TORCH.json for the runtime
    sanitizer."""

    def __init__(self, repo: Repo, files: Sequence[SourceFile]):
        self.repo = repo
        self.extractors = [_FileExtractor(sf) for sf in files]
        self.classes: Dict[str, List[ClassInfo]] = {}
        self.lock_defs: Dict[str, LockDef] = {}
        self.methods_by_name: Dict[str, List[Tuple[ClassInfo, FuncInfo]]] = {}
        self.module_funcs: Dict[str, List[FuncInfo]] = {}
        self.all_funcs: List[FuncInfo] = []
        for ex in self.extractors:
            for ci in ex.classes.values():
                self.classes.setdefault(ci.name, []).append(ci)
                for ld in ci.lock_fields.values():
                    self.lock_defs[ld.key] = ld
                for m, fi in ci.methods.items():
                    self.methods_by_name.setdefault(m, []).append((ci, fi))
                    self.all_funcs.append(fi)
            for ld in ex.module_locks.values():
                self.lock_defs[ld.key] = ld
            for fi in ex.functions:
                self.module_funcs.setdefault(fi.name, []).append(fi)
                self.all_funcs.append(fi)
            # locals registered during walks
        self._edges: Optional[List[LockEdge]] = None
        self._suppressed_edges: List[LockEdge] = []
        self._eff_locks: Dict[int, Dict[str, Tuple[str, ...]]] = {}

    # -- callee resolution ---------------------------------------------------

    def _class_of(self, name: str) -> Optional[ClassInfo]:
        cands = self.classes.get(name, [])
        return cands[0] if len(cands) == 1 else None

    def _method_on(self, ci: ClassInfo, m: str) -> Optional[FuncInfo]:
        seen = set()
        while ci is not None and ci.name not in seen:
            seen.add(ci.name)
            if m in ci.methods:
                return ci.methods[m]
            nxt = None
            for b in ci.bases:
                bc = self._class_of(b)
                if bc is not None:
                    nxt = bc
                    break
            ci = nxt
        return None

    def resolve_call(self, caller: FuncInfo, ev: CallEvent
                     ) -> Optional[FuncInfo]:
        kind = ev.callee[0]
        if kind == "self" and caller.cls:
            ci = self._class_of(caller.cls)
            if ci is not None:
                return self._method_on(ci, ev.callee[1])
            return None
        if kind == "selfattr" and caller.cls:
            attr, m = ev.callee[1], ev.callee[2]
            ci = self._class_of(caller.cls)
            if ci is not None:
                if attr in ci.lock_fields:
                    return None            # lock methods handled upstream
                tname = ci.attr_types.get(attr)
                if tname:
                    tc = self._class_of(tname)
                    if tc is not None:
                        return self._method_on(tc, m)
            return self._unique_method(m)
        if kind == "name":
            f = ev.callee[1]
            funcs = self.module_funcs.get(f, [])
            local = [fi for fi in funcs if fi.module == caller.module]
            if len(local) == 1:
                return local[0]
            if len(funcs) == 1:
                return funcs[0]
            return None
        if kind == "attr":
            base, m = ev.callee[1], ev.callee[2]
            funcs = self.module_funcs.get(m, [])
            based = [fi for fi in funcs
                     if fi.module == base or fi.module.endswith(f".{base}")]
            if len(based) == 1:
                return based[0]
            return self._unique_method(m)
        return None

    def _unique_method(self, m: str) -> Optional[FuncInfo]:
        """Global fallback: a method name defined by exactly ONE class
        package-wide resolves; anything ambiguous adds no edge. Names
        shared with builtin collections/files are excluded outright —
        ``self._events.append(...)`` is a list append, not a call into
        whatever repo class happens to define ``append``."""
        if m in _BUILTIN_METHOD_NAMES:
            return None
        cands = self.methods_by_name.get(m, [])
        if len(cands) == 1:
            return cands[0][1]
        return None

    # -- effective (transitive) lock acquisitions ---------------------------

    def eff_locks(self, fi: FuncInfo, _depth: int = 0,
                  _stack: Optional[Set[int]] = None
                  ) -> Dict[str, Tuple[str, ...]]:
        """``{lock_key: witness chain}`` of every lock this function may
        acquire, transitively through resolvable calls (depth-capped)."""
        key = id(fi)
        if key in self._eff_locks:
            return self._eff_locks[key]
        if _stack is None:
            _stack = set()
        if key in _stack or _depth > 6:
            return {}
        _stack.add(key)
        out: Dict[str, Tuple[str, ...]] = {}
        where = f"{fi.path}:{{ln}} {fi.cls + '.' if fi.cls else ''}{fi.qual}"
        for acq in fi.acqs:
            if acq.pragma:
                continue
            out.setdefault(
                acq.lock,
                (where.format(ln=acq.lineno) + f": acquires {acq.lock}",))
        for ev in fi.calls:
            if ev.pragma:
                continue
            callee = self.resolve_call(fi, ev)
            if callee is None or callee is fi:
                continue
            sub = self.eff_locks(callee, _depth + 1, _stack)
            step = (where.format(ln=ev.lineno)
                    + f": calls {callee.cls + '.' if callee.cls else ''}"
                      f"{callee.name}")
            for lock, chain in sub.items():
                if lock not in out and len(chain) < 6:
                    out[lock] = (step,) + chain
        _stack.discard(key)
        self._eff_locks[key] = out
        return out

    def direct_blocking(self, fi: FuncInfo) -> List[BlockEvent]:
        """Pragma-free blocking ops anywhere in the function body —
        what a caller holding a lock inherits (one level)."""
        return [b for b in fi.blocks if not b.pragma]

    # -- the graph -----------------------------------------------------------

    def edges(self) -> List[LockEdge]:
        if self._edges is not None:
            return self._edges
        found: Dict[Tuple[str, str], LockEdge] = {}
        suppressed: List[LockEdge] = []

        def add(src, dst, chain, lineno, path, pragma):
            e = LockEdge(src, dst, tuple(chain), lineno, path, pragma)
            if pragma:
                suppressed.append(e)
                return
            found.setdefault((src, dst), e)

        for fi in self.all_funcs:
            where = (f"{fi.path}:{{ln}} "
                     f"{fi.cls + '.' if fi.cls else ''}{fi.qual}")
            for acq in fi.acqs:
                for h in acq.held:
                    add(h, acq.lock,
                        [where.format(ln=acq.lineno)
                         + f": acquires {acq.lock} while holding {h}"],
                        acq.lineno, fi.path, acq.pragma)
            for ev in fi.calls:
                if not ev.held:
                    continue
                callee = self.resolve_call(fi, ev)
                if callee is None or callee is fi:
                    continue
                step = (where.format(ln=ev.lineno)
                        + f": calls {callee.cls + '.' if callee.cls else ''}"
                          f"{callee.name} while holding "
                        + ",".join(ev.held))
                for lock, chain in self.eff_locks(callee).items():
                    for h in ev.held:
                        add(h, lock, (step,) + chain, ev.lineno, fi.path,
                            ev.pragma)
        self._edges = sorted(found.values(), key=lambda e: (e.src, e.dst))
        self._suppressed_edges = suppressed
        return self._edges

    def suppressed_edges(self) -> List[LockEdge]:
        self.edges()
        return self._suppressed_edges

    def cycles(self) -> List[List[LockEdge]]:
        """Every elementary cycle reachable in the edge graph, as edge
        lists (self-edges included — a non-reentrant lock re-acquired
        through a call chain deadlocks on its own)."""
        edges = self.edges()
        adj: Dict[str, List[LockEdge]] = {}
        for e in edges:
            adj.setdefault(e.src, []).append(e)
        out: List[List[LockEdge]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()

        for start in sorted(adj):
            # bounded DFS for cycles through `start`
            stack: List[Tuple[str, List[LockEdge]]] = [(start, [])]
            while stack:
                node, path = stack.pop()
                if len(path) > 8:
                    continue
                for e in adj.get(node, []):
                    if e.dst == start:
                        cyc = path + [e]
                        names = tuple(sorted(x.src for x in cyc))
                        if names not in seen_cycles:
                            seen_cycles.add(names)
                            out.append(cyc)
                    elif all(e.dst != p.src for p in path) \
                            and e.dst > start:
                        stack.append((e.dst, path + [e]))
        return out

    # -- export --------------------------------------------------------------

    def export(self) -> dict:
        edges = self.edges()
        return {
            "locks": [
                {"key": ld.key, "kind": ld.kind, "path": ld.path,
                 "lineno": ld.lineno}
                for ld in sorted(self.lock_defs.values(),
                                 key=lambda d: d.key)
            ],
            "edges": [
                {"src": e.src, "dst": e.dst, "path": e.path,
                 "lineno": e.lineno, "chain": list(e.chain)}
                for e in edges
            ],
        }


class LockOrderRule(Rule):
    name = "lock-order"
    pragma = LOCK_PRAGMA
    describe = ("package: the cross-module lock-acquisition graph must be "
                "acyclic (deadlock potential)")

    def __init__(self, analysis_for=None):
        self._analysis_for = analysis_for or get_analysis

    def scope(self, repo: Repo):
        return repo.package_files()

    def run(self, repo: Repo) -> List[Finding]:
        la = self._analysis_for(repo)
        out: List[Finding] = []
        for cyc in la.cycles():
            locks = [e.src for e in cyc]
            chain: List[str] = []
            for e in cyc:
                chain.extend(e.chain)
            first = cyc[0]
            if len(cyc) == 1 and first.src == first.dst:
                msg = (f"lock `{first.src}` re-acquired while already "
                       f"held (self-deadlock for a non-reentrant lock)")
            else:
                msg = ("lock-order cycle "
                       + " -> ".join(locks + [locks[0]])
                       + " (two threads entering from different nodes "
                         "deadlock)")
            out.append(Finding(
                rule=self.name, path=first.path, lineno=first.lineno,
                ident=" -> ".join(locks), line="", message=msg,
                chain=tuple(chain)))
        # make_lock("…") literals must match the derived identity
        for ld in la.lock_defs.values():
            if ld.declared_name is not None and ld.declared_name != ld.key:
                sf = repo.file(repo.root / ld.path)
                out.append(Finding(
                    rule=self.name, path=ld.path, lineno=ld.lineno,
                    ident=ld.key, line=sf.line(ld.lineno),
                    message=(f"sanitizer lock name {ld.declared_name!r} "
                             f"does not match the derived identity "
                             f"{ld.key!r} — the runtime sanitizer and "
                             f"the static graph must agree"),
                    suppressed=LOCK_PRAGMA in sf.line(ld.lineno)))
        # pragma'd edges are suppressions (dead-pragma audits them)
        for e in la.suppressed_edges():
            sf = repo.file(repo.root / e.path)
            out.append(Finding(
                rule=self.name, path=e.path, lineno=e.lineno,
                ident=f"{e.src}->{e.dst}", line=sf.line(e.lineno),
                message=f"edge {e.src} -> {e.dst} excluded by pragma",
                suppressed=True, chain=e.chain))
        return out


class BlockingUnderLockRule(Rule):
    name = "lock-blocking"
    pragma = LOCK_PRAGMA
    describe = ("package: no socket/fsync/flush/sleep/wire-codec/dispatch "
                "call while a lock is held")

    def __init__(self, analysis_for=None):
        self._analysis_for = analysis_for or get_analysis

    def scope(self, repo: Repo):
        return repo.package_files()

    def run(self, repo: Repo) -> List[Finding]:
        la = self._analysis_for(repo)
        out: List[Finding] = []
        for fi in la.all_funcs:
            for b in fi.blocks:
                if not b.held:
                    # a pragma here still does work: it stops the
                    # blocking body from propagating to callers that DO
                    # hold locks — record it so dead-pragma sees it live
                    if b.pragma:
                        sf = repo.file(repo.root / fi.path)
                        out.append(Finding(
                            rule=self.name, path=fi.path, lineno=b.lineno,
                            ident=b.ident, line=sf.line(b.lineno),
                            message=(f"{b.desc} (`{b.ident}`) sanctioned "
                                     f"— callers may hold locks across "
                                     f"this site"),
                            suppressed=True))
                    continue
                sf = repo.file(repo.root / fi.path)
                out.append(Finding(
                    rule=self.name, path=fi.path, lineno=b.lineno,
                    ident=b.ident, line=sf.line(b.lineno),
                    message=(f"{b.desc} (`{b.ident}`) while holding "
                             + ", ".join(b.held)
                             + " — blocking under a lock convoys every "
                               "contender"),
                    suppressed=b.pragma))
            # one-level interprocedural: call under lock -> callee blocks
            for ev in fi.calls:
                if not ev.held:
                    continue
                callee = la.resolve_call(fi, ev)
                if callee is None or callee is fi:
                    continue
                direct = la.direct_blocking(callee)
                if not direct:
                    continue
                b = direct[0]
                sf = repo.file(repo.root / fi.path)
                cname = (callee.cls + "." if callee.cls else "") + callee.name
                out.append(Finding(
                    rule=self.name, path=fi.path, lineno=ev.lineno,
                    ident=f"{cname}->{b.ident}", line=sf.line(ev.lineno),
                    message=(f"call to {cname} while holding "
                             + ", ".join(ev.held)
                             + f" reaches a blocking {b.desc} "
                               f"(`{b.ident}` at {callee.path}:{b.lineno})"),
                    suppressed=ev.pragma,
                    chain=(f"{callee.path}:{b.lineno}: {b.desc} "
                           f"`{b.ident}` in {cname}",)))
        return out


# -- per-repo analysis cache -------------------------------------------------

_CACHE: Dict[Path, LockAnalysis] = {}


def get_analysis(repo: Repo) -> LockAnalysis:
    la = _CACHE.get(repo.root)
    if la is None or la.repo is not repo:
        la = LockAnalysis(repo, repo.package_files())
        _CACHE[repo.root] = la
    return la
