"""Pass 3 — thread-safety audit.

The farm spans five concurrency domains (staging threads, per-encoder
pack/fetch pools, spawn-context pack sidecars, per-shard worker
daemons, and the lease/packager/HTTP machinery); this pass inventories
the thread entrypoints and flags the shared mutable state they can
race on:

TVT-T001  an instance attribute written WITHOUT a lock from code
          reachable by two distinct thread entrypoints of its class,
          or by one entrypoint that runs concurrently with itself
          (pool-submitted work).
TVT-T002  a blocking call (sleep, subprocess, urlopen, ...) made while
          a lock is held — lock convoys on the claim/heartbeat paths.
TVT-T003  inconsistent lock acquisition order (a cycle in the
          "holding A, acquire B" graph) WITHIN one class. Locks are
          keyed per (module, class); nesting propagates one level
          through same-class ``self.X()`` calls.
TVT-T004  guarded-by violations, two tiers: (a) inferred — a field
          written under two DIFFERENT locks from multi-threaded code
          (empty lockset intersection: each writer believes a
          different lock protects the field, so no lock does); (b)
          declared — the manifest's `guarded_by` names the lock that
          protects a field, and EVERY read/write site outside
          ``__init__`` must hold it (lexically, or via the *_locked
          caller-holds convention).
TVT-T005  CROSS-object lock-order cycles: alias-aware one-level call
          propagation — ``self.board.claim()`` under a held lock
          contributes an edge from the holder's lock to every lock
          `claim` acquires, with `self.board`'s class resolved from
          ``__init__`` construction sites and parameter annotations
          (the alias map makes the one-level case visible).

Entrypoint discovery is AST-based: ``threading.Thread(target=f)``
targets, ``pool.submit(f, ...)`` callables (concurrent — many
instances may run at once), plus the manifest's declared entrypoints
for what the AST cannot see (generators handed to a staging thread).
All public methods of a class form ONE additional "api" entrypoint —
external callers are assumed single-threaded unless the manifest says
otherwise, which keeps the pass quiet on driver-style classes.

Honest limits, by design: reads are not flagged (a torn read is real
but drowning the report in read findings would get the pass deleted);
attributes of per-request HTTP handler classes are instance-local and
skipped; lock detection is lexical (``with self._lock:`` blocks and
the ``*_locked`` caller-holds-the-lock naming convention).
"""

from __future__ import annotations

import ast
import dataclasses
import re

from .astutil import (Finding, SourceTree, dotted_name, finding,
                      terminal_name)
from .manifest import Manifest


# ---------------------------------------------------------------------------
# entrypoint discovery
# ---------------------------------------------------------------------------


def _walk_with_class(tree: ast.Module):
    """(enclosing class name | None, node) for every node — nested
    functions keep their class context (a closure handed to a thread
    still runs against that class's `self`)."""

    def rec(node, cls):
        for child in ast.iter_child_nodes(node):
            child_cls = child.name if isinstance(child, ast.ClassDef) \
                else cls
            yield child_cls, child
            yield from rec(child, child_cls)

    yield from rec(tree, None)


def discover_entry_names(tree: SourceTree
                         ) -> tuple[dict[tuple[str, str, str], str],
                                    dict[str, str]]:
    """Thread-target discovery → (qualified, bare) maps to kind
    ("thread" for Thread targets, "concurrent" for executor
    submissions). A ``self.X`` target is QUALIFIED to its lexically
    enclosing (module, class) so `Thread(target=self.run)` in one
    class doesn't brand every `run` method in the package an
    entrypoint (false TVT-T001s on single-threaded classes); targets
    on other receivers fall back to the bare-name map."""
    qualified: dict[tuple[str, str, str], str] = {}
    bare: dict[str, str] = {}

    def record(expr: ast.AST, kind: str, mod: str,
               cls: str | None) -> None:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and cls:
            key = (mod, cls, expr.attr)
            if qualified.get(key) != "concurrent":
                qualified[key] = kind
            return
        name = terminal_name(expr)
        if name and bare.get(name) != "concurrent":
            bare[name] = kind

    for mod in tree.modules():
        for cls, node in _walk_with_class(tree.tree(mod)):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func) or ""
            if callee.split(".")[-1] == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        record(kw.value, "thread", mod, cls)
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "submit" and node.args:
                record(node.args[0], "concurrent", mod, cls)
    return qualified, bare


# ---------------------------------------------------------------------------
# per-class model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Write:
    attr: str
    method: str
    line: int
    locked: bool
    #: lexically-held lock attrs at the write ((-assumed-) marks the
    #: *_locked caller-holds convention)
    lockset: tuple[str, ...] = ()


@dataclasses.dataclass
class _MethodInfo:
    name: str
    calls: set[str]                  # self.X() targets
    writes: list[_Write]
    #: self.X() calls made while a lock is held: (target, line,
    #: locks held AT the call site)
    locked_calls: list[tuple[str, int, tuple[str, ...]]]
    #: blocking calls anywhere in the body: (display name, line)
    blocking_sites: list[tuple[str, int]]
    #: blocking calls made while a lock is held: (display name, line)
    locked_blocking: list[tuple[str, int]]
    #: lock attrs acquired, with the locks held at acquisition time:
    #: (attr, held-before tuple, line)
    acquisitions: list[tuple[str, tuple[str, ...], int]]
    #: attribute READS of self: (attr, line, lockset, assumed)
    reads: list[tuple[str, int, tuple[str, ...], bool]] = \
        dataclasses.field(default_factory=list)
    #: calls THROUGH an attribute chain: (chain attrs incl. final
    #: method, line, held locks at the call)
    alias_calls: list[tuple[tuple[str, ...], int, tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    #: caller-holds-the-lock convention (*_locked name)
    assumed: bool = False


class _MethodVisitor(ast.NodeVisitor):
    """One method's writes / calls / lock usage, tracking the lexical
    ``with``-lock stack (nested function defs inside the method are
    walked too: closures run on the same thread family)."""

    def __init__(self, lock_re: re.Pattern, blocking: tuple[str, ...],
                 assume_locked: bool) -> None:
        self.lock_re = lock_re
        self.blocking = set(blocking)
        self.stack: list[str] = []           # held lock attr names
        self.assume_locked = assume_locked   # *_locked convention
        self.calls: set[str] = set()
        self.writes: list[tuple[str, int, bool, tuple[str, ...]]] = []
        self.locked_calls: list[tuple[str, int,
                                      tuple[str, ...]]] = []
        self.blocking_sites: list[tuple[str, int]] = []
        self.locked_blocking: list[tuple[str, int]] = []
        self.acquisitions: list[tuple[str, tuple[str, ...], int]] = []
        self.reads: list[tuple[str, int, tuple[str, ...], bool]] = []
        self.alias_calls: list[tuple[tuple[str, ...], int,
                                     tuple[str, ...]]] = []
        #: local var → self-attribute chain (`reg = self.co.registry`)
        self._local_alias: dict[str, tuple[str, ...]] = {}

    def _locked(self) -> bool:
        return self.assume_locked or bool(self.stack)

    def _lock_attr(self, expr: ast.AST) -> str | None:
        name = dotted_name(expr)
        if name and self.lock_re.search(name.split(".")[-1]):
            return name.split(".")[-1]
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            expr = item.context_expr
            callee = expr.func if isinstance(expr, ast.Call) else expr
            attr = self._lock_attr(callee)
            if attr is not None:
                self.acquisitions.append(
                    (attr, tuple(self.stack), node.lineno))
                self.stack.append(attr)
                acquired.append(attr)
            else:
                # a non-lock context manager's construction runs under
                # whatever locks earlier items already acquired — e.g.
                # `with self._lock, subprocess.Popen(...) as p:` blocks
                # inside the critical section
                self.visit(expr)
            if item.optional_vars is not None:
                targets = item.optional_vars
                for el in (targets.elts
                           if isinstance(targets, (ast.Tuple, ast.List))
                           else [targets]):
                    self._record_write(el, node.lineno)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.stack.pop()

    def _record_write(self, target: ast.AST, line: int) -> None:
        # self.attr = ... / self.attr[...] = ... / self.attr += ...
        node = target
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self":
            self.writes.append((node.attr, line, self._locked(),
                                tuple(self.stack)))

    def _self_chain(self, node: ast.AST) -> tuple[str, ...] | None:
        """("a", "b") for a pure `self.a.b` attribute chain."""
        name = dotted_name(node)
        if name and name.startswith("self.") and "(" not in name:
            return tuple(name.split(".")[1:])
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            for el in (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List))
                       else [tgt]):
                self._record_write(el, node.lineno)
        # local aliases of self-attribute chains feed the cross-object
        # lock-order pass (`reg = self.co.registry; reg.lock_stuff()`)
        if len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            chain = self._self_chain(node.value)
            if chain:
                self._local_alias[node.targets[0].id] = chain
            else:
                self._local_alias.pop(node.targets[0].id, None)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_write(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_write(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        term = terminal_name(node.func)
        if name and name.startswith("self.") and name.count(".") == 1:
            self.calls.add(term or "")
            if self._locked():
                self.locked_calls.append((term or "", node.lineno,
                                          tuple(self.stack)))
        elif name and name.startswith("self.") and name.count(".") >= 2:
            self.alias_calls.append(
                (tuple(name.split(".")[1:]), node.lineno,
                 tuple(self.stack)))
        elif name and "." in name and \
                name.split(".")[0] in self._local_alias:
            parts = name.split(".")
            self.alias_calls.append(
                (self._local_alias[parts[0]] + tuple(parts[1:]),
                 node.lineno, tuple(self.stack)))
        if name and (name in self.blocking or term in self.blocking):
            self.blocking_sites.append((name, node.lineno))
            if self._locked():
                self.locked_blocking.append((name, node.lineno))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self":
            self.reads.append((node.attr, node.lineno,
                               tuple(self.stack), self.assume_locked))
        self.generic_visit(node)


def _class_methods(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _analyze_method(fn, lock_re, blocking) -> _MethodInfo:
    assumed = fn.name.endswith("_locked")
    v = _MethodVisitor(lock_re, blocking, assume_locked=assumed)
    for stmt in fn.body:
        v.visit(stmt)
    return _MethodInfo(
        name=fn.name, calls=v.calls,
        writes=[_Write(a, fn.name, ln, lk, ls)
                for a, ln, lk, ls in v.writes],
        locked_calls=v.locked_calls, blocking_sites=v.blocking_sites,
        locked_blocking=v.locked_blocking, acquisitions=v.acquisitions,
        reads=v.reads, alias_calls=v.alias_calls, assumed=assumed)


def _reachable(methods: dict[str, _MethodInfo], roots: set[str]
               ) -> set[str]:
    seen: set[str] = set()
    frontier = [r for r in roots if r in methods]
    while frontier:
        cur = frontier.pop()
        if cur in seen:
            continue
        seen.add(cur)
        frontier.extend(c for c in methods[cur].calls
                        if c in methods and c not in seen)
    return seen


def _skip_class(cls: ast.ClassDef, manifest: Manifest) -> bool:
    for base in cls.bases:
        name = terminal_name(base)
        if name in manifest.per_request_bases:
            return True
    return False


def _annotation_classes(node: ast.AST) -> list[str]:
    """Candidate class names inside an annotation expression
    (``WorkerRegistry | None``, ``"Coordinator"``, ``Optional[X]``)."""
    names: list[str] = []
    if node is None:
        return names
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            names.append(sub.id)
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            names.extend(p for p in re.split(r"[^\w.]+", sub.value) if p)
    return names


def _build_attr_types(class_info: dict) -> dict:
    """(class key, attr) → class key of objects assigned to
    ``self.attr`` in __init__ — direct construction
    (``self.x = Foo(...)``), annotated parameters (``def __init__(self,
    x: Foo | None)`` + ``self.x = x``), and if-expressions over both.
    Class keys are (mod, name, lineno) so same-named classes stay
    distinct; ambiguous simple names resolve to nothing."""
    index: dict[str, tuple | None] = {}
    for key in class_info:
        cls_name = key[1]
        if cls_name in index:
            index[cls_name] = None          # ambiguous
        else:
            index[cls_name] = key

    def resolve_name(name: str | None):
        if not name:
            return None
        return index.get(name.split(".")[-1])

    out: dict = {}
    for key, info in class_info.items():
        init = info["init"]
        if init is None:
            continue
        params: dict[str, tuple] = {}
        for arg in list(init.args.args) + list(init.args.kwonlyargs):
            for cand in _annotation_classes(arg.annotation):
                hit = resolve_name(cand)
                if hit is not None:
                    params[arg.arg] = hit
                    break

        def resolve_expr(expr):
            if isinstance(expr, ast.Call):
                return resolve_name(dotted_name(expr.func))
            if isinstance(expr, ast.Name):
                return params.get(expr.id)
            if isinstance(expr, ast.IfExp):
                return resolve_expr(expr.body) or resolve_expr(expr.orelse)
            if isinstance(expr, ast.BoolOp):
                for v in expr.values:
                    hit = resolve_expr(v)
                    if hit is not None:
                        return hit
            return None

        for stmt in ast.walk(init):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt = stmt.targets[0]
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    hit = resolve_expr(stmt.value)
                    if hit is not None:
                        out[key + (tgt.attr,)] = hit
    return out


def run(tree: SourceTree, manifest: Manifest) -> list[Finding]:
    lock_re = re.compile(manifest.lock_attr_pattern)
    qualified_entries, bare_entries = discover_entry_names(tree)
    declared: dict[tuple[str, str, str], str] = {}
    for spec, kind in manifest.thread_entrypoints.items():
        mod, _, qual = spec.partition(":")
        cls_name, _, meth = qual.partition(".")
        declared[(mod, cls_name, meth)] = kind
    guarded: dict[tuple[str, str, str], str] = {}
    for spec, lock in manifest.guarded_by.items():
        mod, _, qual = spec.partition(":")
        cls_name, _, attr = qual.partition(".")
        guarded[(mod, cls_name, attr)] = lock

    # -- phase 1: per-class inventory (methods parsed once) ------------
    class_info: dict[tuple[str, str], dict] = {}
    for mod in tree.modules():
        for cls in [n for n in ast.walk(tree.tree(mod))
                    if isinstance(n, ast.ClassDef)]:
            if _skip_class(cls, manifest):
                continue
            methods = {fn.name: _analyze_method(fn, lock_re,
                                                manifest.blocking_calls)
                       for fn in _class_methods(cls)}
            if not methods:
                continue
            init = next((fn for fn in _class_methods(cls)
                         if fn.name == "__init__"), None)
            # keyed by (mod, name, lineno): a second same-named
            # class in one module (nested/factory-local) must not
            # shadow the first out of the audit
            class_info[(mod, cls.name, cls.lineno)] = {
                "node": cls, "methods": methods, "init": init}
    attr_types = _build_attr_types(class_info)

    findings: list[Finding] = []
    lock_edges: dict[tuple[str, str], tuple[str, int]] = {}

    def resolve_chain(ckey, chain):
        """Follow `self.a.b.method()` through the attr-type map;
        returns (tmod, tcls, method_info) or None."""
        cur = ckey
        for attr in chain[:-1]:
            cur = attr_types.get(cur + (attr,))
            if cur is None:
                return None
        target = class_info.get(cur)
        if target is None:
            return None
        info = target["methods"].get(chain[-1])
        if info is None:
            return None
        return cur[0], cur[1], info

    # -- phase 2: per-class findings -----------------------------------
    for ckey, entry_data in class_info.items():
        mod = ckey[0]
        cls = entry_data["node"]
        methods = entry_data["methods"]

        # entrypoints: discovered thread targets + declared ones;
        # everything else public folds into one "api" entry
        entries: dict[str, tuple[set[str], str]] = {}
        for name in methods:
            kind = declared.get((mod, cls.name, name)) or \
                qualified_entries.get((mod, cls.name, name)) or \
                bare_entries.get(name)
            if kind and name != "__init__":
                entries[name] = ({name}, kind)
        api_roots = {name for name in methods
                     if name not in entries and name != "__init__"
                     and (not name.startswith("_")
                          or name == "__call__")}
        if api_roots:
            entries["api"] = (api_roots, "single")

        owns_lock = any(
            lock_re.search(w.attr)
            for info in methods.values() for w in info.writes)
        concurrent_entries = {e for e, (_r, k) in entries.items()
                              if k == "concurrent"}
        multi_threaded = len(entries) > 1 or concurrent_entries

        writes_by_attr: dict[str, list[_Write]] = {}
        for info in methods.values():
            if info.name == "__init__":
                continue
            for w in info.writes:
                writes_by_attr.setdefault(w.attr, []).append(w)

        # -- TVT-T001: unlocked cross-thread writes ----------------
        if multi_threaded:
            reach = {e: _reachable(methods, roots)
                     for e, (roots, _k) in entries.items()}
            for attr, writes in sorted(writes_by_attr.items()):
                unlocked = [w for w in writes if not w.locked]
                if not unlocked:
                    continue
                touched = {e for e in entries
                           for w in writes if w.method in reach[e]}
                racy = len(touched) > 1 or \
                    (touched & concurrent_entries)
                if not racy:
                    continue
                w0 = unlocked[0]
                findings.append(finding(
                    "TVT-T001", mod, w0.line,
                    f"{cls.name}.{attr} written without a lock in "
                    f"{w0.method}() but shared across entrypoints "
                    f"{sorted(touched)}",
                    key_detail=f"{mod}:{cls.name}.{attr}"))

        # -- TVT-T004a: writes guarded by DIFFERENT locks ----------
        if multi_threaded:
            for attr, writes in sorted(writes_by_attr.items()):
                if lock_re.search(attr):
                    continue
                real = [frozenset(w.lockset) for w in writes
                        if w.lockset and not methods[w.method].assumed]
                if len(real) < 2 or len(set(real)) < 2:
                    continue
                if not frozenset.intersection(*real):
                    locks = sorted({", ".join(sorted(s)) for s in real})
                    # anchor on a write that is part of the evidence
                    # (assumed *_locked sites were excluded from it)
                    w0 = min((w for w in writes if w.lockset
                              and not methods[w.method].assumed),
                             key=lambda w: w.line)
                    findings.append(finding(
                        "TVT-T004", mod, w0.line,
                        f"{cls.name}.{attr} is written under "
                        f"DIFFERENT locks ({'; '.join(locks)}) — the "
                        f"lockset intersection is empty, so no single "
                        f"lock protects the field",
                        key_detail=f"{mod}:{cls.name}.{attr}:split"))

        # -- TVT-T004b: declared guarded-by enforcement ------------
        for (gmod, gcls, gattr), lock in sorted(guarded.items()):
            if (gmod, gcls) != (mod, cls.name):
                continue
            seen_sites: set[str] = set()
            for info in methods.values():
                if info.name == "__init__" or info.assumed:
                    continue
                sites = [(w.line, "write", w.lockset)
                         for w in info.writes if w.attr == gattr]
                sites += [(line, "read", lockset)
                          for a, line, lockset, assumed in info.reads
                          if a == gattr and not assumed]
                for line, kindname, lockset in sites:
                    if lock in lockset:
                        continue
                    key = f"{info.name}:{kindname}"
                    if key in seen_sites:
                        continue
                    seen_sites.add(key)
                    findings.append(finding(
                        "TVT-T004", mod, line,
                        f"{cls.name}.{gattr} is declared guarded by "
                        f"`{lock}` but {info.name}() {kindname}s it "
                        f"without holding it (use `with self.{lock}:` "
                        f"or the *_locked convention)",
                        # read and write sites are distinct debts: one
                        # waiver must not silently cover both
                        key_detail=f"{mod}:{cls.name}.{gattr}:"
                                   f"{info.name}:{kindname}"))

        # -- TVT-T002: blocking calls under a lock -----------------
        if owns_lock or multi_threaded:
            for info in methods.values():
                for name, line in info.locked_blocking:
                    findings.append(finding(
                        "TVT-T002", mod, line,
                        f"{cls.name}.{info.name}() calls blocking "
                        f"`{name}` while holding a lock",
                        key_detail=f"{mod}:{cls.name}."
                                   f"{info.name}:{name}"))
                for callee, line, _held in info.locked_calls:
                    target = methods.get(callee)
                    if target and target.blocking_sites:
                        bname, bline = target.blocking_sites[0]
                        findings.append(finding(
                            "TVT-T002", mod, bline,
                            f"{cls.name}.{info.name}() holds a lock "
                            f"across {callee}(), which calls "
                            f"blocking `{bname}`",
                            key_detail=f"{mod}:{cls.name}."
                                       f"{callee}:{bname}"))

        # -- lock-order edges (cycle check runs globally) ----------
        for info in methods.values():
            for attr, held, line in info.acquisitions:
                for h in held:
                    lock_edges.setdefault(
                        (f"{mod}:{cls.name}.{h}",
                         f"{mod}:{cls.name}.{attr}"),
                        (mod, line))
            # one level through same-class calls: holding L at the
            # CALL SITE, call self.X() where X acquires M
            for callee, line, call_held in info.locked_calls:
                target = methods.get(callee)
                if not target:
                    continue
                for attr, _held, aline in target.acquisitions:
                    for h in call_held:
                        lock_edges.setdefault(
                            (f"{mod}:{cls.name}.{h}",
                             f"{mod}:{cls.name}.{attr}"),
                            (mod, aline))

            # cross-OBJECT edges (TVT-T005): `self.a.b.m()` (or via a
            # local alias) while holding a lock → edges from the held
            # locks to every lock `m` acquires on the resolved class.
            # One level of same-class propagation: a locked call to a
            # sibling method carries the locks held AT THAT CALL SITE
            # over the sibling's alias calls (the
            # _worker_eligible_locked shape) — not every lock the
            # caller ever touched, which would fabricate edges that no
            # execution can interleave.
            def _cross_edges(alias_calls, held_hint):
                for chain, _line, held in alias_calls:
                    hold = set(held) or held_hint
                    if not hold:
                        continue
                    resolved = resolve_chain(ckey, chain)
                    if resolved is None:
                        continue
                    tmod, tcls, tinfo = resolved
                    for attr2, _h2, aline2 in tinfo.acquisitions:
                        for h in hold:
                            lock_edges.setdefault(
                                (f"{mod}:{cls.name}.{h}",
                                 f"{tmod}:{tcls}.{attr2}"),
                                (mod, aline2))

            _cross_edges(info.alias_calls, set())
            for callee, _line, call_held in info.locked_calls:
                target = methods.get(callee)
                if target is not None:
                    _cross_edges(target.alias_calls, set(call_held))

    # -- TVT-T003/T005: cycles in the acquisition-order graph ----------
    graph: dict[str, set[str]] = {}
    for (a, b), _site in lock_edges.items():
        if a != b:
            graph.setdefault(a, set()).add(b)
    for cycle in _find_cycles(graph):
        mod = cycle[0].split(":")[0]
        owners = {c.rsplit(".", 1)[0] for c in cycle[:-1]}
        code = "TVT-T005" if len(owners) > 1 else "TVT-T003"
        pretty = " -> ".join(c.split(":", 1)[1] for c in cycle)
        scope = "cross-object " if code == "TVT-T005" else ""
        findings.append(finding(
            code, mod, 0,
            f"inconsistent {scope}lock acquisition order: {pretty}",
            key_detail="->".join(sorted(set(cycle)))))
    return findings


def _find_cycles(graph: dict[str, set[str]]) -> list[list[str]]:
    """Distinct simple cycles (each reported once, rotated to its
    lexicographically-smallest node)."""
    cycles: dict[tuple[str, ...], list[str]] = {}

    def dfs(node: str, path: list[str], on_path: set[str]) -> None:
        for nxt in graph.get(node, ()):
            if nxt in on_path:
                i = path.index(nxt)
                cyc = path[i:] + [nxt]
                body = cyc[:-1]
                k = body.index(min(body))
                canon = tuple(body[k:] + body[:k])
                cycles.setdefault(canon, cyc)
            elif nxt not in path:
                dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(graph):
        dfs(start, [start], {start})
    return list(cycles.values())
