"""Pass 1 — device confinement over the transitive import graph.

Builds the package's module-scope import graph (what executes at
``import`` time: top-level statements, class bodies, module-level
``try``/``if`` arms — NOT function bodies or ``if TYPE_CHECKING``
blocks) and proves that every module the manifest declares device-free
can never reach a forbidden external root (``torch``, ``triton``)
through any chain of module-scope imports (TVT-J001).

Importing ``a.b.c`` executes ``a/__init__`` and ``a.b/__init__`` too,
so package-__init__ edges are part of every module's closure — the
lazy ``__getattr__`` pattern (parallel/__init__.py, codecs/h264/
__init__.py) is exactly what keeps those edges clean, and this pass is
what notices when someone "simplifies" one back into an eager import.

Also enforces the manifest's forbidden-symbol rules (TVT-J002): e.g.
the streaming executors must never reference ``read_video`` (the
blocking whole-clip decode prologue); and the port's standing rule
(TVT-J003): NO module of the package imports the reference's roots
(``jax``, ``thinvids_tpu``) at module scope.
"""

from __future__ import annotations

import ast
from typing import Iterable

from .astutil import (Finding, SourceTree, finding, is_type_checking_if,
                      matches_any)
from .manifest import Manifest


def _module_scope_nodes(tree: ast.Module):
    """Statements that execute at import time: walk the module body,
    descending into If/Try/With/ClassDef but not into function
    bodies; TYPE_CHECKING arms are skipped."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if is_type_checking_if(node):
            stack.extend(node.orelse)
            continue
        yield node
        for child in ast.iter_child_nodes(node):
            stack.append(child)


def _resolve_from(mod: str, node: ast.ImportFrom, tree: SourceTree,
                  package: str) -> tuple[list[str], list[str]]:
    """ImportFrom → (in-package module edges, external roots)."""
    internal: list[str] = []
    external: list[str] = []
    if node.level:
        # relative: base = this module minus `level` trailing parts
        # (a package __init__ counts as the package itself)
        base_parts = mod.split(".")
        if not tree.path(mod).endswith("__init__.py"):
            base_parts = base_parts[:-1]
        base_parts = base_parts[:len(base_parts) - (node.level - 1)]
        base = ".".join(base_parts + ([node.module] if node.module else []))
    else:
        base = node.module or ""
        if not (base == package or base.startswith(package + ".")):
            if base:
                external.append(base.split(".")[0])
            return internal, external
    if tree.has_module(base):
        internal.append(base)
    for alias in node.names:
        sub = f"{base}.{alias.name}"
        # `from pkg import submodule` imports the submodule file
        if tree.has_module(sub):
            internal.append(sub)
    return internal, external


def build_import_graph(tree: SourceTree, package: str
                       ) -> dict[str, tuple[set[str], set[str]]]:
    """module → (in-package imports, external top-level roots), at
    module scope only. Every in-package edge also pulls the target's
    ancestor package __init__s (Python executes them on import)."""
    graph: dict[str, tuple[set[str], set[str]]] = {}
    for mod in tree.modules():
        internal: set[str] = set()
        external: set[str] = set()
        for node in _module_scope_nodes(tree.tree(mod)):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.name
                    if name == package or name.startswith(package + "."):
                        if tree.has_module(name):
                            internal.add(name)
                    else:
                        external.add(name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                ints, exts = _resolve_from(mod, node, tree, package)
                internal.update(ints)
                external.update(exts)
        # ancestor __init__ edges (importing a.b.c executes a and a.b)
        expanded = set(internal)
        for tgt in internal:
            parts = tgt.split(".")
            for i in range(1, len(parts)):
                anc = ".".join(parts[:i])
                if tree.has_module(anc):
                    expanded.add(anc)
        expanded.discard(mod)
        graph[mod] = (expanded, external)
    return graph


def import_closure(graph, roots) -> tuple[set[str], dict[str, str]]:
    """Transitive in-package closure of `roots` (a module name or an
    iterable of them) + a parent map for chain reconstruction. ONE
    traversal over all roots: each node gets its parent assigned
    exactly once when first discovered, so the map is a forest rooted
    at `roots` — merging per-root maps instead can stitch a cycle
    (A←B, B←A from different roots) and hang the chain walk."""
    roots = [roots] if isinstance(roots, str) else list(roots)
    seen: set[str] = set(roots)
    parent: dict[str, str] = {}
    frontier = list(roots)
    while frontier:
        cur = frontier.pop()
        for nxt in graph.get(cur, (set(), set()))[0]:
            if nxt not in seen:
                seen.add(nxt)
                parent[nxt] = cur
                frontier.append(nxt)
    return seen, parent


def _chain(parent: dict[str, str], roots: set[str], end: str) -> str:
    path = [end]
    # the parent map is a forest rooted at `roots` (see
    # import_closure); the bound is belt-and-braces so a future graph
    # bug degrades the message instead of hanging the checker
    for _ in range(len(parent) + 1):
        if path[-1] in roots or path[-1] not in parent:
            break
        path.append(parent[path[-1]])
    return " -> ".join(reversed(path))


def _own_ancestors(tree: SourceTree, mod: str) -> list[str]:
    """Importing `mod` executes its own ancestor __init__s first."""
    parts = mod.split(".")
    return [".".join(parts[:i]) for i in range(1, len(parts))
            if tree.has_module(".".join(parts[:i]))]


def check_device_confinement(tree: SourceTree, manifest: Manifest
                             ) -> list[Finding]:
    graph = build_import_graph(tree, manifest.package)
    findings: list[Finding] = []
    declared = [m for m in tree.modules()
                if matches_any(m, manifest.device_free)]
    for mod in declared:
        roots = list(_own_ancestors(tree, mod)) + [mod]
        seen, parent = import_closure(graph, roots)
        for reached in sorted(seen):
            _ints, exts = graph.get(reached, (set(), set()))
            bad = exts.intersection(manifest.device_roots)
            if not bad:
                continue
            via = "" if reached == mod else \
                f" via {_chain(parent, set(roots), reached)}"
            findings.append(finding(
                "TVT-J001", mod, 1,
                f"declared device-free but reaches {sorted(bad)} at "
                f"module scope{via}",
                key_detail=f"{mod}:{reached}"))
    return findings


def check_reference_confinement(tree: SourceTree, manifest: Manifest
                                ) -> list[Finding]:
    """TVT-J003: every module, not only the declared set. A module's
    own module-scope imports are checked; since every module is, no
    import chain can reach a reference root either."""
    findings: list[Finding] = []
    for mod in tree.modules():
        for node in _module_scope_nodes(tree.tree(mod)):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            for root in roots:
                if root in manifest.reference_roots:
                    findings.append(finding(
                        "TVT-J003", mod, node.lineno,
                        f"imports `{root}` at module scope — the port "
                        f"stands alone beside the package it is held "
                        f"against",
                        key_detail=f"{mod}:{root}"))
    uniq: dict[str, Finding] = {}
    for f in findings:
        uniq.setdefault(f.key, f)
    return list(uniq.values())


def check_forbidden_symbols(tree: SourceTree, manifest: Manifest
                            ) -> list[Finding]:
    findings: list[Finding] = []
    for mod, rules in manifest.forbidden_symbols.items():
        if not tree.has_module(mod):
            continue
        for node in ast.walk(tree.tree(mod)):
            names: Iterable[tuple[str, int]] = ()
            if isinstance(node, ast.Name):
                names = [(node.id, node.lineno)]
            elif isinstance(node, ast.Attribute):
                names = [(node.attr, node.lineno)]
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [(alias.name.split(".")[-1], node.lineno)
                         for alias in node.names]
            for name, line in names:
                for symbol, reason in rules:
                    if name == symbol:
                        findings.append(finding(
                            "TVT-J002", mod, line,
                            f"references forbidden symbol "
                            f"`{symbol}`: {reason}",
                            key_detail=f"{mod}:{symbol}"))
    # one finding per (module, symbol): dedup repeated references
    uniq: dict[str, Finding] = {}
    for f in findings:
        uniq.setdefault(f.key, f)
    return list(uniq.values())


def run(tree: SourceTree, manifest: Manifest) -> list[Finding]:
    return check_device_confinement(tree, manifest) \
        + check_forbidden_symbols(tree, manifest) \
        + check_reference_confinement(tree, manifest)
