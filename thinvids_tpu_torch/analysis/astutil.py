"""Shared AST plumbing for the repo-native static analysis passes.

Every pass (imports / syncs / threads / configcheck) wants the same
three things: the package's module inventory, each module's parsed AST
(parsed once, shared), and a uniform Finding record whose `key` is
stable across line-number churn so the manifest's waiver list doesn't
rot every time a file is edited above a finding.

Device-free by contract: the analyzer runs as a fast subprocess
(`cli.py check`) and must never import torch or start a CUDA context.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding.

    `key` is the waiver handle: code + the stable identity of the
    violation (module, attribute, settings key, ...) WITHOUT line
    numbers, so a waiver written against it survives unrelated edits.
    `line` is display-only."""

    code: str           # e.g. "TVT-J001"
    module: str         # dotted module the finding lives in ("" = global)
    line: int           # 1-based, 0 when the finding has no single site
    message: str
    key: str

    def format(self) -> str:
        where = f"{self.module}:{self.line}" if self.module else "(repo)"
        return f"{self.code} {where}: {self.message}"


def finding(code: str, module: str, line: int, message: str,
            key_detail: str = "") -> Finding:
    detail = key_detail if key_detail else module
    return Finding(code=code, module=module, line=line, message=message,
                   key=f"{code}:{detail}")


class SourceTree:
    """The analyzed package: module inventory + cached ASTs.

    `package_dir` is the directory of the package's __init__.py;
    modules are addressed by their dotted name rooted at the package
    (``thinvids_tpu_torch.abr.hls``). Extra top-level files (bench.py for the
    config-reader scan) can ride along via `extra_files` — they appear
    with a ``::`` pseudo-module name so they join text scans without
    polluting the import graph."""

    def __init__(self, package_dir: str, package: str | None = None,
                 extra_files: tuple[str, ...] = ()) -> None:
        self.package_dir = os.path.abspath(package_dir)
        self.package = package or os.path.basename(self.package_dir)
        self.extra_files = tuple(extra_files)
        self._sources: dict[str, str] = {}
        self._asts: dict[str, ast.Module] = {}
        self._paths: dict[str, str] = {}
        self._discover()

    def _discover(self) -> None:
        for dirpath, dirs, files in os.walk(self.package_dir):
            dirs[:] = [d for d in dirs
                       if d != "__pycache__" and not d.startswith(".")]
            for name in sorted(files):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, self.package_dir)
                parts = rel[:-3].split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                mod = ".".join([self.package] + parts) if parts \
                    else self.package
                self._paths[mod] = path
        for path in self.extra_files:
            self._paths["::" + os.path.basename(path)] = path

    def modules(self) -> list[str]:
        """Dotted names of every in-package module (no extra files)."""
        return sorted(m for m in self._paths if not m.startswith("::"))

    def all_names(self) -> list[str]:
        return sorted(self._paths)

    def has_module(self, mod: str) -> bool:
        return mod in self._paths

    def path(self, mod: str) -> str:
        return self._paths[mod]

    def source(self, mod: str) -> str:
        if mod not in self._sources:
            with open(self._paths[mod], encoding="utf-8") as fh:
                self._sources[mod] = fh.read()
        return self._sources[mod]

    def tree(self, mod: str) -> ast.Module:
        if mod not in self._asts:
            self._asts[mod] = ast.parse(self.source(mod),
                                        filename=self._paths[mod])
        return self._asts[mod]

    def items(self) -> Iterator[tuple[str, ast.Module]]:
        for mod in self.all_names():
            yield mod, self.tree(mod)


def module_matches(mod: str, pattern: str) -> bool:
    """True when `mod` is `pattern` or lives under the `pattern`
    package (``a.io`` matches ``a.io`` and ``a.io.y4m``)."""
    return mod == pattern or mod.startswith(pattern + ".")


def matches_any(mod: str, patterns) -> bool:
    return any(module_matches(mod, p) for p in patterns)


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> str | None:
    """The last identifier of a Name/Attribute chain (``self.run`` →
    ``run``); None for anything that isn't a plain chain."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def qualified_functions(tree: ast.Module):
    """(qualified name, node) for every function-like scope at any
    depth — FunctionDef/AsyncFunctionDef (qualified through enclosing
    classes and functions, ``Cls.method.nested``) and Lambda (as
    ``prefix<lambda>``). Shared by the statemachine and jitcheck
    passes so qualification rules cannot drift between them."""

    def rec(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from rec(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.")
            elif isinstance(child, ast.Lambda):
                yield f"{prefix}<lambda>", child
                yield from rec(child, prefix)
            else:
                yield from rec(child, prefix)

    yield from rec(tree, "")


def is_type_checking_if(node: ast.AST) -> bool:
    """``if TYPE_CHECKING:`` / ``if typing.TYPE_CHECKING:`` guard —
    its imports never execute, so the import graph skips them."""
    if not isinstance(node, ast.If):
        return False
    test = node.test
    return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or \
        (isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING")


def string_constants(tree: ast.Module) -> set[str]:
    """Every string literal in the module (f-string fragments
    included) — the config pass's "is this key referenced" corpus."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value)
    return out


def attribute_names(tree: ast.Module) -> set[str]:
    return {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
