"""Pass 6 — kernel and hot-loop discipline, in torch's idiom.

The wave pipeline's throughput rests on contracts the AST can check
(the reference's jit/retrace pass, rewritten for torch):

TVT-X001  **the kernel-build surface and pinned shapes.**
          (a) device code is BUILT or LOADED only in the manifest's
          `kernel_modules`: ``ctypes.CDLL``, the
          ``torch.utils.cpp_extension`` loaders (``load``,
          ``load_inline``), ``torch.compile``, ``triton.jit`` and CUDA
          graphs (``torch.cuda.CUDAGraph``, ``torch.cuda.graph``). A
          kernel library built or loaded elsewhere escapes
          chip_smoke.py's build into the git-ignored ``_build/``
          directories and its launch counts.
          (b) the quantized-slice rule: inside a module that imports
          torch (one that can hold a tensor), a slice bound derived
          from runtime DATA (`.max()` / `.item()` on a tensor, directly
          or through a local name) must route through a declared shape
          quantizer (`cut`, ...).
          `payload[:, :used.max()]` is a host sync and a fresh shape
          for every wave, where `payload[:, :cut(used.max())]` pins it.

TVT-X002  **hot-loop transfer ban.** The manifest's `hot_loops`
          declare the per-wave / per-SFE-frame functions. Calls that
          make the host wait on the card there (``synchronize``,
          ``.cpu()``, ``.item()``, ``.tolist()``, ``.numpy()``, a
          ``.to(...)`` / ``.cuda()`` without ``non_blocking=True``)
          serialize the pipeline — staging (`stage_waves`) and collect
          (`collect_wave`, `_fetch_*`) are the allowlisted transfer
          sites and are deliberately NOT declared hot.
          ``.to(dev, non_blocking=True)``, ``Event.record`` and
          ``record_stream`` stay legal everywhere: they are the
          counterpart of the reference's ``copy_to_host_async``, which
          OVERLAPS the pipeline instead of blocking it.
"""

from __future__ import annotations

import ast

from .astutil import (Finding, SourceTree, dotted_name, finding,
                      matches_any, qualified_functions)
from .manifest import Manifest
from .syncs import torch_aliases

#: attribute calls whose result is data-dependent (a dynamic shape
#: bound when used to slice)
_DYNAMIC_SOURCES = {"max", "min", "item", "argmax", "argmin"}

#: calls that make the host wait inside a hot loop. `.item()` (and
#: `.cpu()`, `.numpy()`, `.tolist()`) is only meaningful as an
#: attribute call — matching the bare name `item` would flag ordinary
#: loop variables.
_HOT_FORBIDDEN_ATTRS = {"synchronize", "cpu", "item", "tolist", "numpy"}
_HOT_FORBIDDEN_NAMES = {"synchronize"}
#: host↔device copies: blocking unless called with non_blocking=True
_COPY_ATTRS = {"to", "cuda"}

#: numeric wrappers that keep a dynamic value dynamic
_PASSTHROUGH = {"int", "float", "abs", "round"}

#: the kernel-build surface: (dotted suffix, display name). A reference
#: whose dotted name ends with the suffix (``ctypes.CDLL``,
#: ``torch.cuda.graph``, ...) or an import of it is a finding.
_KERNEL_SURFACE = (
    ("ctypes.CDLL", "ctypes.CDLL"),
    ("cpp_extension.load", "torch.utils.cpp_extension.load"),
    ("cpp_extension.load_inline", "torch.utils.cpp_extension.load_inline"),
    ("torch.compile", "torch.compile"),
    ("triton.jit", "triton.jit"),
    ("cuda.CUDAGraph", "torch.cuda.CUDAGraph"),
    ("cuda.graph", "torch.cuda.graph"),
)


def _kernel_surface_hit(node: ast.AST) -> str | None:
    """The kernel-build symbol `node` names, else None."""
    if isinstance(node, ast.Attribute):
        name = dotted_name(node) or ""
        for suffix, shown in _KERNEL_SURFACE:
            if name == suffix or name.endswith("." + suffix):
                return shown
    elif isinstance(node, ast.ImportFrom) and node.module:
        for alias in node.names:
            full = f"{node.module}.{alias.name}"
            for suffix, shown in _KERNEL_SURFACE:
                if full == suffix or full.endswith("." + suffix):
                    return shown
    return None


def _is_dtype(node: ast.AST) -> bool:
    """``torch.int16`` / ``torch.float32`` ...: a `.to()` argument that
    converts on the device instead of copying across."""
    name = dotted_name(node) or ""
    parts = name.split(".")
    return len(parts) == 2 and parts[0] == "torch" and (
        parts[1].startswith(("int", "uint", "float", "bfloat", "bool",
                             "complex", "half", "double", "long",
                             "short")))


def _blocking_copy(node: ast.Call) -> bool:
    """A `.to(...)` / `.cuda()` call that may cross host↔device and
    does not ask for non_blocking=True. A `.to()` whose only argument
    is a dtype (positional or `dtype=`) converts on the device."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr in _COPY_ATTRS):
        return False
    for kw in node.keywords:
        if kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return False
    if f.attr == "to":
        others = [kw for kw in node.keywords
                  if kw.arg not in ("dtype", "copy", "memory_format")]
        if all(_is_dtype(a) for a in node.args) and not others:
            return False
    return True


def check_kernel_confinement(tree: SourceTree, manifest: Manifest
                             ) -> list[Finding]:
    findings: list[Finding] = []
    for mod in tree.modules():
        if matches_any(mod, manifest.kernel_modules):
            continue
        mtree = tree.tree(mod)
        for node in ast.walk(mtree):
            shown = _kernel_surface_hit(node)
            if shown is not None:
                findings.append(finding(
                    "TVT-X001", mod, node.lineno,
                    f"`{shown}` referenced outside the declared kernel "
                    f"modules — device code is built and loaded in "
                    f"{{{', '.join(m.rsplit('.', 1)[-1] for m in manifest.kernel_modules)}}} "
                    f"so chip_smoke.py builds it and counts its "
                    f"launches",
                    key_detail=f"{mod}:kernel"))
                break       # one per module is enough signal
    return findings


class _SliceAuditor(ast.NodeVisitor):
    """One function's dynamic-name taint + slice-bound audit. Nested
    ``def``s are NOT descended into (each is audited as its own
    function with fresh taint — closure-carried dynamics are an honest
    limit); lambdas ARE audited inline, with the enclosing taint,
    since their bodies are expressions over the enclosing scope."""

    def __init__(self, quantizers: frozenset) -> None:
        self.quantizers = quantizers
        self.dynamic: set[str] = set()
        #: (line, description) of unquantized dynamic slice bounds
        self.bad: list[tuple[int, str]] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass                    # audited separately, own taint scope

    def visit_AsyncFunctionDef(self, node) -> None:
        pass                    # audited separately, own taint scope

    # -- taint ---------------------------------------------------------

    def _is_quantizer_call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        name = dotted_name(node.func) or ""
        return name.split(".")[-1] in self.quantizers

    def _expr_dynamic(self, node: ast.AST) -> str | None:
        """Name of the dynamic source inside `node`, quantizer calls
        excluded; None when the expression is shape-static."""
        if self._is_quantizer_call(node):
            return None
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func) or ""
            term = fname.split(".")[-1]
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _DYNAMIC_SOURCES:
                return f".{node.func.attr}()"
            if term in _PASSTHROUGH:
                for arg in node.args:
                    d = self._expr_dynamic(arg)
                    if d:
                        return d
                return None
        if isinstance(node, ast.Name) and node.id in self.dynamic:
            return node.id
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Lambda, ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                continue
            d = self._expr_dynamic(child)
            if d:
                return d
        return None

    def _taint_targets(self, targets, value) -> None:
        d = self._expr_dynamic(value)
        for tgt in targets:
            elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                else [tgt]
            for el in elts:
                if isinstance(el, ast.Name):
                    # tuple unpack: any dynamic source on the right
                    # taints every name — conservative, never a miss
                    if d:
                        self.dynamic.add(el.id)
                    else:
                        self.dynamic.discard(el.id)

    def visit_Assign(self, node: ast.Assign) -> None:
        self._taint_targets(node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._taint_targets([node.target], node.value)
        self.generic_visit(node)

    # -- slices --------------------------------------------------------

    def visit_Subscript(self, node: ast.Subscript) -> None:
        bounds: list[ast.AST] = []
        sl = node.slice
        parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        for p in parts:
            if isinstance(p, ast.Slice):
                bounds.extend(b for b in (p.lower, p.upper)
                              if b is not None)
        for b in bounds:
            d = self._expr_dynamic(b)
            if d:
                self.bad.append((node.lineno, d))
        self.generic_visit(node)


def check_quantized_slices(tree: SourceTree, manifest: Manifest
                          ) -> list[Finding]:
    quantizers = frozenset(manifest.shape_quantizers)
    findings: list[Finding] = []
    for mod in tree.modules():
        if not torch_aliases(tree.tree(mod)):
            continue
        # qualified names (Cls.method) keep same-named methods of
        # different classes under distinct finding keys; lambdas are
        # audited inline by the enclosing function's auditor
        for qual, fn in qualified_functions(tree.tree(mod)):
            if isinstance(fn, ast.Lambda):
                continue
            auditor = _SliceAuditor(quantizers)
            for stmt in fn.body:
                auditor.visit(stmt)
            for line, src in auditor.bad:
                findings.append(finding(
                    "TVT-X001", mod, line,
                    f"`{qual}` slices with a data-dependent bound "
                    f"({src}) not routed through a shape quantizer "
                    f"({', '.join(sorted(quantizers))}) — every "
                    f"distinct bound is a host sync and a fresh shape; "
                    f"quantize the used prefix",
                    key_detail=f"{mod}:{qual}:slice"))
    # one finding per (module, qualified function): repeated bounds in
    # one function are one fix
    uniq: dict[str, Finding] = {}
    for f in findings:
        uniq.setdefault(f.key, f)
    return list(uniq.values())


def check_hot_loops(tree: SourceTree, manifest: Manifest
                    ) -> list[Finding]:
    wanted: dict[str, list[str]] = {}
    for spec in manifest.hot_loops:
        mod, _, qual = spec.partition(":")
        wanted.setdefault(mod, []).append(qual)
    findings: list[Finding] = []
    for mod, quals in sorted(wanted.items()):
        if not tree.has_module(mod):
            findings.append(finding(
                "TVT-X002", mod, 0,
                f"declared hot loop module `{mod}` does not exist — "
                f"update the manifest's hot_loops",
                key_detail=f"{mod}:missing"))
            continue
        index = {qual: node
                 for qual, node in qualified_functions(tree.tree(mod))
                 if not isinstance(node, ast.Lambda)}
        for qual in quals:
            fn = index.get(qual)
            if fn is None:
                findings.append(finding(
                    "TVT-X002", mod, 0,
                    f"declared hot loop `{qual}` not found in {mod} — "
                    f"update the manifest's hot_loops",
                    key_detail=f"{mod}:{qual}:missing"))
                continue
            for node in ast.walk(fn):
                name = None
                if isinstance(node, ast.Attribute) and \
                        node.attr in _HOT_FORBIDDEN_ATTRS:
                    name = node.attr
                elif isinstance(node, ast.Name) and \
                        node.id in _HOT_FORBIDDEN_NAMES:
                    name = node.id
                elif isinstance(node, ast.Call) and _blocking_copy(node):
                    name = node.func.attr
                if name is not None:
                    findings.append(finding(
                        "TVT-X002", mod, node.lineno,
                        f"hot loop `{qual}` references blocking "
                        f"transfer `{name}` — move it to a staging/"
                        f"collect site (stage_waves, collect_wave, "
                        f"_fetch_*) or copy with non_blocking=True and "
                        f"an event",
                        key_detail=f"{mod}:{qual}:{name}"))
    uniq: dict[str, Finding] = {}
    for f in findings:
        uniq.setdefault(f.key, f)
    return list(uniq.values())


def run(tree: SourceTree, manifest: Manifest) -> list[Finding]:
    return check_kernel_confinement(tree, manifest) \
        + check_quantized_slices(tree, manifest) \
        + check_hot_loops(tree, manifest)
