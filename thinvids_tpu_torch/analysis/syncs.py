"""Pass 2 — host-sync confinement, in torch's idiom.

A host that waits on the card serializes the wave pipeline: the
dispatcher enqueues a wave's kernels and moves on, and only the collect
side (`_to_host`, the done-event waits in parallel/dispatch.py) may
block. This pass keeps it that way (the reference's pass over
``device_get`` / ``block_until_ready``, rewritten for torch):

TVT-S001  any reference, outside the manifest's allowlist, to a name
          whose call blocks the host on the card: the ``synchronize``
          family (``torch.cuda.synchronize``, ``Event.synchronize``,
          ``Stream.synchronize``) and the tensor → host method
          ``.cpu()``. ``.numpy()``, ``.tolist()`` and ``.item()`` are
          common on numpy arrays too, so they are S002's, not S001's.

TVT-S002  the IMPLICIT syncs: inside a single function, a value
          produced by a ``torch.*`` call (or by a method call on such a
          value) that is fed to ``np.asarray`` / ``np.array`` /
          ``np.ascontiguousarray``, to ``float`` / ``int`` / ``bool``,
          or that has ``.item()`` / ``.tolist()`` / ``.numpy()`` called
          on it; and a Python number stored into such a value through
          integer indices only (``t[0, 0] = 1``: where that selects one
          element, torch copies the number to the card from a host
          tensor, a synchronous copy — a store through a slice or an
          ellipsis, ``z[..., 0, 0] = 0``, fills on the card). The taint is
          deliberately local (names bound within
          one function) — cheap, and zero false positives on host-only
          numpy code. Calls of torch's host-side API (``torch.cuda.*``
          queries, ``torch.device``, ``torch.from_numpy``, ...) return
          no device value and taint nothing.
"""

from __future__ import annotations

import ast

from .astutil import (Finding, SourceTree, dotted_name, finding,
                      matches_any)
from .manifest import Manifest

#: numpy-side consumers that force a device sync when fed a tensor
_SYNC_SINKS = {"asarray", "array", "ascontiguousarray"}
_SCALAR_SINKS = {"float", "int", "bool"}
#: tensor methods that copy to the host (a sync on a CUDA tensor)
_METHOD_SINKS = {"item", "tolist", "numpy"}

#: tensor methods whose result is a host value (metadata, or the host
#: copy S001 already reports): no taint flows through them
_HOST_RESULT = _METHOD_SINKS | {
    "cpu", "size", "dim", "numel", "nelement", "stride", "data_ptr",
    "element_size", "is_contiguous", "get_device", "storage_offset"}

#: sync names that are only a sync as an ATTRIBUTE (``t.cpu()``): a
#: local named ``cpu`` is not a transfer
_ATTR_ONLY = {"cpu"}

#: torch's host-side API, by dotted prefix after the module alias:
#: these calls return host values (counts, flags, devices, events,
#: dtypes info, numpy-backed tensors), never a device tensor
_HOST_API = ("cuda", "device", "backends", "version", "utils", "Size",
             "Generator", "iinfo", "finfo", "is_tensor", "from_numpy",
             "get_num_threads", "set_num_threads", "get_default_dtype",
             "is_grad_enabled", "no_grad", "inference_mode",
             "set_sync_debug_mode", "get_sync_debug_mode")

#: torch submodules a `from torch... import <name>` may bind
_TORCH_SUBMODULES = {"nn", "functional", "fft", "linalg", "special"}


def torch_aliases(tree: ast.Module) -> set[str]:
    """Local names bound to torch or one of its tensor-op submodules
    (`import torch`, `import torch.nn.functional as F`,
    `from torch.nn import functional as F`, ...)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                root = alias.name.split(".")[0]
                if root == "torch":
                    out.add(alias.asname or root)
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.split(".")[0] == "torch":
                for alias in node.names:
                    if alias.name in _TORCH_SUBMODULES:
                        out.add(alias.asname or alias.name)
    return out


def _is_torch_call(node: ast.AST, aliases: set[str]) -> bool:
    """Call whose dotted root is a torch alias (torch.zeros, F.pad...),
    torch's host-side API excluded."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if not name:
        return False
    parts = name.split(".")
    if parts[0] not in aliases:
        return False
    return not (len(parts) > 1 and parts[1] in _HOST_API)


def _function_nodes(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def check_sync_calls(tree: SourceTree, manifest: Manifest
                     ) -> list[Finding]:
    """Flag ANY reference to a sync name — attribute access, bare name,
    or `from torch.cuda import synchronize as sync` alias — not just
    direct calls: storing/aliasing the function escapes a call-only
    check but reintroduces the same serialized wait."""
    findings: list[Finding] = []
    for mod in tree.modules():
        if matches_any(mod, manifest.sync_allowlist):
            continue
        for node in ast.walk(tree.tree(mod)):
            names: list[tuple[str, int]] = []
            if isinstance(node, ast.Attribute):
                names.append((node.attr, node.lineno))
            elif isinstance(node, ast.Name) and node.id not in _ATTR_ONLY:
                names.append((node.id, node.lineno))
            elif isinstance(node, ast.ImportFrom):
                names.extend((alias.name, node.lineno)
                             for alias in node.names
                             if alias.name not in _ATTR_ONLY)
            for attr, line in names:
                if attr in manifest.sync_calls:
                    findings.append(finding(
                        "TVT-S001", mod, line,
                        f"blocking device sync `{attr}` referenced "
                        f"outside the allowlist — route transfers "
                        f"through GopShardEncoder._fetch_bulk",
                        key_detail=f"{mod}:{attr}"))
    uniq: dict[tuple[str, int], Finding] = {}
    for f in findings:
        uniq.setdefault((f.key, f.line), f)
    return list(uniq.values())


class _Taint:
    """One function's torch-value names."""

    def __init__(self, aliases: set[str]) -> None:
        self.aliases = aliases
        self.names: set[str] = set()

    def expr(self, node: ast.AST) -> bool:
        """True when `node` evaluates to a (possibly device) tensor: a
        tainted name, a torch call, a subscript of a tainted value, or
        a method call on one."""
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Subscript):
            return self.expr(node.value)
        if isinstance(node, ast.Call):
            if _is_torch_call(node, self.aliases):
                return True
            f = node.func
            return isinstance(f, ast.Attribute) and \
                f.attr not in _HOST_RESULT and self.expr(f.value)
        return False

    def bind(self, fn: ast.AST) -> None:
        """Taint every name bound from a tainted expression, to a fixed
        point (assignments may appear in any order inside loops)."""
        assigns = [n for n in ast.walk(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign))
                   and n.value is not None]
        changed = True
        while changed:
            changed = False
            for node in assigns:
                if not self.expr(node.value):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    for el in (tgt.elts if isinstance(
                            tgt, (ast.Tuple, ast.List)) else [tgt]):
                        if isinstance(el, ast.Name) and \
                                el.id not in self.names:
                            self.names.add(el.id)
                            changed = True


def check_implicit_syncs(tree: SourceTree, manifest: Manifest
                         ) -> list[Finding]:
    findings: list[Finding] = []
    for mod in tree.modules():
        if matches_any(mod, manifest.sync_allowlist):
            continue
        aliases = torch_aliases(tree.tree(mod))
        if not aliases:
            continue                # module can't hold device values
        for fn in _function_nodes(tree.tree(mod)):
            taint = _Taint(aliases)
            taint.bind(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                sink = arg = None
                if isinstance(func, ast.Attribute) and \
                        func.attr in _SYNC_SINKS and node.args:
                    sink, arg = func.attr, node.args[0]
                elif isinstance(func, ast.Name) and \
                        func.id in _SCALAR_SINKS and node.args:
                    sink, arg = func.id, node.args[0]
                elif isinstance(func, ast.Attribute) and \
                        func.attr in _METHOD_SINKS:
                    sink, arg = f".{func.attr}", func.value
                if sink is None or not taint.expr(arg):
                    continue
                findings.append(_implicit(mod, node.lineno, sink, arg,
                                          fn.name))
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and \
                        _is_number(node.value):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Subscript) and \
                                _element_index(tgt.slice) and \
                                taint.expr(tgt.value):
                            findings.append(_implicit(
                                mod, node.lineno, "[...] = <number>",
                                tgt.value, fn.name))
    return findings


def _is_number(node: ast.AST) -> bool:
    """A Python number literal (``1``, ``-1``, ``0.5``, ``True``)."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) and \
        isinstance(node.value, (int, float))


def _element_index(sl: ast.AST) -> bool:
    """Integer indices only: no slice, ellipsis, None or mask."""
    parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
    return all(isinstance(p, ast.Constant) and isinstance(p.value, int)
               or isinstance(p, ast.Name)
               or isinstance(p, ast.UnaryOp) and isinstance(p.op, ast.USub)
               for p in parts)


def _implicit(mod: str, line: int, sink: str, arg: ast.AST,
              fn_name: str) -> Finding:
    what = dotted_name(arg) or "a tensor"
    return finding(
        "TVT-S002", mod, line,
        f"`{sink}` on {what} forces an implicit device sync on a torch "
        f"value in `{fn_name}`",
        key_detail=f"{mod}:{fn_name}")


def run(tree: SourceTree, manifest: Manifest) -> list[Finding]:
    return check_sync_calls(tree, manifest) \
        + check_implicit_syncs(tree, manifest)
