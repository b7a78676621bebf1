"""Pass 4 — config discipline.

Dead config lies to operators: this pass promotes the dead-key test
into the analyzer and extends it to the whole env/settings surface.

TVT-C001  a DEFAULT_SETTINGS key with no reader outside core/config.py
          (attribute access, string reference, or TVT_ env mention —
          dashboards' .html files count as readers).
TVT-C002  an env knob that either doesn't live in the TVT_* namespace
          (foreign platform prefixes exempt) or is a TVT_* name that
          is neither a registered settings key (TVT_<KEY>) nor one of
          the manifest's declared process-level envs.
TVT-C003  raw subscript access on DEFAULT_SETTINGS or a Settings
          ``.values`` mapping outside core/config.py — every read goes
          through the snapshot attribute / .get path so the canonical
          coerce/clamp tier can't be bypassed.
"""

from __future__ import annotations

import ast
import os

from .astutil import (Finding, SourceTree, attribute_names, finding,
                      string_constants)
from .manifest import Manifest


def _default_settings() -> dict:
    from ..core.config import DEFAULT_SETTINGS

    return dict(DEFAULT_SETTINGS)


def _html_text(tree: SourceTree) -> str:
    chunks = []
    for dirpath, dirs, files in os.walk(tree.package_dir):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            if name.endswith(".html"):
                with open(os.path.join(dirpath, name),
                          encoding="utf-8") as fh:
                    chunks.append(fh.read())
    return "\n".join(chunks)


def check_dead_keys(tree: SourceTree, manifest: Manifest,
                    defaults: dict | None = None) -> list[Finding]:
    defaults = _default_settings() if defaults is None else defaults
    attrs: set[str] = set()
    consts: set[str] = set()
    for mod in tree.all_names():
        if mod == manifest.config_module:
            continue
        attrs |= attribute_names(tree.tree(mod))
        consts |= string_constants(tree.tree(mod))
    html = _html_text(tree)
    findings = []
    for key in sorted(defaults):
        env = "TVT_" + key.upper()
        if key in attrs or key in consts or env in consts:
            continue
        # substring matches keep the original grep-guard semantics:
        # `max_active_jobs` is read through the canonical
        # `effective_max_active_jobs()` helper, and f-strings mention
        # keys in fragments
        if any(key in a for a in attrs) or any(key in c for c in consts):
            continue
        if key in html or env in html:
            continue
        findings.append(finding(
            "TVT-C001", manifest.config_module, 0,
            f"settings key `{key}` has no reader outside "
            f"core/config.py — delete it or wire it up",
            key_detail=key))
    return findings


def _env_literals(tree: ast.Module):
    """(name, line) for every literal env read/write: os.environ.get,
    os.environ[...], os.getenv, os.environ.setdefault/pop."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = None
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in ("get", "getenv", "setdefault", "pop"):
                root = f.value
                is_env = (isinstance(root, ast.Attribute)
                          and root.attr == "environ") or \
                    (isinstance(root, ast.Name) and root.id == "os"
                     and f.attr == "getenv")
                if is_env and node.args and \
                        isinstance(node.args[0], ast.Constant) and \
                        isinstance(node.args[0].value, str):
                    name = node.args[0].value
            if name:
                yield name, node.lineno
        elif isinstance(node, ast.Subscript):
            v = node.value
            if isinstance(v, ast.Attribute) and v.attr == "environ" and \
                    isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str):
                yield node.slice.value, node.lineno


def check_env_knobs(tree: SourceTree, manifest: Manifest,
                    defaults: dict | None = None) -> list[Finding]:
    defaults = _default_settings() if defaults is None else defaults
    registered = {"TVT_" + k.upper() for k in defaults}
    registered |= set(manifest.process_env)
    findings = []
    for mod in tree.modules():
        if mod == manifest.config_module:
            continue        # constructs TVT_<key> names dynamically
        for name, line in _env_literals(tree.tree(mod)):
            if name.startswith("TVT_"):
                if name not in registered:
                    findings.append(finding(
                        "TVT-C002", mod, line,
                        f"unregistered env knob `{name}` — add the "
                        f"settings key or declare it in the "
                        f"manifest's process_env",
                        key_detail=name))
            elif not name.startswith(
                    tuple(manifest.foreign_env_prefixes)):
                findings.append(finding(
                    "TVT-C002", mod, line,
                    f"env knob `{name}` outside the TVT_* namespace",
                    key_detail=name))
    uniq: dict[str, Finding] = {}
    for f in findings:
        uniq.setdefault(f.key, f)
    return list(uniq.values())


def check_raw_access(tree: SourceTree, manifest: Manifest
                     ) -> list[Finding]:
    findings = []
    for mod in tree.modules():
        if mod == manifest.config_module:
            continue
        for node in ast.walk(tree.tree(mod)):
            if not isinstance(node, ast.Subscript):
                continue
            v = node.value
            if isinstance(v, ast.Name) and v.id == "DEFAULT_SETTINGS":
                findings.append(finding(
                    "TVT-C003", mod, node.lineno,
                    "raw DEFAULT_SETTINGS[...] access bypasses the "
                    "coerce/clamp tier — read a settings snapshot",
                    key_detail=f"{mod}:DEFAULT_SETTINGS"))
            elif isinstance(v, ast.Attribute) and v.attr == "values":
                base = v.value
                if isinstance(base, ast.Name) and (
                        "settings" in base.id or "snap" in base.id
                        or base.id in ("s", "cfg")):
                    findings.append(finding(
                        "TVT-C003", mod, node.lineno,
                        f"raw `{base.id}.values[...]` access bypasses "
                        f"the canonical attribute/.get read path",
                        key_detail=f"{mod}:{base.id}.values"))
    return findings


def run(tree: SourceTree, manifest: Manifest,
        defaults: dict | None = None) -> list[Finding]:
    return check_dead_keys(tree, manifest, defaults) \
        + check_env_knobs(tree, manifest, defaults) \
        + check_raw_access(tree, manifest)
