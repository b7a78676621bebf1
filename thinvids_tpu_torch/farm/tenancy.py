"""Tenant labels and fair-share weights: the part of the reference's
farm/tenancy.py that the settings layer's ``tenant`` and
``tenant_shares`` clamps call (the same functions, line for line). The
fair-share scheduler itself is not ported yet.
"""

from __future__ import annotations

import re

#: the shared namespace jobs land in when nothing names a tenant
DEFAULT_TENANT = "default"

_CLEAN_RE = re.compile(r"[^a-z0-9_-]+")


def clean_tenant(raw: object) -> str:
    """Sanitize a tenant label: lowercase, [a-z0-9_-], max 32 chars;
    empty/invalid input falls back to the default namespace. Shared by
    the config clamp and the name parser so every surface agrees."""
    text = _CLEAN_RE.sub("", str(raw or "").strip().lower())[:32]
    return text or DEFAULT_TENANT


def parse_tenant_shares(spec: object) -> dict[str, float]:
    """``"acme:3,bravo:1"`` → {"acme": 3.0, "bravo": 1.0}. Bad entries
    are dropped; non-positive weights are floored at a tiny positive
    value (a zero share would make the usage ratio infinite and
    starve the tenant outright, which is an operator error, not a
    scheduling mode)."""
    shares: dict[str, float] = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, weight = part.partition(":")
        tenant = clean_tenant(name)
        try:
            w = float(weight) if weight else 1.0
        except ValueError:
            continue
        shares[tenant] = max(0.001, w)
    return shares


def render_tenant_shares(spec: object) -> str:
    """Canonical re-render for the config clamp (stable ordering, so
    the settings surface shows exactly what the scheduler parses)."""
    shares = parse_tenant_shares(spec)
    return ",".join(f"{t}:{shares[t]:g}" for t in sorted(shares))
