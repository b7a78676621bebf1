"""Tenant namespaces and weighted fair-share math.

A tenant is a job namespace: the ``tenant`` per-job setting when set,
else a ``<tenant>__<name>`` prefix on the input filename (the
watch-folder analog of the ``.ladder``/``.live`` stem-suffix
conventions — a drop named ``acme__clip.y4m`` belongs to tenant
``acme``), else the shared ``default`` namespace.

Fair share is weighted max-min over *current usage*: the
``tenant_shares`` setting (``"acme:3,bravo:1"``) assigns weights
(unlisted tenants weigh 1), and both admission points — the
coordinator's dispatch pass and the ShardBoard's claim — pick, within
a QoS priority class, the candidate whose tenant has the LOWEST
usage÷share ratio right now. One tenant flooding the queue therefore
cannot starve the farm: its backlog only competes for its own share,
and an idle tenant's first job always wins the next slot.

torch- and jax-free by contract (imported by cluster/ control-plane
modules).
"""

from __future__ import annotations

import os
import re
from typing import Mapping

#: the shared namespace jobs land in when nothing names a tenant
DEFAULT_TENANT = "default"

#: filename convention: ``<tenant>__<rest>`` (double underscore so
#: ordinary single-underscore names never grow a surprise tenant)
_NAME_RE = re.compile(r"^(?P<tenant>[a-z0-9][a-z0-9_-]{0,31})__(?=.)")

_CLEAN_RE = re.compile(r"[^a-z0-9_-]+")


def clean_tenant(raw: object) -> str:
    """Sanitize a tenant label: lowercase, [a-z0-9_-], max 32 chars;
    empty/invalid input falls back to the default namespace. Shared by
    the config clamp and the name parser so every surface agrees."""
    text = _CLEAN_RE.sub("", str(raw or "").strip().lower())[:32]
    return text or DEFAULT_TENANT


def tenant_of(input_path: str, explicit: object = None) -> str:
    """Resolve a job's tenant: explicit (per-job ``tenant`` setting)
    wins, else the ``<tenant>__name`` filename prefix, else default."""
    if explicit:
        return clean_tenant(explicit)
    stem = os.path.splitext(os.path.basename(input_path or ""))[0].lower()
    m = _NAME_RE.match(stem)
    if m:
        return clean_tenant(m.group("tenant"))
    return DEFAULT_TENANT


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


def share_of(shares: Mapping[str, float], tenant: str) -> float:
    return float(shares.get(tenant, 1.0))


def fair_usage(shares: Mapping[str, float],
               usage: Mapping[str, float], tenant: str) -> float:
    """The scheduling key: current usage normalized by the tenant's
    weight. Lower = more underserved = next in line."""
    return float(usage.get(tenant, 0.0)) / share_of(shares, tenant)
