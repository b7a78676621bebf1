"""Elastic multi-tenant farm (torch- and jax-free; a copy of the
reference package's).

The operations layer composed from the primitives the earlier PRs
shipped: a CapacityController that scales the worker farm with demand
(wake / graceful-drain / suspend through a pluggable provider seam),
the worker lifecycle as a declared, model-checked state machine, and
tenant namespaces with weighted fair-share admission layered on the
QoS priority classes. See README "Elastic farm".
"""

from .controller import CapacityController
from .lifecycle import WorkerState
from .provider import (CallableProvider, NullProvider,
                       SubprocessProvider)
from .tenancy import (DEFAULT_TENANT, clean_tenant, fair_usage,
                      parse_tenant_shares, render_tenant_shares,
                      share_of, tenant_of)

__all__ = [
    "CapacityController",
    "WorkerState",
    "CallableProvider",
    "NullProvider",
    "SubprocessProvider",
    "DEFAULT_TENANT",
    "clean_tenant",
    "fair_usage",
    "parse_tenant_shares",
    "render_tenant_shares",
    "share_of",
    "tenant_of",
]
