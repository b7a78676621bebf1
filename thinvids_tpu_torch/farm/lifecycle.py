"""Worker lifecycle states for the elastic farm.

The reference farm breathes: agents suspend idle Wyse nodes and the
manager wakes them with WoL magic packets (SURVEY §L6). The repro's
analog is an explicit, model-checked state machine driven by the
capacity controller (farm/controller.py):

    ACTIVE ──drain──▶ DRAINING ──leases empty──▶ SUSPENDED
      ▲                  │                          │
      │◀────undrain──────┘                        wake
      │                                             ▼
      └───────heartbeat / claim────────────────  WAKING

A DRAINING worker finishes its in-flight shards but stops claiming
(``ShardBoard.claim`` consults the controller); its suspend fires only
once its lease set is empty. A WAKING worker becomes ACTIVE the moment
it proves itself up (a heartbeat or a claim); a wake that never lands
falls back to SUSPENDED so the controller can retry. A SUSPENDED host
that heartbeats on its own (operator-started) rejoins directly.

The transition table is DECLARED in analysis/manifest.py
(``WORKER_MACHINE``) — every ``lifecycle`` write site is audited
(TVT-M001) and the bounded explorer model-checks the protocol against
the shard board (TVT-M002: no shard is ever assigned to a
DRAINING/SUSPENDED worker, and drain never strands a lease).

torch- and jax-free by contract: the whole farm/ package runs on coordinator
control-plane threads.
"""

from __future__ import annotations

import enum


class WorkerState(str, enum.Enum):
    ACTIVE = "active"        # claim-capable, counted as farm capacity
    DRAINING = "draining"    # finishing in-flight shards; claims refused
    SUSPENDED = "suspended"  # powered down / scaled to zero
    WAKING = "waking"        # wake fired; waiting for the first heartbeat

    @property
    def may_claim(self) -> bool:
        """True for the one state the ShardBoard may lease work to.
        (WAKING workers are promoted to ACTIVE by the claim itself —
        a claim is proof the worker is up.)"""
        return self is WorkerState.ACTIVE

    @property
    def is_on(self) -> bool:
        """True while the host consumes power/worker-seconds (the
        ``farm_active_worker_s`` accounting input): everything except
        SUSPENDED."""
        return self is not WorkerState.SUSPENDED
