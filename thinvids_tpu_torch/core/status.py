"""Job lifecycle states.

Capability port of the reference's string-backed ``Status`` enum:
READY, STARTING, WAITING, RUNNING,
STAMPING, STOPPED, FAILED, REJECTED, DONE. ``parse`` accepts any case /
surrounding whitespace but, like the reference, raises on unknown values —
a corrupted persisted status must never silently become schedulable again.
Callers that want a fallback pass ``default=`` explicitly.
"""

from __future__ import annotations

import enum


class Status(str, enum.Enum):
    READY = "ready"        # registered, not queued
    WAITING = "waiting"    # queued for dispatch
    STARTING = "starting"  # reserved by scheduler, warmup in progress
    RUNNING = "running"    # encode pipeline active
    STAMPING = "stamping"  # verification (watermark) encode active
    STOPPED = "stopped"    # operator stop
    FAILED = "failed"      # watchdog / retry-budget failure
    REJECTED = "rejected"  # admission policy rejection
    DONE = "done"          # output committed to library

    @classmethod
    def parse(cls, value: object, default: "Status | None" = None) -> "Status":
        if isinstance(value, Status):
            return value
        if value is not None:
            text = str(value).strip().lower()
            for member in cls:
                if member.value == text or member.name.lower() == text:
                    return member
        if default is None:
            raise ValueError(f"unknown status: {value!r}")
        return default

    @property
    def is_active(self) -> bool:
        """True while the job occupies pipeline capacity."""
        return self in (Status.STARTING, Status.RUNNING, Status.STAMPING)

    @property
    def is_terminal(self) -> bool:
        return self in (Status.STOPPED, Status.FAILED, Status.REJECTED, Status.DONE)


class ShardState(str, enum.Enum):
    """Lifecycle of one remote encode shard (cluster/remote.py): a
    contiguous GOP range dispatched to a worker daemon. PENDING shards
    sit on the board; ASSIGNED shards are leased to one worker under a
    deadline; DONE shards hold their encoded segments until the job
    stitches; FAILED is terminal (retry budget exhausted)."""

    PENDING = "pending"
    ASSIGNED = "assigned"
    DONE = "done"
    FAILED = "failed"

    @property
    def is_open(self) -> bool:
        """True while the shard still needs a worker."""
        return self in (ShardState.PENDING, ShardState.ASSIGNED)
