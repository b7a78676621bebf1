"""Cluster control plane: job store, admission policy, coordinator (a
copy of the reference package's), and the executor that runs jobs on
the card.

An in-process coordinator: the "fleet" is a set of executors (card
owners) instead of thin clients, the job store is typed, and dispatch
hands GOP-wave work to executors. The concurrency semantics —
capacity-gated admission with drain ratios, run-token fencing,
heartbeat watchdogs, part-level retries — are the reference's
(SURVEY.md §2.3, §5.3).
"""

from .jobs import Job, JobStore
from .policy import PolicyDecision, evaluate_job_policy
from .coordinator import Coordinator, WorkerRegistry

__all__ = [
    "Coordinator",
    "Job",
    "JobStore",
    "PolicyDecision",
    "WorkerRegistry",
    "evaluate_job_policy",
]

# NOTE: the executor (LocalExecutor, run_live) lives in .executor and is
# imported by its users — importing it here would pull torch and the
# encoder into every control-plane import (the API, the agent, the
# watcher).
