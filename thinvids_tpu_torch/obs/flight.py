"""Postmortem flight recorder.

When something goes wrong on the farm — a job fails, a worker is
quarantined mid-job, the QoS controller preempts batch work for a
breached live deadline — the operator's first question is "what was
the job doing?". Scraping logs answers it slowly and lossily; this
module dumps the answer as an artifact instead: the job's recent spans
(the trace ring), its last recorded errors, and the settings snapshot
in effect, written as ``<job>.trace.json`` next to the output tree.
The file is itself a valid Chrome trace-event JSON object (spans under
``traceEvents``, the postmortem context under ``otherData``), so the
same Perfetto drag-and-drop that opens ``GET /trace/<job>`` opens the
black box.

Gated by the `flight_record` setting (TVT_FLIGHT_RECORD; default on).
The executor configures the dump directory at construction
(:func:`configure`); triggers live where the facts are known:

- job failure → ``Coordinator._fail``
- worker quarantine → ``ShardBoard.report_failure``
- QoS deadline breach → ``Coordinator.note_live_part``

Best-effort by design: a failed dump logs a warning and never turns a
postmortem into a second failure. torch- and jax-free by contract.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Mapping

from ..core.config import as_bool, get_settings
from ..core.log import get_logging
from .trace import TRACE

_LOG = get_logging(__name__)

_LOCK = threading.Lock()
_DIR: str = ""


def configure(directory: str) -> None:
    """Set the process's flight-record dump directory (the executor's
    output tree). Idempotent; last caller wins."""
    global _DIR
    with _LOCK:
        _DIR = str(directory or "")


def configured_dir() -> str:
    with _LOCK:
        return _DIR


def record(job_id: str, reason: str, out_dir: str | None = None,
           settings: Mapping[str, Any] | None = None,
           tenant: str = "") -> str | None:
    """Dump the job's flight record. Returns the artifact path, or
    None when disabled, unconfigured, or nothing was ever traced.
    `tenant` rides next to the settings snapshot so a multi-tenant
    postmortem attributes the incident without a store lookup."""
    snap = get_settings()
    if not as_bool(snap.get("flight_record", True), True):
        return None
    out_dir = out_dir or configured_dir()
    if not out_dir:
        return None
    # include_unsampled: a job sampled out of tracing still has its
    # error ring + settings — the postmortem's most valuable parts —
    # so the artifact dumps with empty traceEvents rather than not at
    # all (flight_record is an independent gate from trace_sample)
    export = TRACE.export_chrome(job_id, include_unsampled=True)
    if export is None:
        return None
    doc = dict(export)
    other = dict(doc.get("otherData") or {})
    other["reason"] = str(reason)
    other["recorded_at"] = time.time()
    if tenant:
        other["tenant"] = str(tenant)
    if settings is not None:
        # Settings snapshots carry their mapping as `.values` (a
        # FIELD); on a plain dict that name is the bound values()
        # METHOD — use the dict itself then
        values = getattr(settings, "values", None)
        if values is None or callable(values):
            values = settings
        other["settings"] = {k: v for k, v in dict(values).items()}
    doc["otherData"] = other
    path = os.path.join(out_dir, f"{job_id}.trace.json")
    tmp = f"{path}.tmp"
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as fp:
            json.dump(doc, fp, default=str)
        os.replace(tmp, path)
    except OSError as exc:
        # postmortem capture must never become a second failure
        _LOG.warning("flight record for job %s not written (%s: %s)",
                     job_id, type(exc).__name__, exc)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    _LOG.info("flight record: %s (%s)", path, reason)
    return path
