"""Logging setup.

Port of the reference's idempotent shared logger:
one root configuration, format with
hostname + pid, ``TVT_LOG_LEVEL`` env override (legacy ``LOG_LEVEL``
still honored), noisy third-party loggers quieted.

``TVT_LOG_FORMAT=json`` switches every line to one structured JSON
object (ts/level/logger/host/pid/msg, plus the active job and trace id
when the emitting thread runs inside a traced job — obs/trace.bind),
so farm logs can be machine-joined against ``GET /trace/<job>``
exports instead of regex-scraped.
"""

from __future__ import annotations

import logging
import os
import socket

_CONFIGURED = False
_FORMAT = (
    "%(asctime)s %(levelname)s {host} %(name)s [%(process)d] TVT %(message)s"
)

_QUIET = ("urllib3", "watchdog", "jax._src", "absl")


class JsonFormatter(logging.Formatter):
    """One JSON object per line, stamped with the thread's ambient
    (job_id, trace_id) when obs/trace.bind is active — the join key
    between farm logs and the job's distributed trace."""

    def __init__(self, host: str) -> None:
        super().__init__()
        self._host = host

    def format(self, record: logging.LogRecord) -> str:
        import json

        doc = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "host": self._host,
            "pid": record.process,
            "thread": record.threadName,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        try:
            # lazy: core/log must stay importable before (and without)
            # the obs package — e.g. from config-less tooling
            from ..obs.trace import current_ids

            ids = current_ids()
        except Exception:   # noqa: BLE001 - never fail a log line
            ids = None
        if ids is not None:
            doc["job_id"], doc["trace_id"] = ids
        return json.dumps(doc, default=str)


def _make_formatter(host: str) -> logging.Formatter:
    """The formatter TVT_LOG_FORMAT selects: "json" = structured
    one-object-per-line, anything else = the human text format."""
    if os.environ.get("TVT_LOG_FORMAT", "").strip().lower() == "json":
        return JsonFormatter(host)
    return logging.Formatter(_FORMAT.format(host=host))


def get_logging(name: str = "thinvids_tpu_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        # TVT_LOG_LEVEL is the registered knob (analysis/manifest.py);
        # bare LOG_LEVEL survives as a reference-compat fallback
        # (waived in the manifest)
        level_name = os.environ.get(
            "TVT_LOG_LEVEL", os.environ.get("LOG_LEVEL", "INFO")).upper()
        level = getattr(logging, level_name, logging.INFO)
        handler = logging.StreamHandler()
        handler.setFormatter(_make_formatter(socket.gethostname()))
        root = logging.getLogger()
        root.setLevel(level)
        # Idempotent: only attach our handler if a TVT handler is absent.
        if not any(getattr(h, "_tvt", False) for h in root.handlers):
            handler._tvt = True  # type: ignore[attr-defined]
            root.addHandler(handler)
        for quiet in _QUIET:
            logging.getLogger(quiet).setLevel(logging.WARNING)
        _CONFIGURED = True
    return logging.getLogger(name)
