"""Stdlib HTTP JSON API over the coordinator.

Route surface ported from the reference manager:

    GET  /health                        liveness probe
    GET  /jobs                          list + filter/sort/paginate (:1919-2096)
    POST /add_job                       probe + register (+auto queue) (:2222-2400)
    POST /start_job/<id>                queue + dispatch (:2402-2460)
    POST /stop_job/<id>                 stop + fence (:2673-2700)
    POST /restart_job/<id>              wipe + requeue (:2501-2666)
    DELETE /delete_job/<id>             remove (:2702-2718)
    GET  /job_properties/<id>           job fields + activity tail (:2720-2744)
    GET/POST /job_settings/<id>         per-job overrides, blocked while
                                        RUNNING (:2746-2812)
    GET  /activity                      global activity feed (:2098-2108)
    GET  /job_activity/<id>             per-job log lines (:2110-2117)
    GET  /nodes_data                    worker registry view (:2836-2885)
    POST /nodes/disable/<host>          quarantine (:2856-2885)
    POST /nodes/enable/<host>
    DELETE /nodes/delete/<host>
    GET  /metrics_snapshot              per-worker metrics (:1701-1748)
    GET/POST /settings                  live cluster settings with
                                        validation/clamping (:1750-1916)

Bodies and responses are JSON. Unknown paths → 404 {"error": ...};
handler exceptions → 400/500 with the message.

A copy of the reference package's server, with one change:
``/metrics_snapshot`` reads the stage totals and the SFE latency ring
from the port's ``parallel.dispatch``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import parse_qs, urlparse

from ..core.config import as_bool, update_live_settings
from ..core.status import ShardState, Status
from ..cluster.coordinator import Coordinator
from ..cluster.jobs import Job
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace


class ApiError(Exception):
    def __init__(self, status: int, message: str,
                 headers: dict[str, str] | None = None) -> None:
        super().__init__(message)
        self.status = status
        self.message = message
        #: extra response headers (e.g. Retry-After on a 503)
        self.headers = dict(headers or {})


def _job_view(job: Job, cluster_priority: str = "auto") -> dict[str, Any]:
    from ..cluster.qos import job_class

    d = job.to_dict()
    # QoS class the scheduler/board will treat the job as (the
    # dashboard surfaces it next to the job type) — resolved the same
    # way Coordinator._job_rank does: per-job override first, then the
    # cluster-wide `job_priority` setting
    d["priority"] = job_class(
        getattr(job, "job_type", "transcode"),
        str(job.settings.get("job_priority", cluster_priority) or "auto"))
    return d


# Scalar, orderable Job fields (sorting by meta/settings or mixing types
# would TypeError inside list.sort); `status` sorts by its string value.
# Annotations are strings under `from __future__ import annotations`, so
# match the annotation text.
_SORTABLE = {f.name for f in dataclasses.fields(Job)
             if str(f.type) in ("str", "int", "float")} | {"status"}


def _restore_after_stamp(co, job_id: str, prior_status: Status) -> None:
    """Put a stamped job's status back — ONLY if it is still STAMPING.
    An operator stop (or delete) landing while the stamp thread runs
    must win: restoring unconditionally would resurrect a STOPPED job
    into the scheduler (the same stop-wins property the coordinator's
    reserve guard enforces). Declared in the job machine's table as
    STAMPING→{prior} (analysis/manifest.py)."""
    def apply(j: Job) -> None:
        if j.status is Status.STAMPING:
            j.status = prior_status
    try:
        co.store.update(job_id, apply)
    except KeyError:
        pass                    # job deleted mid-stamp: nothing to do


class _FileResponse:
    """Handler payload sentinel: serve a file instead of JSON (the
    reference's send_file preview, manager/app.py:2402-2460).
    `headers` are extra response headers (Cache-Control for the HLS
    routes — a CDN in front of the origin keys on these). `plan` is
    the resolved origin serve plan (origin/serve.py: status 200/206/
    304/416, ETag + range headers, and either an in-memory body from
    the hot-segment cache or a disk window to stream); when None the
    file streams whole with a plain 200 (legacy callers)."""

    def __init__(self, path: str, content_type: str,
                 headers: dict[str, str] | None = None,
                 plan=None) -> None:
        self.path = path
        self.content_type = content_type
        self.headers = dict(headers or {})
        self.plan = plan


class _TextResponse:
    """Handler payload sentinel: serve a plain-text body (the
    Prometheus exposition at GET /metrics)."""

    def __init__(self, text: "str | bytes",
                 content_type: str = "text/plain") -> None:
        self.body = text if isinstance(text, bytes) \
            else text.encode("utf-8")
        self.content_type = content_type


class ApiServer:
    """Threaded HTTP server bound to a Coordinator instance.

    `browse_roots` maps root names → directories for /browse/list (the
    reference browsed its watch + source_media NFS mounts,
    manager/app.py:1583-1642).
    """

    def __init__(self, coordinator: Coordinator, host: str = "127.0.0.1",
                 port: int = 0,
                 browse_roots: dict[str, str] | None = None,
                 work=None) -> None:
        from ..origin.serve import Origin

        self.coordinator = coordinator
        self.browse_roots = dict(browse_roots or {})
        #: optional ShardBoard (cluster/remote.py): when attached, the
        #: /work/* routes serve the worker-daemon pull API and
        #: /metrics_snapshot carries the farm's shard stats
        self.work = work
        #: origin serving state (origin/): hot-segment cache, request
        #: counters, per-job session gauges, bounded reload waiters
        self.origin = Origin(coordinator._settings_fn)
        #: serializes the scrape-time gauge refresh in /metrics: two
        #: concurrent scrapes racing clear()-then-repopulate would
        #: render doubled or partial gauge values
        self._scrape_lock = threading.Lock()
        #: chaos-harness fault injection (tools/loadgen.py --chaos):
        #: while the monotonic clock is before this stamp, every
        #: /work/* route answers 503 — the "partitioned /work routes"
        #: failure the autoscale bench drives. Guarded by its own lock
        #: (written by the chaos thread, read by every handler thread).
        self._fault_lock = threading.Lock()
        self._work_partition_until = 0.0
        #: chaos: bit-flip the next N /work/part upload bodies before
        #: unpack (the in-flight corruption the crash/corruption bench
        #: tier injects — every flip must surface as a digest
        #: rejection, never as corrupt stitched bytes)
        self._corrupt_parts_left = 0
        api = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: a player session holds ONE server
            # thread for its whole visit instead of one thread (and a
            # TCP handshake) per request — every reply path sets
            # Content-Length, which keep-alive requires. Idle
            # connections are reaped by the socket timeout.
            protocol_version = "HTTP/1.1"
            timeout = 60
            # TCP_NODELAY: the farm-SFE halo relay exchanges several
            # SMALL request/response pairs per encoded frame, and
            # Nagle+delayed-ACK stalls (~40 ms each) would dominate
            # the per-frame budget; origin segment replies are bulk
            # writes where Nagle buys nothing anyway
            disable_nagle_algorithm = True

            # quiet request logging (the reference silenced werkzeug,
            # common.py:151-161)
            def log_message(self, *args: Any) -> None:
                pass

            def _reply(self, status: int, payload: Any,
                       headers: dict[str, str] | None = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def _body(self) -> dict[str, Any]:
                length = int(self.headers.get("Content-Length") or 0)
                if not length:
                    return {}
                raw = self.rfile.read(length)
                ctype = self.headers.get("Content-Type") or ""
                if "application/octet-stream" in ctype:
                    # binary upload (worker part streams): hand the raw
                    # bytes through under a reserved key
                    return {"_raw": raw}
                try:
                    data = json.loads(raw)
                except json.JSONDecodeError as exc:
                    raise ApiError(400, f"invalid JSON body: {exc}")
                if not isinstance(data, dict):
                    raise ApiError(400, "JSON body must be an object")
                return data

            def _reply_html(self, content: bytes) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(content)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(content)

            def _reply_text(self, tr: "_TextResponse") -> None:
                self.send_response(200)
                self.send_header("Content-Type", tr.content_type)
                self.send_header("Content-Length", str(len(tr.body)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(tr.body)

            def _reply_file(self, fr: _FileResponse) -> None:
                plan = fr.plan
                head = self.command == "HEAD"
                if plan is not None and plan.body is not None:
                    # resolved in-memory body (hot-cache hit, 304, 416)
                    self.send_response(plan.status)
                    self.send_header("Content-Type", fr.content_type)
                    if plan.status != 304:
                        self.send_header("Content-Length",
                                         str(plan.length))
                    for hdrs in (fr.headers, plan.headers):
                        for key, value in hdrs.items():
                            self.send_header(key, value)
                    self.end_headers()
                    if not head and plan.status not in (304, 416):
                        try:
                            self.wfile.write(plan.body)
                        except OSError:
                            # partial write: the byte stream is short of
                            # its declared Content-Length, so the
                            # keep-alive connection is unusable
                            self.close_connection = True
                    return
                # stream a (possibly ranged) disk window in chunks —
                # open BEFORE sending headers: a vanished file must
                # 404, not corrupt an already-started 200 stream
                fp = open(fr.path, "rb")
                try:
                    if plan is not None:
                        status, offset = plan.status, plan.offset
                        length = plan.length
                        extra = plan.headers
                    else:
                        status, offset, extra = 200, 0, {}
                        length = os.fstat(fp.fileno()).st_size
                    self.send_response(status)
                    self.send_header("Content-Type", fr.content_type)
                    self.send_header("Content-Length", str(length))
                    for hdrs in (fr.headers, extra):
                        for key, value in hdrs.items():
                            self.send_header(key, value)
                    self.end_headers()
                    if head:
                        return
                    fp.seek(offset)
                    left = length
                    try:
                        while left > 0:
                            chunk = fp.read(min(1 << 20, left))
                            if not chunk:
                                break
                            left -= len(chunk)
                            self.wfile.write(chunk)
                        if left > 0:
                            # file shrank under us: the byte stream is
                            # short of its declared Content-Length, so
                            # the keep-alive connection is unusable
                            self.close_connection = True
                    except OSError:
                        self.close_connection = True
                        return          # client went away mid-stream;
                                        # never append a second response
                finally:
                    fp.close()

            def _dispatch(self, method: str) -> None:
                url = urlparse(self.path)
                query = {k: v[-1] for k, v in parse_qs(url.query).items()}
                # origin segment serve-time histogram: the whole /hls
                # request, plan through last body byte (includes any
                # blocking-reload hold — that IS the player's wait)
                is_hls = url.path.startswith("/hls/")
                t0 = time.perf_counter() if is_hls else 0.0
                try:
                    if method == "GET" and url.path in ("/", "/ui"):
                        from .. import ui

                        self._reply_html(ui.index_html())
                        return
                    body = self._body() if method in ("POST", "PUT") else {}
                    # request context for the origin routes: conditional
                    # / range headers + the client's session identity
                    ctx = {
                        "method": self.command,
                        "headers": self.headers,
                        "client": "%s:%s" % self.client_address[:2],
                    }
                    status, payload = api.route(method, url.path, query,
                                                body, ctx=ctx)
                    if isinstance(payload, _FileResponse):
                        try:
                            self._reply_file(payload)
                        except OSError:
                            self._reply(404, {"error": "file unavailable"})
                        return
                    if isinstance(payload, _TextResponse):
                        self._reply_text(payload)
                        return
                    self._reply(status, payload)
                except ApiError as exc:
                    self._reply(exc.status, {"error": exc.message},
                                headers=exc.headers)
                except (KeyError, ValueError) as exc:
                    self._reply(400, {"error": str(exc)})
                except Exception as exc:    # noqa: BLE001 - surface, don't die
                    self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
                finally:
                    if is_hls:
                        obs_metrics.ORIGIN_SERVE_SECONDS.observe(
                            time.perf_counter() - t0)

            def do_GET(self) -> None:
                self._dispatch("GET")

            def do_HEAD(self) -> None:
                # HEAD dispatches as GET (self.command stays "HEAD", so
                # replies send headers — incl. Content-Length — without
                # a body): players and CDNs probe /hls and /result
                # resources without downloading them
                self._dispatch("GET")

            def do_POST(self) -> None:
                self._dispatch("POST")

            def do_PUT(self) -> None:
                self._dispatch("PUT")

            def do_DELETE(self) -> None:
                self._dispatch("DELETE")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ApiServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="tvt-api")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5)

    # -- routing -------------------------------------------------------

    _ROUTES = [
        ("GET", r"^/health$", "health"),
        ("GET", r"^/jobs$", "jobs"),
        ("POST", r"^/add_job$", "add_job"),
        ("POST", r"^/start_job/(?P<job_id>[\w-]+)$", "start_job"),
        ("POST", r"^/stop_job/(?P<job_id>[\w-]+)$", "stop_job"),
        ("POST", r"^/restart_job/(?P<job_id>[\w-]+)$", "restart_job"),
        ("DELETE", r"^/delete_job/(?P<job_id>[\w-]+)$", "delete_job"),
        ("GET", r"^/job_properties/(?P<job_id>[\w-]+)$", "job_properties"),
        ("GET", r"^/job_settings/(?P<job_id>[\w-]+)$", "get_job_settings"),
        ("POST", r"^/job_settings/(?P<job_id>[\w-]+)$", "post_job_settings"),
        ("GET", r"^/activity$", "activity"),
        ("GET", r"^/job_activity/(?P<job_id>[\w-]+)$", "job_activity"),
        ("GET", r"^/nodes_data$", "nodes_data"),
        ("POST", r"^/node_heartbeat$", "node_heartbeat"),
        ("POST", r"^/nodes/disable/(?P<host>[\w.-]+)$", "node_disable"),
        ("POST", r"^/nodes/enable/(?P<host>[\w.-]+)$", "node_enable"),
        ("DELETE", r"^/nodes/delete/(?P<host>[\w.-]+)$", "node_delete"),
        ("GET", r"^/metrics_snapshot$", "metrics_snapshot"),
        ("GET", r"^/metrics$", "metrics"),
        ("GET", r"^/trace/(?P<job_id>[\w-]+)$", "trace"),
        ("POST", r"^/work/claim$", "work_claim"),
        ("POST", r"^/work/part/(?P<shard_id>[\w:-]+)$", "work_part"),
        ("POST", r"^/work/spans$", "work_spans"),
        ("POST", r"^/work/status$", "work_status"),
        ("POST", r"^/work/halo$", "work_halo_post"),
        ("GET", r"^/work/halo$", "work_halo_get"),
        ("POST", r"^/work/chaos$", "work_chaos"),
        ("GET", r"^/work/board$", "work_board"),
        ("GET", r"^/settings$", "get_settings"),
        ("POST", r"^/settings$", "post_settings"),
        ("GET", r"^/browse/list$", "browse_list"),
        ("GET", r"^/preview/(?P<job_id>[\w-]+)$", "preview"),
        ("GET", r"^/result/(?P<job_id>[\w-]+)$", "result"),
        ("GET", r"^/hls/(?P<job_id>[\w-]+)/(?P<rel>.+)$", "hls"),
        ("POST", r"^/stamp_job/(?P<job_id>[\w-]+)$", "stamp_job"),
    ]

    #: handlers that take the request context (conditional/range
    #: headers, client identity) — the origin-served file routes plus
    #: the span upload (X-Tvt-Trace trace-context header)
    _CTX_ROUTES = frozenset({"hls", "preview", "result", "work_spans"})

    def route(self, method: str, path: str, query: dict[str, str],
              body: dict[str, Any],
              ctx: dict[str, Any] | None = None) -> tuple[int, Any]:
        for meth, pattern, name in self._ROUTES:
            if meth != method:
                continue
            m = re.match(pattern, path)
            if m:
                handler = getattr(self, f"_h_{name}")
                kwargs = dict(query=query, body=body, **m.groupdict())
                if name in self._CTX_ROUTES:
                    kwargs["ctx"] = ctx
                return handler(**kwargs)
        raise ApiError(404, f"no route {method} {path}")

    def _get_job(self, job_id: str) -> Job:
        job = self.coordinator.store.try_get(job_id)
        if job is None:
            raise ApiError(404, f"no job {job_id}")
        return job

    def _cluster_priority(self) -> str:
        return str(self.coordinator._settings_fn().get(
            "job_priority", "auto") or "auto")

    def _view(self, job: Job) -> dict[str, Any]:
        return _job_view(job, self._cluster_priority())

    # -- handlers ------------------------------------------------------

    def _h_health(self, query, body) -> tuple[int, Any]:
        return 200, {"ok": True, "jobs": len(self.coordinator.store)}

    def _h_jobs(self, query, body) -> tuple[int, Any]:
        """Filter/sort/paginate (reference GET /jobs,
        manager/app.py:1919-2096)."""
        jobs = self.coordinator.store.list()
        status = query.get("status")
        if status:
            want = Status.parse(status)
            jobs = [j for j in jobs if j.status is want]
        search = query.get("search", "").lower()
        if search:
            jobs = [j for j in jobs if search in j.input_path.lower()]
        sort = query.get("sort", "created_at")
        reverse = query.get("order", "desc") != "asc"
        if sort not in _SORTABLE:
            raise ApiError(400, f"unknown sort key {sort!r}")
        if sort == "status":
            key = lambda j: j.status.value               # noqa: E731
        else:
            key = lambda j: getattr(j, sort)             # noqa: E731
        jobs.sort(key=key, reverse=reverse)
        page = max(1, int(query.get("page", 1)))
        page_size = min(500, max(1, int(query.get("page_size", 50))))
        start = (page - 1) * page_size
        window = jobs[start:start + page_size]
        cluster = self._cluster_priority()
        return 200, {
            "jobs": [_job_view(j, cluster) for j in window],
            "total": len(jobs),
            "page": page,
            "page_size": page_size,
        }

    def _h_add_job(self, query, body) -> tuple[int, Any]:
        input_path = body.get("input_path")
        if not input_path:
            raise ApiError(400, "input_path is required")
        from ..ingest.probe import ProbeError, probe_video

        try:
            meta = probe_video(input_path)
        except ProbeError as exc:
            raise ApiError(422, str(exc))
        job_type = body.get("job_type")
        if job_type is not None and job_type not in ("transcode",
                                                     "ladder", "live"):
            raise ApiError(400, f"unknown job_type {job_type!r}")
        job = self.coordinator.add_job(
            input_path, meta, settings=body.get("settings"),
            auto_start=body.get("auto_start"), job_type=job_type)
        return 201, self._view(job)

    def _h_start_job(self, query, body, job_id) -> tuple[int, Any]:
        self._get_job(job_id)
        job = self.coordinator.queue_job(job_id)
        self.coordinator.dispatch_next_waiting_job()
        return 200, self._view(self.coordinator.store.get(job.id))

    def _h_stop_job(self, query, body, job_id) -> tuple[int, Any]:
        self._get_job(job_id)
        return 200, self._view(self.coordinator.stop_job(job_id))

    def _h_restart_job(self, query, body, job_id) -> tuple[int, Any]:
        self._get_job(job_id)
        return 200, self._view(self.coordinator.restart_job(job_id))

    def _h_delete_job(self, query, body, job_id) -> tuple[int, Any]:
        self._get_job(job_id)
        self.coordinator.delete_job(job_id)
        return 200, {"deleted": job_id}

    def _h_job_properties(self, query, body, job_id) -> tuple[int, Any]:
        job = self._get_job(job_id)
        lines = self.coordinator.activity.fetch_job(
            job_id, limit=int(query.get("limit", 100)))
        return 200, {"job": self._view(job), "activity": lines}

    def _h_get_job_settings(self, query, body, job_id) -> tuple[int, Any]:
        job = self._get_job(job_id)
        return 200, {"settings": dict(job.settings)}

    def _h_post_job_settings(self, query, body, job_id) -> tuple[int, Any]:
        job = self._get_job(job_id)
        if job.status.is_active:
            # reference blocks edits while RUNNING (app.py:2746-2812)
            raise ApiError(409, f"job is {job.status.value}; stop it first")

        # Validate at write time, exactly as the live-settings tier does
        # (config._validate_setting is shared by both) — a bad value
        # must 400 here, not explode later at dispatch inside
        # overlay_job_settings.
        from ..core import config as config_mod

        validated: dict[str, Any] = {}
        for key, raw in body.items():
            if key not in config_mod.JOB_SETTING_KEYS:
                raise ApiError(400, f"unknown job setting {key!r}")
            try:
                validated[key] = config_mod._validate_setting(key, raw)
            except (TypeError, ValueError) as exc:
                raise ApiError(400, f"bad value for {key!r}: {exc}")

        def apply(j: Job) -> None:
            j.settings = validated
        job = self.coordinator.store.update(job_id, apply)
        return 200, {"settings": dict(job.settings)}

    def _h_activity(self, query, body) -> tuple[int, Any]:
        limit = int(query.get("limit", 100))
        return 200, {"events": self.coordinator.activity.fetch(limit)}

    def _h_job_activity(self, query, body, job_id) -> tuple[int, Any]:
        limit = int(query.get("limit", 500))
        return 200, {"lines": self.coordinator.activity.fetch_job(
            job_id, limit)}

    def _h_nodes_data(self, query, body) -> tuple[int, Any]:
        snap = self.coordinator._settings_fn()
        ttl = float(snap.metrics_ttl_s)
        active = {w.host for w in self.coordinator.registry.active(ttl)}
        nodes = []
        for w in self.coordinator.registry.all():
            nodes.append({
                "host": w.host,
                "role": w.role,
                "last_seen": w.last_seen,
                "active": w.host in active,
                "disabled": w.disabled,
                "quarantine_reason": w.quarantine_reason,
            })
        nodes.sort(key=lambda n: n["host"])
        return 200, {"nodes": nodes}

    def _h_node_heartbeat(self, query, body) -> tuple[int, Any]:
        """Cross-host agent heartbeat sink (the reference's
        `HSET metrics:node:<host>` + EXPIRE, agent.py:417-436 — here
        the registry's TTL provides the liveness window)."""
        host = str(body.get("host", "")).strip()
        if not host:
            raise ApiError(400, "host required")
        metrics = body.get("metrics") or {}
        if not isinstance(metrics, dict):
            raise ApiError(400, "metrics must be an object")
        self.coordinator.registry.heartbeat(host, metrics=metrics)
        return 200, {"ok": True}

    def _h_node_disable(self, query, body, host) -> tuple[int, Any]:
        self.coordinator.registry.set_disabled(
            host, True, reason=body.get("reason", "operator"))
        return 200, {"host": host, "disabled": True}

    def _h_node_enable(self, query, body, host) -> tuple[int, Any]:
        self.coordinator.registry.set_disabled(host, False)
        return 200, {"host": host, "disabled": False}

    def _h_node_delete(self, query, body, host) -> tuple[int, Any]:
        if not self.coordinator.registry.delete(host):
            raise ApiError(404, f"no node {host}")
        return 200, {"deleted": host}

    def _h_browse_list(self, query, body) -> tuple[int, Any]:
        """Traversal-safe directory listing over the configured roots
        (reference /browse/list, manager/app.py:1583-1642)."""
        root_name = query.get("root", "")
        root = self.browse_roots.get(root_name)
        if root is None:
            raise ApiError(400, f"unknown browse root {root_name!r}; "
                                f"have {sorted(self.browse_roots)}")
        rel = query.get("path", "")
        base = os.path.realpath(root)
        target = os.path.realpath(os.path.join(base, rel))
        if target != base and not target.startswith(base + os.sep):
            raise ApiError(400, "path escapes the browse root")
        if not os.path.isdir(target):
            raise ApiError(404, f"no such directory {rel!r}")
        entries = []
        for name in sorted(os.listdir(target)):
            if name.startswith("."):
                continue
            p = os.path.join(target, name)
            try:
                is_dir = os.path.isdir(p)
                size = 0 if is_dir else os.path.getsize(p)
            except OSError:
                continue          # dangling symlink / deleted mid-scan:
                                  # one bad entry must not 500 the list
            entries.append({"name": name, "dir": is_dir, "size": size})
        rel_out = os.path.relpath(target, base)
        return 200, {"root": root_name,
                     "path": "" if rel_out == "." else rel_out,
                     "entries": entries}

    def _h_preview(self, query, body, job_id, ctx=None) -> tuple[int, Any]:
        """Stream a DONE job's output file (reference /preview/<id>).
        Supports HEAD and single-range requests (a seeking player
        probes, then range-reads) via the origin serve planner."""
        from ..origin.serve import plan_file

        job = self._get_job(job_id)
        if job.job_type in ("ladder", "live"):
            # these jobs' output_path is a playlist, not a previewable
            # MP4 — labelling it video/mp4 would hand players garbage
            raise ApiError(
                409,
                f"{job.job_type} job: tune to /hls/{job_id}/master.m3u8")
        if not job.output_path or not os.path.exists(job.output_path):
            raise ApiError(404, "job has no output file")
        ctx = ctx or {}
        try:
            # output MP4s are whole-job-sized: never through the hot
            # cache (cache=None), always chunk-streamed from disk
            plan = plan_file(job.output_path,
                             method=str(ctx.get("method", "GET")),
                             req_headers=ctx.get("headers"),
                             stats=self.origin.stats)
        except OSError:
            raise ApiError(404, "job has no output file")
        return 200, _FileResponse(job.output_path, "video/mp4",
                                  plan=plan)

    def _h_result(self, query, body, job_id, ctx=None) -> tuple[int, Any]:
        """Alias of /preview for tooling: download (or HEAD-probe) a
        job's result file."""
        return self._h_preview(query, body, job_id, ctx=ctx)

    #: content types the HLS route serves, by extension
    _HLS_TYPES = {
        ".m3u8": "application/vnd.apple.mpegurl",
        ".mp4": "video/mp4",
        ".m4s": "video/iso.segment",
    }

    def _h_hls(self, query, body, job_id, rel, ctx=None) -> tuple[int, Any]:
        """Serve a ladder/live job's HLS tree: master/media playlists,
        init segments, and fMP4 fragments — `/hls/<job>/master.m3u8`
        is what a player tunes to, and the playlists' relative URIs
        resolve naturally under the same prefix. Traversal-safe within
        the job's packaged output directory.

        Ladder (batch) jobs serve after completion; LIVE jobs serve
        the moment the executor publishes the tree (output
        availability is decoupled from job completion). Cache-Control
        is set for CDN fronting: live playlists are `no-cache` (they
        rewrite every part), finished-VOD playlists cache briefly, and
        segments/init are content-immutable once written. LL-HLS
        blocking playlist reload is supported on media playlists via
        the standard `_HLS_msn` / `_HLS_part` query params: the
        response is held until the playlist's live edge reaches the
        requested (msn, part) or the hold budget expires — with the
        concurrent waiters per job capped (`origin_max_waiters`;
        beyond the cap: 503 + Retry-After, so a dead stream cannot
        pin unbounded server threads).

        Segments and init boxes serve through the origin's in-memory
        hot cache (bounded LRU, single-flight fill) with strong
        ETags; `If-None-Match` revalidation → 304 and single-range
        requests → 206 on every resource. Playlists never cache —
        they rewrite in place every part."""
        from ..origin.serve import plan_file

        job = self._get_job(job_id)
        if job.job_type not in ("ladder", "live"):
            raise ApiError(404, f"job {job_id} is not an HLS job")
        if not job.output_path or not os.path.exists(job.output_path):
            raise ApiError(404, "job has no packaged HLS output"
                           + (" yet" if job.job_type == "live" else ""))
        root = os.path.realpath(os.path.dirname(job.output_path))
        target = os.path.realpath(os.path.join(root, rel))
        if target != root and not target.startswith(root + os.sep):
            raise ApiError(400, "path escapes the HLS root")
        ext = os.path.splitext(target)[1].lower()
        ctype = self._HLS_TYPES.get(ext)
        if ctype is None:
            raise ApiError(404, f"not an HLS resource: {rel}")
        ctx = ctx or {}
        req_headers = ctx.get("headers") or {}
        session = req_headers.get("X-Tvt-Session") \
            or ctx.get("client") or ""
        if session:
            self.origin.sessions.record(job_id, str(session))
        live_open = job.job_type == "live" \
            and job.status is not Status.DONE
        cacheable = False
        if ext == ".m3u8":
            if "_HLS_msn" in query:
                self._block_for_playlist_edge(target, query, live_open,
                                              job_id=job_id)
            # live playlists rewrite after every part — a cached copy
            # is stale within one part duration; finished VOD
            # playlists are stable but kept revalidatable
            headers = {"Cache-Control": "no-cache" if live_open
                       else "public, max-age=30"}
        else:
            # segments, parts and init are immutable once written
            # (new content always gets a NEW uri) — let a CDN keep
            # them for as long as it likes, and serve the hot set
            # from memory here
            headers = {"Cache-Control":
                       "public, max-age=31536000, immutable"}
            cacheable = True
        if not os.path.isfile(target):
            raise ApiError(404, f"no such HLS file {rel!r}")
        try:
            plan = plan_file(
                target, method=str(ctx.get("method", "GET")),
                req_headers=req_headers,
                cache=self.origin.cache if cacheable else None,
                stats=self.origin.stats)
        except OSError:
            raise ApiError(404, f"no such HLS file {rel!r}")
        return 200, _FileResponse(target, ctype, headers=headers,
                                  plan=plan)

    #: cap on one blocking playlist reload (seconds); the spec wants
    #: blocking requests answered as soon as the edge advances, and a
    #: dead stream must time out rather than pin the connection
    _BLOCK_RELOAD_MAX_S = 15.0

    def _block_for_playlist_edge(self, path: str, query: dict[str, str],
                                 live_open: bool,
                                 job_id: str = "") -> None:
        """LL-HLS blocking playlist reload (RFC 8216bis §6.2.5.2):
        hold the response until the media playlist contains media
        sequence number `_HLS_msn` (and, if given, part `_HLS_part` of
        it), the stream ends, or the hold budget expires — whichever
        comes first. Non-live playlists return immediately (their edge
        never moves).

        The hold rides the origin's shared edge watcher (one disk
        poller per playlist regardless of waiter count) and the
        per-job waiter cap: past `origin_max_waiters` the request is
        refused with 503 + Retry-After instead of pinning yet another
        server thread on a stream that may never advance."""
        try:
            want_msn = int(query["_HLS_msn"])
            raw_part = query.get("_HLS_part")
            # no _HLS_part = hold for the WHOLE segment with that MSN
            # (a -1 default would satisfy on the open segment's first
            # part and degrade blocking reload into a busy-poll)
            want_part = None if raw_part is None else int(raw_part)
        except (TypeError, ValueError):
            raise ApiError(400, "_HLS_msn/_HLS_part must be integers")
        if want_msn < 0 or not live_open:
            return
        origin = self.origin
        if not origin.gate.try_enter(job_id):
            origin.stats.bump("origin_503s")
            raise ApiError(
                503, "too many blocked playlist reloads for this job; "
                     "retry shortly",
                headers={"Retry-After": "1"})
        try:
            origin.watcher.wait_edge(path, want_msn, want_part,
                                     self._BLOCK_RELOAD_MAX_S)
        finally:
            origin.gate.leave(job_id)

    def _h_stamp_job(self, query, body, job_id) -> tuple[int, Any]:
        """Create a frame-index-watermarked copy of the job's source and
        register it as a NEW job (the reference's stamp verification
        task, worker/tasks.py:2314-2613 — there a drawtext re-encode,
        here the machine-decodable stamp the seam tests read back).
        The source job's own status is restored afterwards (stamping a
        DONE job must not erase its terminal state). Runs inline for
        y4m-sized sources; pass {"sync": false} to spawn a thread."""
        job = self._get_job(job_id)
        co = self.coordinator
        prior: list[Status] = []

        def enter_stamping(j: Job) -> None:
            # guard + prior capture + write in ONE store.update: a
            # scheduler reserve or operator stop racing the outside-
            # the-lock check must win (otherwise this write performs
            # an undeclared STARTING/STOPPED→STAMPING edge and the
            # restore later resurrects a stopped job)
            if j.status.is_active:
                raise ApiError(
                    409, f"job is {j.status.value}; stop it first")
            if j.status is Status.REJECTED:
                # REJECTED absorbs (the declared job machine in
                # analysis/manifest.py): an admission-rejected job
                # must be re-added, not put back to work
                raise ApiError(409,
                               "job was rejected by admission policy")
            prior.append(j.status)
            j.status = Status.STAMPING

        co.store.update(job_id, enter_stamping)
        prior_status = prior[0]

        def work() -> None:
            from ..ingest.decode import open_video
            from ..ingest.probe import probe_video
            from ..io.y4m import Y4MWriter
            from ..tools.stamp import stamp_frame

            try:
                base, _ext = os.path.splitext(job.input_path)
                out = base + ".stamped.y4m"
                # streaming: decode → stamp → write one frame at a
                # time, so stamping a long clip never materializes it
                # in coordinator RAM (same ingest path the executors
                # stream through). Stream into a temp path and commit
                # atomically: a mid-stream decode error must not leave
                # a truncated .stamped.y4m behind (or clobber a good
                # one from an earlier POST).
                tmp = f"{out}.{job.id}.tmp"
                try:
                    with open_video(job.input_path) as src, \
                            open(tmp, "wb") as fp:
                        writer = Y4MWriter(fp, src.meta)
                        for i, frame in enumerate(src.iter_frames()):
                            writer.write(stamp_frame(frame, i))
                    os.replace(tmp, out)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
                # Dedup on the target path: a repeated POST /stamp_job
                # refreshes the stamped file but must not register the
                # same .stamped.y4m as a second job.
                existing = next((j for j in co.store.list()
                                 if j.input_path == out), None)
                if existing is None:
                    # stamped copies are verification artifacts: always
                    # single-rendition, even when the source job was a
                    # ladder (the read-back flow expects one MP4)
                    co.add_job(out, meta=probe_video(out),
                               auto_start=False, job_type="transcode")
                    co.activity.emit("stamp", f"stamped copy at {out}",
                                     job_id=job_id)
                else:
                    co.activity.emit(
                        "stamp", f"stamped copy at {out} refreshed "
                        f"(already job {existing.id[:8]})", job_id=job_id)
            except Exception as exc:     # noqa: BLE001 - record & restore
                co.activity.emit("error", f"stamp failed: {exc}",
                                 job_id=job_id)
            finally:
                _restore_after_stamp(co, job_id, prior_status)

        if body.get("sync", True):
            work()
        else:
            threading.Thread(target=work, daemon=True).start()
        return 200, {"status": self._get_job(job_id).status.value}

    def _h_metrics_snapshot(self, query, body) -> tuple[int, Any]:
        metrics = {w.host: dict(w.metrics, last_seen=w.last_seen)
                   for w in self.coordinator.registry.all()}
        out: dict[str, Any] = {"metrics": metrics}
        # Host encode-stage breakdown (decode / stage / dispatch /
        # device wait / fetch / dense_retry / sparse unpack / unflatten
        # / pack / concat wall-clock ms) plus the boundary counters
        # (dense_fallback_waves, d2h_bytes, fetch_shards,
        # proc_pack_gops — parallel/dispatch.STAGE_COUNTERS) for
        # every live encoder in this process. Read through sys.modules:
        # if no encoder ever ran here (e.g. a pure-manager node), don't
        # drag torch in just to report an empty dict.
        import sys as _sys

        disp = _sys.modules.get("thinvids_tpu_torch.parallel.dispatch")
        out["stage_ms"] = disp.stage_snapshot() if disp is not None else {}
        # SFE per-frame latency percentiles — the frame_done_t data
        # the bench always recorded, finally summarized for operators
        # (dashboard SFE line + this snapshot)
        out["sfe_latency_ms"] = (disp.frame_latency_percentiles()
                                 if disp is not None else {})
        if self.work is not None:
            out["work"] = self.work.snapshot()
        # origin serving counters + per-job concurrent-session gauges
        # (origin/serve.py) and the QoS controller's preemption state
        out["origin"] = self.origin.snapshot()
        qos = getattr(self.coordinator, "qos", None)
        if qos is not None:
            out["qos"] = qos.snapshot()
        # elastic-farm lifecycle panel (farm/controller.py): per-host
        # ACTIVE/DRAINING/SUSPENDED/WAKING plus the worker-seconds
        # integral the autoscale bench reports
        farm = getattr(self.coordinator, "farm", None)
        if farm is not None:
            out["farm"] = farm.snapshot()
        return 200, out

    def _h_metrics(self, query, body) -> tuple[int, Any]:
        """Prometheus text exposition over the obs/ metrics registry.

        Counters and histograms stream in as subsystems record them;
        point-in-time state (job statuses, shard-board lease states,
        per-job viewer sessions) is refreshed at scrape time so the
        gauges reflect NOW, not the last event. Gated by the
        `metrics_enabled` setting (TVT_METRICS_ENABLED)."""
        snap = self.coordinator._settings_fn()
        if not as_bool(snap.get("metrics_enabled", True), True):
            raise ApiError(404, "metrics disabled (metrics_enabled)")
        # refresh + render under one lock: a concurrent scrape racing
        # the clear()-then-repopulate would see doubled/partial gauges
        with self._scrape_lock:
            jobs = obs_metrics.JOBS_BY_STATUS
            jobs.clear()
            # the default tenant's full status schema is always
            # present so a fresh scrape sees every series name; other
            # tenants' series appear as their jobs do
            for status in Status:
                jobs.labels("default", status.value).set(0)
            for job in self.coordinator.store.list():
                jobs.labels(getattr(job, "tenant", "default")
                            or "default", job.status.value).inc()
            tenant_shards = obs_metrics.TENANT_ACTIVE_SHARDS
            tenant_shards.clear()
            tenant_shards.labels("default").set(0)
            if self.work is not None:
                for tenant, n in self.work.tenant_assigned().items():
                    tenant_shards.labels(tenant).set(n)
            farm_workers = obs_metrics.FARM_WORKERS
            farm_workers.clear()
            farm = getattr(self.coordinator, "farm", None)
            farm_counts = farm.snapshot()["counts"] if farm is not None \
                else {}
            for state in ("active", "draining", "suspended", "waking"):
                farm_workers.labels(state).set(
                    farm_counts.get(state, 0))
            sessions = obs_metrics.SESSIONS
            sessions.clear()
            for job_id, n in self.origin.sessions.concurrent().items():
                sessions.labels(job_id).set(n)
            shard_states = obs_metrics.SHARD_STATES
            shard_states.clear()
            counts = (self.work.snapshot()["shards"]
                      if self.work is not None else {})
            for state in ShardState:
                shard_states.labels(state.value).set(
                    counts.get(state.value, 0))
            halo = (self.work.halo.snapshot()
                    if self.work is not None else {})
            obs_metrics.HALO_RELAY_BLOBS.set(halo.get("blobs", 0))
            obs_metrics.HALO_RELAY_BYTES.set(halo.get("bytes", 0))
            return 200, _TextResponse(
                obs_metrics.REGISTRY.render(),
                "text/plain; version=0.0.4; charset=utf-8")

    def _h_trace(self, query, body, job_id) -> tuple[int, Any]:
        """Chrome trace-event JSON export of one job's distributed
        trace (coordinator spans + any worker-uploaded spans, one
        trace id) — drag the response into Perfetto. 404 when the job
        never ran with tracing sampled on."""
        self._get_job(job_id)
        doc = obs_trace.TRACE.export_chrome(job_id)
        if doc is None:
            raise ApiError(404, f"no trace recorded for job {job_id} "
                                f"(unsampled, or evicted from the "
                                f"trace ring)")
        return 200, doc

    # -- worker pull API (cluster/remote.py ShardBoard) ----------------

    def partition_work(self, seconds: float) -> None:
        """Black-hole the /work/* routes for `seconds` (chaos: the
        network partition between coordinator and farm). Workers see
        claim failures and back off exactly as they would against a
        real partition; leases ride it out or expire into the sweep."""
        with self._fault_lock:
            self._work_partition_until = time.monotonic() + max(
                0.0, float(seconds))

    def corrupt_parts(self, n: int) -> None:
        """Chaos: flip one bit in each of the next `n` part-upload
        bodies before they unpack — the in-flight transfer corruption
        the integrity layer must reject (and the worker's idempotent
        re-upload must then heal with no attempt burned)."""
        with self._fault_lock:
            self._corrupt_parts_left += max(0, int(n))

    def _maybe_corrupt_part(self, raw: bytes) -> bytes:
        with self._fault_lock:
            if self._corrupt_parts_left <= 0:
                return raw
            self._corrupt_parts_left -= 1
        flipped = bytearray(raw)
        if flipped:
            # deterministic mid-body flip: lands in a payload for any
            # realistically sized part (headers are a small prefix)
            flipped[len(flipped) // 2] ^= 0x40
        return bytes(flipped)

    def _work_board_or_503(self):
        if self.work is None:
            raise ApiError(503, "no remote work backend "
                                "(execution_backend != remote)")
        with self._fault_lock:
            partitioned = time.monotonic() < self._work_partition_until
        if partitioned:
            raise ApiError(503, "work routes partitioned (chaos)",
                           headers={"Retry-After": "1"})
        return self.work

    def _h_work_claim(self, query, body) -> tuple[int, Any]:
        board = self._work_board_or_503()
        host = str(body.get("host", "")).strip()
        if not host:
            raise ApiError(400, "host required")
        return 200, {"shard": board.claim(host)}

    def _h_work_part(self, query, body, shard_id) -> tuple[int, Any]:
        from ..cluster.remote import unpack_parts

        board = self._work_board_or_503()
        host = query.get("host", "").strip()
        if not host:
            # same contract as /work/claim: an empty host would record
            # shard results against a phantom "" registry row
            raise ApiError(400, "host query parameter required")
        raw = body.get("_raw")
        if not isinstance(raw, (bytes, bytearray)):
            raise ApiError(400, "binary part body required "
                                "(Content-Type: application/octet-stream)")
        raw = self._maybe_corrupt_part(bytes(raw))
        verify = as_bool(self.coordinator._settings_fn().get(
            "part_integrity", True), True)
        try:
            segments = unpack_parts(raw, verify=verify)
        except ValueError as exc:
            # torn frame OR digest mismatch: the bytes corrupted in
            # TRANSIT — a transfer fault, not a worker fault. The
            # lease goes straight back (no attempt burned, counted in
            # tvt_part_integrity_failures_total) and the worker is
            # told to re-send its idempotent upload.
            board.reject_part(shard_id, host, str(exc))
            return 200, {"ok": False, "retry": True,
                         "error": f"part rejected: {exc}"}
        # hand the VERIFIED wire bytes through: the board spools them
        # verbatim (no re-serialization, digests lifted from the
        # already-checked header — partstore.spool)
        ok = board.submit_part(shard_id, host, segments, raw=raw)
        return 200, {"ok": ok}

    def _h_work_spans(self, query, body, ctx=None) -> tuple[int, Any]:
        """Worker-side span upload (the trace side of the /work
        protocol): the X-Tvt-Trace header carries the trace id the
        worker learned from its claim descriptor, and the body holds
        the shard's collected spans. Spans whose trace id no longer
        matches the job's CURRENT trace are dropped — a straggler from
        a superseded run must not pollute the new run's trace."""
        headers = (ctx or {}).get("headers") or {}
        trace_id = str(headers.get("X-Tvt-Trace") or "").strip()
        if not trace_id:
            raise ApiError(400, "X-Tvt-Trace header required")
        job_id = str(body.get("job_id", "")).strip()
        if not job_id:
            raise ApiError(400, "job_id required")
        spans = body.get("spans")
        if not isinstance(spans, list):
            raise ApiError(400, "spans must be a list")
        recorded = obs_trace.TRACE.ingest(
            job_id, trace_id, spans, host=str(body.get("host", "")))
        return 200, {"recorded": recorded}

    def _h_work_status(self, query, body) -> tuple[int, Any]:
        board = self._work_board_or_503()
        shard_id = str(body.get("shard_id", "")).strip()
        if not shard_id:
            raise ApiError(400, "shard_id required")
        if body.get("unsupported"):
            # shape rejection (old worker): requeue with NO attempt
            # burned and stop offering the shard to this host
            board.report_unsupported(
                shard_id, str(body.get("host", "")),
                str(body.get("error", "unsupported shard shape")))
        else:
            board.report_failure(shard_id, str(body.get("host", "")),
                                 str(body.get("error", "worker error")))
        return 200, {"ok": True}

    def _h_work_halo_post(self, query, body) -> tuple[int, Any]:
        """Band-shard halo relay ingest (cluster/halo.py): a worker
        posts one digest-framed blob (neighbor recon rows, probe or
        histogram partial) keyed by (seq, band, kind); `stale` tells a
        superseded-generation worker to abandon its shard."""
        board = self._work_board_or_503()
        raw = body.get("_raw")
        if not isinstance(raw, (bytes, bytearray)):
            raise ApiError(400, "binary halo body required "
                                "(Content-Type: application/octet-stream)")
        ok = board.halo.post(
            str(query["job"]), int(query.get("gen", 1)),
            int(query["seq"]), int(query["band"]),
            str(query["kind"]), bytes(raw))
        return 200, ({"ok": True} if ok else {"stale": True})

    def _h_work_halo_get(self, query, body) -> tuple[int, Any]:
        """Band-shard halo relay fetch: long-polls up to `wait`
        seconds server-side (bounded — the client re-polls against its
        own halo_timeout_s budget), answering the blob as binary,
        `pending` when it has not arrived, or `stale` when the band
        group restarted under a newer generation."""
        from ..cluster.halo import HaloStaleError

        board = self._work_board_or_503()
        wait = min(10.0, max(0.0, float(query.get("wait", 2.0))))
        try:
            blob = board.halo.wait(
                str(query["job"]), int(query.get("gen", 1)),
                int(query["seq"]), int(query["band"]),
                str(query["kind"]), wait)
        except HaloStaleError:
            return 200, {"stale": True}
        if blob is None:
            return 200, {"pending": True}
        return 200, _TextResponse(blob, "application/octet-stream")

    def _h_work_chaos(self, query, body) -> tuple[int, Any]:
        """Chaos-injection control channel for the out-of-process
        harness (bench `_run_crash_resume` drives a SUBPROCESS
        coordinator, so the in-process `partition_work` /
        `corrupt_parts` hooks need an HTTP surface). Deliberately NOT
        behind the partition blackhole — this IS the control channel
        that opens it."""
        if self.work is None:
            raise ApiError(503, "no remote work backend "
                                "(execution_backend != remote)")
        applied: dict[str, Any] = {}
        n = int(body.get("corrupt_parts", 0) or 0)
        if n > 0:
            self.corrupt_parts(n)
            applied["corrupt_parts"] = n
        seconds = float(body.get("partition_s", 0.0) or 0.0)
        if seconds > 0:
            self.partition_work(seconds)
            applied["partition_s"] = seconds
        return 200, applied

    def _h_work_board(self, query, body) -> tuple[int, Any]:
        return 200, self._work_board_or_503().snapshot()

    def _h_get_settings(self, query, body) -> tuple[int, Any]:
        snap = self.coordinator._settings_fn()
        return 200, {"settings": dict(snap.values)}

    def _h_post_settings(self, query, body) -> tuple[int, Any]:
        applied = update_live_settings(body)
        return 200, {"applied": applied}
