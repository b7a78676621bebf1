"""The port's daemons as an operator starts them:
`python -m thinvids_tpu_torch.cli coordinator --device cpu` serves the
API and dashboard, takes an agent's heartbeats, ingests a y4m dropped in
its watch folder, writes the MP4 the JAX package's executor writes from
the same file, and recovers the job from its journal after a hard kill;
`cli trace` exports the job's trace and `cli feed` paces a clip into a
growing live drop. Without a card, the default `--device cuda` exits
with an error naming it, the farm's worker and remote coordinator too.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import numpy as np

from thinvids_tpu.cluster import Coordinator, WorkerRegistry
from thinvids_tpu.cluster.executor import LocalExecutor
from thinvids_tpu.core.config import DEFAULT_SETTINGS, Settings
from thinvids_tpu.core.status import Status
from thinvids_tpu.core.types import Frame, VideoMeta
from thinvids_tpu.io.y4m import write_y4m
from thinvids_tpu.parallel.dispatch import default_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
           CUDA_VISIBLE_DEVICES="", TVT_MIN_IDLE_WORKERS="0",
           TVT_GOP_FRAMES="4", TVT_QP="30")


def _call(base, path, method="GET", body=None, timeout=5):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _wait_api(base, proc, deadline_s=60):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        assert proc.poll() is None, proc.args
        try:
            return _call(base, "/health")
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.3)
    raise TimeoutError(f"coordinator API never came up at {base}")


def _cli(*args):
    return [sys.executable, "-m", "thinvids_tpu_torch.cli", *args]


def _spawn_coordinator(tmp_path, port, *extra):
    with open(tmp_path / "coordinator.log", "ab") as log:
        return subprocess.Popen(
            _cli("coordinator", "--host", "127.0.0.1", "--port", str(port),
                 "--state-dir", str(tmp_path / "state"),
                 "--watch-dir", str(tmp_path / "watch"),
                 "--output-dir", str(tmp_path / "library"),
                 "--scan-interval", "0.5", *extra),
            env=ENV, stdout=log, stderr=subprocess.STDOUT)


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=15)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _clip(w, h, n):
    yy, xx = np.mgrid[0:h, 0:w]
    return [Frame(y=((xx * 2 + yy + 7 * i) % 256).astype(np.uint8),
                  u=np.full((h // 2, w // 2), 108, np.uint8),
                  v=np.full((h // 2, w // 2), 148, np.uint8))
            for i in range(n)]


def _jax_executor_mp4(tmp_path, path, w, h, n):
    snap = Settings(values=dict(DEFAULT_SETTINGS, gop_frames=4, qp=30,
                                heartbeat_throttle_s=0.0))
    reg = WorkerRegistry()
    for i in range(8):
        reg.heartbeat(f"w{i}")
    coord = Coordinator(registry=reg, settings_fn=lambda: snap)
    execu = LocalExecutor(coord, str(tmp_path / "ref"), sync=True,
                          mesh=default_mesh(jax.devices()[:1]))
    coord._launcher = execu.launch
    job = coord.add_job(path, VideoMeta(width=w, height=h, num_frames=n))
    job = coord.store.get(job.id)
    assert job.status is Status.DONE, job.failure_reason
    with open(job.output_path, "rb") as fp:
        return fp.read()


def test_coordinator_process_on_the_cpu_end_to_end(tmp_path):
    os.makedirs(tmp_path / "watch")
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    proc = _spawn_coordinator(tmp_path, port, "--device", "cpu")
    try:
        _wait_api(base, proc)
        with urllib.request.urlopen(base + "/", timeout=5) as resp:
            assert resp.headers["Content-Type"].startswith("text/html")

        agent = subprocess.Popen(
            _cli("agent", "--coordinator", base, "--node-name", "w-test",
                 "--interval", "0.3", "--device", "cpu"),
            env=ENV, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        try:
            deadline = time.time() + 30
            while time.time() < deadline:
                nodes = _call(base, "/nodes_data")["nodes"]
                if any(n["host"] == "w-test" for n in nodes):
                    break
                time.sleep(0.3)
            assert any(n["host"] == "w-test" for n in nodes)
        finally:
            agent.send_signal(signal.SIGINT)
            agent.wait(timeout=15)

        # watch-folder ingest → transcode on the CPU → DONE
        n, w, h = 12, 64, 48
        src = str(tmp_path / "clip.y4m")
        write_y4m(src, VideoMeta(width=w, height=h, fps_num=30,
                                 num_frames=n), _clip(w, h, n))
        os.replace(src, tmp_path / "watch" / "clip.y4m")
        deadline = time.time() + 120
        job = None
        while time.time() < deadline:
            jobs = _call(base, "/jobs")["jobs"]
            if jobs and jobs[0]["status"] in ("done", "failed"):
                job = jobs[0]
                break
            time.sleep(0.5)
        assert job is not None and job["status"] == "done", job
        with open(job["output_path"], "rb") as fp:
            got = fp.read()
        assert got == _jax_executor_mp4(
            tmp_path, str(tmp_path / "watch" / "clip.y4m"), w, h, n)

        # the node row carries the device the daemon encodes on, and the
        # port's stage totals ride the snapshot
        snap = _call(base, "/metrics_snapshot")
        rows = [m for m in snap["metrics"].values()
                if m.get("device_kind") == "cpu"]
        assert rows and all(m["devices"] == 1 for m in rows)
        assert snap["stage_ms"]["waves"] >= 1

        # the trace subcommand exports the job's spans
        out = tmp_path / "job.trace.json"
        res = subprocess.run(
            _cli("trace", job["id"], "--coordinator", base, "--out",
                 str(out)), env=ENV, capture_output=True, text=True,
            timeout=60)
        assert res.returncode == 0, res.stderr
        doc = json.loads(out.read_text())
        names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
        assert {"wave_dispatch", "wave_collect"} <= names

        # hard kill and restart over the same state dir: the DONE job is
        # recovered from the journal, and the ledger stops a re-submit
        proc.kill()
        proc.wait(timeout=10)
        proc = _spawn_coordinator(tmp_path, port, "--device", "cpu")
        _wait_api(base, proc)
        jobs = _call(base, "/jobs")["jobs"]
        assert len(jobs) == 1 and jobs[0]["status"] == "done"
        time.sleep(1.5)
        assert len(_call(base, "/jobs")["jobs"]) == 1
    finally:
        _stop(proc)


def test_default_device_without_a_card_exits_naming_it(tmp_path):
    res = subprocess.run(
        _cli("coordinator", "--port", str(_free_port()),
             "--output-dir", str(tmp_path / "library")),
        env=ENV, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA card for --device cuda" in res.stderr
    assert "--device cpu" in res.stderr
    assert not (tmp_path / "library").exists()


def test_worker_and_remote_coordinator_without_a_card_exit_naming_it(
        tmp_path):
    """The farm's daemons refuse a missing card as the coordinator does:
    `cli worker` and `cli coordinator --backend remote` with the default
    `--device cuda` exit naming it, before they serve or claim anything."""
    for args in (("worker", "--coordinator",
                  f"http://127.0.0.1:{_free_port()}"),
                 ("coordinator", "--backend", "remote", "--port",
                  str(_free_port()), "--state-dir", str(tmp_path / "s"),
                  "--output-dir", str(tmp_path / "library"))):
        res = subprocess.run(_cli(*args), env=ENV, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert "no CUDA card for --device cuda" in res.stderr
        assert "--device cpu" in res.stderr
    assert not (tmp_path / "library").exists()
    assert not (tmp_path / "s").exists()


def test_feed_paces_a_clip_into_a_live_drop(tmp_path):
    n, w, h = 5, 32, 16
    src = str(tmp_path / "clip.y4m")
    write_y4m(src, VideoMeta(width=w, height=h, fps_num=30, num_frames=n),
              _clip(w, h, n))
    dest = tmp_path / "cam.live.y4m"
    open(str(dest) + ".eos", "wb").close()       # a stale marker goes
    res = subprocess.run(_cli("feed", src, str(dest), "--rate", "0"),
                         env=ENV, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    with open(src, "rb") as fp:
        assert dest.read_bytes() == fp.read()
    assert os.path.exists(str(dest) + ".eos")
