"""Jobs, workers and the CLI on the port's device mesh, on the CPU.

- The reference's elastic-replan cases (tests/test_executor.py's
  `test_elastic_replan_on_shrunken_mesh`, which expects mesh sizes
  [8, 7], and `test_single_device_mesh_cannot_replan_fails`) run again
  over the port's LocalExecutor with an 8-entry CPU mesh: the reference
  module is read with every `thinvids_tpu` import naming
  `thinvids_tpu_torch` (as tests/test_torch_remote.py collects its
  cases), its one-device JAX mesh becomes ``DeviceMesh(("cpu",))``, and
  its LocalExecutor a subclass on an 8-entry CPU mesh.
- A y4m job, a ladder job and a live job on a 2-entry mesh write what
  the JAX executor writes on a 2-device mesh (tolerance 0 bytes).
- `WorkerDaemon(mesh=<2 entries>)` advertises two devices, and
  `cli worker --device cpu --devices cpu,cpu` starts and heartbeats
  them.
"""

import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from thinvids_tpu import cluster as jcluster
from thinvids_tpu.abr.scale import PlaneScaler as JScaler
from thinvids_tpu.cluster import executor as jexecutor
from thinvids_tpu.core import config as jcfg
from thinvids_tpu.core.status import Status as JStatus
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.ingest import tail as jtail
from thinvids_tpu.io.y4m import write_y4m
from thinvids_tpu_torch import cluster as tcluster
from thinvids_tpu_torch.abr import ladder as tladder
from thinvids_tpu_torch.abr.scale import PlaneScaler as TScaler
from thinvids_tpu_torch.cluster import executor as texecutor
from thinvids_tpu_torch.cluster import remote as tremote
from thinvids_tpu_torch.core import config as tcfg
from thinvids_tpu_torch.core.devices import DeviceMesh
from thinvids_tpu_torch.core.status import Status as TStatus
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---- the reference's elastic replan over the port ------------------------------

class MeshLocalExecutor(texecutor.LocalExecutor):
    """The port's executor on the CPU, on an 8-entry mesh unless told
    otherwise (the reference's cases expect its 8-device test mesh), with
    the reference's static `_default_encoder(meta, settings, mesh)`."""

    def __init__(self, *args, device="cpu", mesh=None, **kw):
        super().__init__(*args, device=device,
                         mesh=mesh if mesh is not None
                         else DeviceMesh(("cpu",) * 8), **kw)

    @staticmethod
    def _default_encoder(meta, settings, mesh):
        return tdispatch.make_shard_encoder(meta, settings, mesh,
                                            device="cpu")


def _reference_executor_cases() -> types.ModuleType:
    path = pathlib.Path(__file__).with_name("test_executor.py")
    src = re.sub(r"\bthinvids_tpu\b", "thinvids_tpu_torch",
                 path.read_text())
    one = 'Mesh(np.array(jax.devices()[:1]), ("gop",))'
    assert src.count(one) == 1
    src = src.replace(one, 'DeviceMesh(("cpu",))')
    mod = types.ModuleType("test_executor_over_the_port_mesh")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    mod.__dict__["DeviceMesh"] = DeviceMesh
    mod.__dict__["LocalExecutor"] = MeshLocalExecutor
    return mod


_REF = _reference_executor_cases()
clip_y4m = _REF.clip_y4m


class TestReferenceReplanOverThePort:
    test_elastic_replan_on_shrunken_mesh = \
        _REF.TestEndToEnd.test_elastic_replan_on_shrunken_mesh
    test_single_device_mesh_cannot_replan_fails = \
        _REF.TestEndToEnd.test_single_device_mesh_cannot_replan_fails


def test_the_shrink_halves_its_way_down(tmp_path):
    """_shrink_encoder drops 1, 2, 4, ... entries from the tail and gives
    up at one entry, as the reference's does."""
    coord = tcluster.Coordinator()
    execu = MeshLocalExecutor(coord, str(tmp_path), sync=True)
    meta = TMeta(width=64, height=48, num_frames=12)
    snap = tcfg.Settings(values=dict(tcfg.DEFAULT_SETTINGS, gop_frames=4))
    enc = execu._encoder_factory(meta, snap, execu.mesh)
    sizes = [enc.num_devices]
    for attempt in (1, 2, 3):
        enc = execu._shrink_encoder(enc, snap, attempt)
        sizes.append(enc.num_devices)
    assert sizes == [8, 7, 5, 1]
    assert execu._shrink_encoder(enc, snap, 4) is None


# ---- jobs on a 2-entry mesh against the JAX executor on 2 devices ---------------

PKGS = {"jax": (jcluster, jexecutor, jcfg, JMeta, JStatus),
        "torch": (tcluster, texecutor, tcfg, TMeta, TStatus)}


def _smooth_clip(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (128 + 50 * np.sin((xx + 2 * i) * 0.1) * np.cos((yy + i) * 0.08)
             + rng.normal(0, 1.0, (h, w)))
        c = 128 + 30 * np.sin(xx[::2, ::2] * 0.06 + i * 0.1)
        out.append((np.clip(y, 0, 255).astype(np.uint8),
                    np.clip(c, 0, 255).astype(np.uint8),
                    np.clip(255 - c, 0, 255).astype(np.uint8)))
    return out


def _write_clip(path, clip, w, h):
    write_y4m(path, JMeta(width=w, height=h, fps_num=30,
                          num_frames=len(clip)),
              [JFrame(*f) for f in clip])
    return str(path)


def _rig(pkg, tmp_path, name, over=None):
    """(coordinator, executor) of one package on a 2-wide mesh."""
    cluster, executor, cfg, _meta, _status = PKGS[pkg]
    snap = cfg.Settings(values=dict(cfg.DEFAULT_SETTINGS, gop_frames=4,
                                    qp=30, heartbeat_throttle_s=0.0,
                                    **(over or {})))
    reg = cluster.WorkerRegistry()
    for i in range(8):
        reg.heartbeat(f"w{i:02d}")
    coord = cluster.Coordinator(registry=reg, settings_fn=lambda: snap)
    kw = (dict(device="cpu", mesh=DeviceMesh(("cpu", "cpu")))
          if pkg == "torch" else
          dict(mesh=Mesh(np.array(jax.devices()[:2]), ("gop",))))
    execu = executor.LocalExecutor(coord, output_dir=str(tmp_path / name),
                                   sync=True, **kw)
    coord._launcher = execu.launch
    return coord, execu


def _run(pkg, coord, path, w, h, n):
    _c, _e, _cfg, meta, status = PKGS[pkg]
    job = coord.add_job(path, meta(width=w, height=h, fps_num=30,
                                   num_frames=n))
    job = coord.store.get(job.id)
    assert job.status is status.DONE, job.failure_reason
    return job


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            out[os.path.relpath(full, root)] = _read(full)
    return out


def _assert_same_tree(got, want):
    assert sorted(got) == sorted(want) and len(want) > 6
    for name in want:
        assert got[name] == want[name], name


@pytest.fixture
def built(monkeypatch):
    out = []
    real = tdispatch.make_shard_encoder

    def spy(*args, **kw):
        enc = real(*args, **kw)
        out.append(enc)
        return enc

    monkeypatch.setattr(tdispatch, "make_shard_encoder", spy)
    return out


def test_y4m_job_on_a_mesh_writes_the_reference_mp4(tmp_path, built):
    w, h, n = 64, 48, 14
    path = _write_clip(tmp_path / "clip.y4m", _smooth_clip(n, w, h, seed=5),
                       w, h)
    port = _run("torch", _rig("torch", tmp_path, "port")[0], path, w, h, n)
    ref = _run("jax", _rig("jax", tmp_path, "ref")[0], path, w, h, n)
    (enc,) = built
    assert type(enc) is tdispatch.GopShardEncoder and enc.num_devices == 2
    assert port.parts_total == ref.parts_total == 4
    assert _read(port.output_path) == _read(ref.output_path)


def _assert_planes_equal_jax(clip, w, h, dims):
    """Precondition of a whole-ladder comparison: the port's scaled
    planes equal the JAX package's on this clip."""
    padded = [TFrame(*f).padded(16) for f in clip]
    planes = [np.stack([getattr(f, p) for f in padded]) for p in "yuv"]
    for dw, dh in dims:
        got = TScaler(w, h, dw, dh, device="cpu").scale_wave(
            *(torch.from_numpy(p) for p in planes))
        for g, j in zip(got, JScaler(w, h, dw, dh).scale_wave(*planes)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_ladder_job_on_a_mesh_writes_the_reference_tree(tmp_path, built):
    w, h, n = 64, 48, 16
    clip = _smooth_clip(n, w, h, seed=3)
    _assert_planes_equal_jax(clip, w, h, [(42, 32), (32, 24)])
    path = _write_clip(tmp_path / "clip.ladder.y4m", clip, w, h)
    over = dict(segment_s=0.25, ladder_rungs="32,24")
    port = _run("torch", _rig("torch", tmp_path, "port", over)[0], path, w,
                h, n)
    ref = _run("jax", _rig("jax", tmp_path, "ref", over)[0], path, w, h, n)
    (enc,) = built
    assert type(enc) is tladder.LadderShardEncoder and enc.num_devices == 2
    assert port.job_type == "ladder"
    _assert_same_tree(_tree(os.path.dirname(port.output_path)),
                      _tree(os.path.dirname(ref.output_path)))


@pytest.mark.parametrize("case,w,h,over", [
    ("ladder", 64, 48, {"ladder_rungs": "24"}),
    ("sfe_2_bands", 64, 96, {"sfe_bands": 2, "ladder_rungs": "96"}),
])
def test_live_job_on_a_mesh_writes_the_reference_tree(tmp_path, built,
                                                      case, w, h, over):
    n = 12
    clip = _smooth_clip(n, w, h, seed=27)
    if case == "ladder":
        _assert_planes_equal_jax(clip, w, h, [(32, 24)])
    path = tmp_path / "cam.live.y4m"
    write_y4m(path, JMeta(width=w, height=h, fps_num=30, num_frames=n),
              [JFrame(*f) for f in clip])
    open(str(path) + jtail.EOS_SUFFIX, "wb").close()
    over = dict(over, segment_s=0.25, live_stall_s=30.0)
    port = _run("torch", _rig("torch", tmp_path, "port", over)[0],
                str(path), w, h, n)
    ref = _run("jax", _rig("jax", tmp_path, "ref", over)[0], str(path), w,
               h, n)
    (enc,) = built
    assert enc.num_devices == 2
    if case == "sfe_2_bands":
        assert type(enc) is tdispatch.SfeShardEncoder
        assert enc.num_bands == 2 and enc._band_runs == ((0, 1), (1, 2))
    assert port.job_type == "live"
    _assert_same_tree(_tree(os.path.dirname(port.output_path)),
                      _tree(os.path.dirname(ref.output_path)))


# ---- the worker ------------------------------------------------------------------

def test_worker_advertises_its_mesh():
    daemon = tremote.WorkerDaemon("http://127.0.0.1:9", device="cpu",
                                  mesh=DeviceMesh(("cpu", "cpu")))
    assert daemon.metrics()["worker_devices"] == 2
    one = tremote.WorkerDaemon("http://127.0.0.1:9", device="cpu")
    assert one.metrics()["worker_devices"] == 1


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_worker_starts_on_a_mesh(tmp_path):
    """`cli worker --device cpu --devices cpu,cpu` starts, heartbeats two
    devices and polls for work (a stand-in coordinator answers both
    routes); an entry naming a card the host lacks exits naming it."""
    beats, claims = [], []

    class Stub(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers.get("Content-Length", 0))) or b"{}")
            if self.path == "/node_heartbeat":
                beats.append(body)
                out = {"ok": True}
            else:
                claims.append(body)
                out = {"shard": None}
            data = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", _free_port()), Stub)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    cli = [sys.executable, "-m", "thinvids_tpu_torch.cli", "worker",
           "--coordinator", url, "--node-name", "w-mesh", "--device", "cpu"]
    proc = subprocess.Popen(cli + ["--devices", "cpu,cpu", "--poll", "0.2"],
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 90
        while time.time() < deadline and not (
                claims and any(b["metrics"].get("worker_devices") == 2
                               for b in beats)):
            assert proc.poll() is None, proc.stderr.read().decode()
            time.sleep(0.2)
        assert claims and claims[0]["host"] == "w-mesh"
        assert any(b["host"] == "w-mesh"
                   and b["metrics"].get("worker_devices") == 2
                   for b in beats)
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)
        server.shutdown()
        server.server_close()
    res = subprocess.run(cli + ["--devices", "cuda:7"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "--devices cuda:7" in res.stderr
