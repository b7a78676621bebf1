"""Farm split-frame encoding over the port, held against the JAX package.

The reference's farm cases (tests/test_bandfarm.py: halo framing and
relay, band descriptors, group restarts, band planning, the stitcher,
the in-process two-slice farm, live catch-up and the two-worker
subprocess farm) are collected over the port's modules, on the CPU, as
tests/test_torch_remote.py collects the remote backend's.

Then the same seeded inputs go through both packages, with 0 bytes of
difference allowed:

- two port FarmBandEncoder slices, lockstep through a port HaloRelay,
  stitch to JAX's local two-band SFE stream, and each slice's segments
  equal the JAX FarmBandEncoder slice's;
- three groups over four bands (one slice holds two bands on one
  device; the last band is partial) stitch to JAX's four-band stream;
- noise at qp 4 escapes into the dense replay, on both sides;
- `encode_shard` on a GOP shard, a scaled rung shard and a band shard
  gives the reference's `pack_parts` bytes;
- `pack_parts` and `halo.pack_arrays` frame the same inputs into the
  same bytes.
"""

import threading

import numpy as np
import pytest

from tests.test_torch_remote import (_port_on_the_cpu,  # noqa: F401
                                     collect, reference_cases)
from thinvids_tpu.cluster import halo as jhalo
from thinvids_tpu.cluster import remote as jremote
from thinvids_tpu.core import types as jtypes
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu.parallel import sfefarm as jsfefarm
from thinvids_tpu_torch.cluster import halo as thalo
from thinvids_tpu_torch.cluster import remote as tremote
from thinvids_tpu_torch.core import types as ttypes
from thinvids_tpu_torch.core.devices import DeviceMesh
from thinvids_tpu_torch.parallel import sfefarm as tsfefarm

collect(reference_cases("test_bandfarm"), globals())

_W, _H, _N, _QP, _GF = 192, 128, 6, 27, 3


def _gradient(w, h, n):
    """test_bandfarm.py's clip: a diagonal ramp moving 7 levels a frame,
    flat chroma."""
    yy, xx = np.mgrid[0:h, 0:w]
    return [(((xx * 2 + yy + 7 * i) % 256).astype(np.uint8),
             np.full((h // 2, w // 2), 108, np.uint8),
             np.full((h // 2, w // 2), 148, np.uint8)) for i in range(n)]


def _noise(w, h, n, seed=7):
    """tests/test_sfe.py's escape content: uniform noise (at qp 4 its
    levels exceed int8)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n)]


def _meta(types_mod, w, h, n):
    return types_mod.VideoMeta(width=w, height=h, fps_num=30, fps_den=1,
                               num_frames=n)


def _frames(types_mod, clip):
    return [types_mod.Frame(y=y, u=u, v=v) for y, u, v in clip]


def _farm(halo_mod, encoder_of, groups):
    """Run one encoder per band group on its own thread, lockstep
    through an in-process halo relay. `encoder_of(lo, hi, session)`
    builds a slice's encoder and returns its segments."""
    relay = halo_mod.HaloRelay()
    relay.set_gen("job", 1)
    outs, errs = {}, []

    def run(lo, hi):
        try:
            sess = halo_mod.HaloSession(
                halo_mod.LocalHaloHub(relay, "job", 1, timeout_s=120.0),
                band_lo=lo, band_hi=hi, groups=groups)
            outs[lo] = encoder_of(lo, hi, sess)
        except Exception as exc:        # noqa: BLE001 - surfaced below
            errs.append(exc)

    threads = [threading.Thread(target=run, args=g) for g in groups]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errs, errs
    return outs


def _stitch(remote_mod, meta, outs, groups, total):
    shards = []
    for lo, hi in groups:
        s = remote_mod.Shard(id=f"b{lo}", job_id="job", input_path="x",
                             meta=meta, gops=(), qp=_QP, gop_frames=_GF,
                             timeout_s=60.0, shape="band", band_start=lo,
                             band_count=hi - lo, total_bands=total)
        s.segments = outs[lo]
        shards.append(s)
    return remote_mod.stitch_band_shards(shards)


def _port_farm(clip, w, h, qp, total, groups, mesh=None, built=None):
    """The port's farm of `groups`, each slice on `mesh` (None: one CPU
    device); `built` (a dict) receives each slice's encoder."""
    meta = _meta(ttypes, w, h, len(clip))
    frames = _frames(ttypes, clip)

    def slice_of(lo, hi, sess):
        enc = tsfefarm.FarmBandEncoder(
            meta, qp=qp, gop_frames=_GF, total_bands=total,
            band_range=(lo, hi), session=sess, device="cpu", mesh=mesh)
        if built is not None:
            built[lo] = enc
        return enc.encode(frames)

    outs = _farm(thalo, slice_of, groups)
    return outs, ttypes.concat_segments(
        _stitch(tremote, meta, outs, groups, total))


def _jax_local(clip, w, h, qp, bands):
    meta = _meta(jtypes, w, h, len(clip))
    enc = jdispatch.SfeShardEncoder(meta, qp=qp, gop_frames=_GF,
                                    bands=bands)
    return jtypes.concat_segments(enc.encode(_frames(jtypes, clip))), enc


def _segments_equal(got, want):
    assert [(s.gop.index, s.gop.start_frame, s.gop.num_frames,
             s.frame_sizes, s.payload) for s in got] == \
        [(s.gop.index, s.gop.start_frame, s.gop.num_frames,
          s.frame_sizes, s.payload) for s in want]


def test_two_slices_equal_the_jax_local_stream_and_jax_slices():
    import jax
    from jax.sharding import Mesh

    clip = _gradient(_W, _H, _N)
    groups = [(0, 1), (1, 2)]
    outs, got = _port_farm(clip, _W, _H, _QP, 2, groups)
    want, _ = _jax_local(clip, _W, _H, _QP, 2)
    assert got == want

    jmeta = _meta(jtypes, _W, _H, _N)
    jframes = _frames(jtypes, clip)
    jouts = _farm(jhalo, lambda lo, hi, sess: jsfefarm.FarmBandEncoder(
        jmeta, qp=_QP, mesh=Mesh(np.array([jax.devices()[lo]]), ("band",)),
        gop_frames=_GF, total_bands=2, band_range=(lo, hi),
        session=sess).encode(jframes), groups)
    for lo, _hi in groups:
        _segments_equal(outs[lo], jouts[lo])


def test_three_groups_over_four_bands_with_a_two_band_slice():
    # 104 rows = 7 MB rows (the last half padding): 4 bands of 2 MB rows,
    # the last holding 1 real row
    w, h = 192, 104
    clip = _gradient(w, h, _N)
    groups = [(0, 2), (2, 3), (3, 4)]
    outs, got = _port_farm(clip, w, h, _QP, 4, groups)
    want, jenc = _jax_local(clip, w, h, _QP, 4)
    assert jenc.num_bands == 4
    assert [b.mb_rows for b in jenc.band_plan.bands] == [2, 2, 2, 1]
    assert got == want
    assert [len(outs[lo]) for lo, _hi in groups] == [2, 2, 2]


def test_an_escape_replays_dense_on_both_sides():
    # the two-slice case's frame and GOP shapes: the JAX side reuses its
    # compiled steps and compiles only the dense ones
    w, h, qp = _W, _H, 4
    clip = _noise(w, h, _N)
    meta = _meta(ttypes, w, h, len(clip))
    frames = _frames(ttypes, clip)
    slices = {}

    def slice_of(lo, hi, sess):
        enc = tsfefarm.FarmBandEncoder(
            meta, qp=qp, gop_frames=_GF, total_bands=2,
            band_range=(lo, hi), session=sess, device="cpu")
        slices[lo] = enc
        return enc.encode(frames)

    groups = [(0, 1), (1, 2)]
    outs = _farm(thalo, slice_of, groups)
    got = ttypes.concat_segments(_stitch(tremote, meta, outs, groups, 2))
    want, jenc = _jax_local(clip, w, h, qp, 2)
    assert jenc.stages.snapshot()["dense_fallback_waves"] >= 1
    assert all(e.stages.snapshot()["dense_fallback_waves"] >= 1
               for e in slices.values())
    assert got == want


# ---- a slice's bands as runs over its worker's mesh --------------------------

#: 104 rows = 7 MB rows: plan_bands(7, 12, 4) gives 4 bands of 2 MB rows,
#: the last holding 1 real row
_MW, _MH = 192, 104
_TWO = DeviceMesh(("cpu", "cpu"))


@pytest.mark.parametrize("groups,runs", [
    ([(0, 2), (2, 4)], {0: ((0, 1), (1, 2)), 2: ((0, 1), (1, 2))}),
    # runs of 2 + 1 beside a one-band slice, which takes one entry
    ([(0, 3), (3, 4)], {0: ((0, 2), (2, 3)), 3: ((0, 1),)}),
], ids=["two-2-band-slices", "uneven-runs"])
def test_slices_over_two_entry_meshes_equal_the_jax_local_stream(groups,
                                                                 runs):
    clip = _gradient(_MW, _MH, _N)
    built = {}
    _, got = _port_farm(clip, _MW, _MH, _QP, 4, groups, mesh=_TWO,
                        built=built)
    want, _ = _jax_local(clip, _MW, _MH, _QP, 4)
    assert {lo: e._band_runs for lo, e in built.items()} == runs
    assert {lo: e.num_devices for lo, e in built.items()} == \
        {lo: len(r) for lo, r in runs.items()}
    assert got == want


def test_two_band_slices_equal_the_jax_farm_slices_on_two_devices():
    """The reference's farm step as a shard_map over a slice's two
    devices (`_sfe_p_step_farm` on its band mesh) against the port's
    slices on two-entry meshes, segment for segment."""
    import jax
    from jax.sharding import Mesh

    groups = [(0, 2), (2, 4)]
    clip = _gradient(_MW, _MH, _N)
    outs, _ = _port_farm(clip, _MW, _MH, _QP, 4, groups, mesh=_TWO)
    jmeta = _meta(jtypes, _MW, _MH, _N)
    jframes = _frames(jtypes, clip)
    jouts = _farm(jhalo, lambda lo, hi, sess: jsfefarm.FarmBandEncoder(
        jmeta, qp=_QP, mesh=Mesh(np.array(jax.devices()[lo:hi]), ("band",)),
        gop_frames=_GF, total_bands=4, band_range=(lo, hi),
        session=sess).encode(jframes), groups)
    for lo, _hi in groups:
        _segments_equal(outs[lo], jouts[lo])


def test_an_escape_replays_dense_on_two_entry_slices():
    """Noise at qp 4 escapes into the dense replay of each slice's runs,
    fed by the exchange the sparse walk recorded."""
    qp = 4
    clip = _noise(_MW, _MH, _N)
    built = {}
    _, got = _port_farm(clip, _MW, _MH, qp, 4, [(0, 2), (2, 4)], mesh=_TWO,
                        built=built)
    want, jenc = _jax_local(clip, _MW, _MH, qp, 4)
    assert jenc.stages.snapshot()["dense_fallback_waves"] >= 1
    assert all(e.num_devices == 2
               and e.stages.snapshot()["dense_fallback_waves"] >= 1
               for e in built.values())
    assert got == want


def _shard_descs(remote_mod, types_mod, path, meta, rung):
    gops = tuple(types_mod.GopSpec(index=i, start_frame=2 * i,
                                   num_frames=2) for i in range(1, 3))
    kw = dict(job_id="j", input_path=str(path), meta=meta, gops=gops,
              qp=_QP, gop_frames=2, timeout_s=60.0)
    gop = remote_mod.Shard(id="j-0001", **kw).descriptor()
    scaled = remote_mod.Shard(id="j-r-0001", rung="r",
                              rung_width=rung[0], rung_height=rung[1],
                              **kw).descriptor()
    band = remote_mod.Shard(id="j-band000", shape="band", band_start=0,
                            band_count=2, total_bands=2, halo_rows=32,
                            **kw).descriptor()
    band["band"]["groups"] = [[0, 2]]
    return {"gop": gop, "rung": scaled, "band": band}


def _smooth(n, w, h, seed):
    """tests/test_torch_job.py's smooth clip."""
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


@pytest.mark.parametrize("shape", ["gop", "rung", "band", "band-mesh"])
def test_encode_shard_parts_equal_the_reference_bytes(tmp_path, shape):
    """One descriptor, one clip: the port's worker-side encode (on the
    CPU) frames the reference's part bytes; "band-mesh" is the band
    shard's 2-band slice on a two-entry mesh. Precondition of the rung
    case, asserted first: on this clip the port's scaled planes equal
    JAX's (the float scaler's k + 1/2 ties may round the other way on
    other content, ROADMAP C)."""
    import torch

    from thinvids_tpu.abr.scale import PlaneScaler as JScaler
    from thinvids_tpu.ingest.decode import read_video as jread
    from thinvids_tpu.io.y4m import write_y4m
    from thinvids_tpu_torch.abr.scale import PlaneScaler as TScaler
    from thinvids_tpu_torch.ingest.decode import read_video as tread

    w, h, n = 64, 48, 8
    rung = (32, 24)
    clip = _smooth(n, w, h, seed=3)
    if shape == "rung":
        planes = [np.stack([f[k] for f in clip]) for k in range(3)]
        got = TScaler(w, h, *rung, device="cpu").scale_wave(
            *(torch.from_numpy(p) for p in planes))
        want = JScaler(w, h, *rung).scale_wave(*planes)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    path = tmp_path / "clip.y4m"
    write_y4m(str(path), _meta(jtypes, w, h, n), _frames(jtypes, clip))
    desc = shape.split("-")[0]
    jdesc = _shard_descs(jremote, jtypes, path, _meta(jtypes, w, h, n),
                         rung)[desc]
    tdesc = _shard_descs(tremote, ttypes, path, _meta(ttypes, w, h, n),
                         rung)[desc]
    assert tdesc == jdesc
    want = jremote.pack_parts(jremote.encode_shard(jdesc,
                                                   jread(str(path))[1]))
    got = tremote.pack_parts(tremote.encode_shard(
        tdesc, tread(str(path))[1], device="cpu",
        mesh=_TWO if shape == "band-mesh" else None))
    assert got == want


def test_wire_formats_frame_the_same_bytes():
    rng = np.random.default_rng(9)
    segs = []
    for i in range(3):
        sizes = tuple(int(x) for x in rng.integers(1, 40, 3))
        payload = rng.integers(0, 256, sum(sizes), dtype=np.uint8)
        segs.append((i, 4 * i, sizes, bytes(payload)))

    def packed(remote_mod, types_mod):
        return remote_mod.pack_parts([types_mod.EncodedSegment(
            gop=types_mod.GopSpec(index=i, start_frame=f0, num_frames=3),
            payload=p, frame_sizes=sz) for i, f0, sz, p in segs])

    assert packed(tremote, ttypes) == packed(jremote, jtypes)
    arrays = {"y": rng.integers(0, 256, (32, 64)).astype(np.int16),
              "cnt": rng.integers(0, 99, (65, 2)).astype(np.int32),
              "n": np.asarray([77], np.int64),
              "cost": rng.integers(-2**31, 2**31 - 1, 81).astype(np.int32)}
    assert thalo.pack_arrays(arrays) == jhalo.pack_arrays(arrays)
    back = thalo.unpack_arrays(jhalo.pack_arrays(arrays))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype


def test_a_worker_advertises_the_devices_it_encodes_on(monkeypatch):
    """A worker's heartbeat counts its mesh's entries, else its one
    device, whatever the host's card count: the coordinator plans band
    slices for the cards that run them."""
    import torch

    from thinvids_tpu_torch.core import devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(devices, "resolve_device",
                        lambda device="cuda": torch.device(device))
    url = "http://127.0.0.1:9"
    assert tremote.WorkerDaemon(url, device="cuda").metrics()[
        "worker_devices"] == 1
    assert tremote.WorkerDaemon(url, device="cpu", mesh=_TWO).metrics()[
        "worker_devices"] == 2
    assert tremote.WorkerDaemon(url, device="cpu").metrics()[
        "worker_devices"] == 1


def _http_json(base, path, body=None, timeout=30.0):
    import json
    import urllib.request

    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _poll(fn, cap_s, what):
    import time

    deadline = time.monotonic() + cap_s
    while time.monotonic() < deadline:
        try:
            got = fn()
        except OSError:
            got = None
        if got:
            return got
        time.sleep(0.2)
    raise AssertionError(f"{what} not within {cap_s:.0f} s")


def test_two_mesh_workers_encode_a_four_band_job_as_the_local_mp4(tmp_path):
    """The port's remote coordinator (a `cli coordinator` process) plans a
    sfe_bands 4 job for two in-process workers, each on a two-entry CPU
    mesh and so advertising 2 devices: one 2-band slice a worker, each
    slice's bands as one run an entry. The MP4 equals the local 4-band
    encode's, byte for byte."""
    import os
    import socket
    import subprocess
    import sys

    from thinvids_tpu_torch.cluster.agent import NodeAgent, http_submitter
    from thinvids_tpu_torch.ingest.decode import open_video
    from thinvids_tpu_torch.io.mp4 import mux_mp4
    from thinvids_tpu_torch.io.y4m import write_y4m
    from thinvids_tpu_torch.parallel.dispatch import SfeShardEncoder

    w, h, n, gop, qp = 64, 128, 12, 3, 30      # 8 MB rows: 4 bands of 2
    path = tmp_path / "clip.y4m"
    frames = _frames(ttypes, _gradient(w, h, n))
    write_y4m(str(path), _meta(ttypes, w, h, n), frames)
    with open_video(str(path)) as src:
        meta = src.meta
    want = mux_mp4(ttypes.concat_segments(SfeShardEncoder(
        meta, qp=qp, gop_frames=gop, bands=4, halo_rows=32,
        device="cpu").encode(frames)), meta)

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, TVT_MIN_IDLE_WORKERS="0",
               TVT_GOP_FRAMES=str(gop), TVT_QP=str(qp),
               TVT_METRICS_TTL_S="3", TVT_REMOTE_RETRY_BACKOFF_S="0.2",
               TVT_SCHEDULER_POLL_S="0.5", TVT_HALO_TIMEOUT_S="120",
               OMP_NUM_THREADS="1")
    coord = subprocess.Popen(
        [sys.executable, "-m", "thinvids_tpu_torch.cli", "coordinator",
         "--backend", "remote", "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port), "--state-dir", str(tmp_path / "state"),
         "--output-dir", str(tmp_path / "library")],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    stop = threading.Event()
    agents, loops, daemons = [], [], {}
    try:
        _poll(lambda: _http_json(base, "/health", timeout=2.0), 60,
              "the coordinator's API")
        for host in ("mesh-w0", "mesh-w1"):
            daemons[host] = tremote.WorkerDaemon(base, host=host, poll_s=0.1,
                                                 device="cpu", mesh=_TWO)
            agents.append(NodeAgent(
                http_submitter(base), host=host, interval_s=0.3,
                extra_metrics=daemons[host].metrics, device="cpu").start())
            loops.append(threading.Thread(
                target=daemons[host].run_forever, args=(stop,), daemon=True))
            loops[-1].start()
        _poll(lambda: all(
            _http_json(base, "/metrics_snapshot")["metrics"].get(host, {})
            .get("worker_devices") == 2 for host in daemons), 30,
            "both workers advertising 2 devices")
        _http_json(base, "/add_job", {"input_path": str(path),
                                      "settings": {"sfe_bands": 4}})
        job = _poll(lambda: next(
            (j for j in _http_json(base, "/jobs")["jobs"]
             if j["input_path"] == str(path)
             and j["status"] in ("done", "failed", "rejected")), None),
            120, "the farm job")
        assert job["status"] == "done", job.get("failure_reason")
        with open(job["output_path"], "rb") as fp:
            got = fp.read()
        assert {h: d.shards_done for h, d in daemons.items()} == \
            {"mesh-w0": 1, "mesh-w1": 1}
        assert got == want
    finally:
        stop.set()
        for agent in agents:
            agent.stop()
        for loop in loops:
            loop.join(30)
        coord.terminate()
        try:
            coord.wait(30)
        except subprocess.TimeoutExpired:
            coord.kill()
            coord.wait(10)
    assert not any(loop.is_alive() for loop in loops)
