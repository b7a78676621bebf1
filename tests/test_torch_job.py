"""Port parity for the transcode job path: settings-built encoders, the
transfer and pack backends, and a whole job through the reference's
executor with the port's encoder.

- `compact_transfer=False` and `pack_backend=process` give the default
  transfer's bytes (and the JAX package's), the sidecars really take the
  GOPs, and a broken sidecar pool degrades to an inline pack of the same
  spool;
- `make_shard_encoder` resolves the knobs the reference resolves, and
  raises NotImplementedError for the shapes that are not ported;
- a y4m job run by `LocalExecutor` with the port's encoder writes the MP4
  the JAX executor writes (both on one device), and the port-only
  composition (port open_video → port encoder → port mux) writes the
  same bytes.

Every test that starts pack sidecars shuts them down in a `finally`,
waiting a bounded time.
"""

import dataclasses
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from thinvids_tpu.cluster import Coordinator, WorkerRegistry
from thinvids_tpu.cluster.executor import LocalExecutor
from thinvids_tpu.core import config as jcfg
from thinvids_tpu.core.status import Status
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.core.types import concat_segments as jconcat
from thinvids_tpu.ingest import decode as jdecode
from thinvids_tpu.io.y4m import write_y4m
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu_torch.core import config as tcfg
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import GopSpec, SegmentPlan
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.core.types import concat_segments as tconcat
from thinvids_tpu_torch.ingest import decode as tdecode
from thinvids_tpu_torch.io import mp4 as tmp4
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _one_device_mesh():
    return jdispatch.default_mesh(jax.devices()[:1])


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


def _noise_clip(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n)]


def _shutdown_sidecars(enc):
    """Stop an encoder's pack sidecars, waiting at most 30 s for each."""
    pool = enc._proc_pool
    if pool is None or not hasattr(pool, "shutdown"):
        return
    procs = list((getattr(pool, "_processes", None) or {}).values())
    pool.shutdown(wait=False, cancel_futures=True)
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()


def _jax_stream(clip, w, h, qp, gop, **kw):
    enc = jdispatch.GopShardEncoder(
        JMeta(width=w, height=h, num_frames=len(clip)), qp=qp,
        gop_frames=gop, mesh=_one_device_mesh(), **kw)
    return jconcat(enc.encode([JFrame(*f) for f in clip]))


def _port_encoder(clip, w, h, qp, gop, **kw):
    return tdispatch.GopShardEncoder(
        TMeta(width=w, height=h, num_frames=len(clip)), qp=qp,
        gop_frames=gop, device="cpu", **kw)


# ---- transfer and pack backends ---------------------------------------------

@pytest.mark.parametrize("kind,qp", [("smooth", 27), ("noise", 20)])
def test_sparse2_transfer_gives_the_default_bytes(kind, qp):
    w, h = 80, 48
    clip = (_smooth_clip if kind == "smooth" else _noise_clip)(8, w, h, 2)
    frames = [TFrame(*f) for f in clip]
    base_enc = _port_encoder(clip, w, h, qp, 4)
    base = tconcat(base_enc.encode(frames))
    enc = _port_encoder(clip, w, h, qp, 4, compact_transfer=False)
    assert enc.compact_transfer is False
    assert tconcat(enc.encode(frames)) == base
    assert base == _jax_stream(clip, w, h, qp, 4, compact_transfer=False)
    fell = enc.stages.snapshot()["dense_fallback_waves"]
    assert fell == base_enc.stages.snapshot()["dense_fallback_waves"]
    assert fell == (1 if kind == "noise" else 0)


def test_process_backend_gives_the_default_bytes():
    w, h = 64, 48
    clip = _smooth_clip(12, w, h, seed=6)
    frames = [TFrame(*f) for f in clip]
    base = tconcat(_port_encoder(clip, w, h, 27, 3).encode(frames))
    enc = _port_encoder(clip, w, h, 27, 3, pack_workers=2,
                        pack_backend="process")
    try:
        assert enc._proc_pool is not None
        assert tconcat(enc.encode(frames)) == base
        # the sidecars took every GOP (not a quiet thread fallback)
        assert enc.stages.snapshot()["proc_pack_gops"] == 4
        assert enc._proc_pool is not None
    finally:
        _shutdown_sidecars(enc)
    assert base == _jax_stream(clip, w, h, 27, 3)


def test_process_backend_packs_dense_waves_and_intra_on_threads():
    w, h = 64, 48
    clip = _noise_clip(8, w, h, seed=5)
    frames = [TFrame(*f) for f in clip]
    base = tconcat(_port_encoder(clip, w, h, 27, 2).encode(frames))
    enc = _port_encoder(clip, w, h, 27, 2, pack_backend="process")
    try:
        assert tconcat(enc.encode(frames)) == base
        snap = enc.stages.snapshot()
        assert snap["dense_fallback_waves"] >= 1
        assert snap["proc_pack_gops"] == 0
    finally:
        _shutdown_sidecars(enc)
    # the all-intra encoder never starts sidecars, as in the reference
    intra = _port_encoder(clip, w, h, 27, 2, inter=False,
                          pack_backend="process")
    assert intra._proc_pool is None


def test_broken_pool_degrades_to_inline_pack(caplog):
    from concurrent.futures import Future
    from concurrent.futures.process import BrokenProcessPool

    w, h = 64, 48
    clip = _smooth_clip(12, w, h, seed=7)
    frames = [TFrame(*f) for f in clip]
    base = tconcat(_port_encoder(clip, w, h, 27, 3).encode(frames))

    class BrokenPool:
        def submit(self, fn, *args):
            fut = Future()
            fut.set_exception(BrokenProcessPool("child died"))
            return fut

    enc = _port_encoder(clip, w, h, 27, 3, pack_backend="process")
    _shutdown_sidecars(enc)
    enc._proc_pool = BrokenPool()
    with caplog.at_level(logging.WARNING):
        assert tconcat(enc.encode(frames)) == base
    assert enc._proc_pool is None       # retired after the first break
    # counted (the GOPs were handed to the sidecar path) and logged once
    assert enc.stages.snapshot()["proc_pack_gops"] >= 1
    assert sum("pack sidecar pool broke" in r.getMessage()
               for r in caplog.records) == 1


def test_packproc_imports_without_torch():
    code = ("import sys; import thinvids_tpu_torch.parallel.packproc as p; "
            "assert callable(p.pack_gop_from_shm); "
            "assert 'torch' not in sys.modules, 'packproc pulled torch in'; "
            "assert 'jax' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


# ---- settings resolution -------------------------------------------------------

def _settings(cfg, **over):
    return cfg.Settings(values=dict(cfg.DEFAULT_SETTINGS, **over))


_KNOBS = ("qp", "gop_frames", "max_segments", "inter", "gops_per_wave",
          "pack_workers", "pipeline_window", "decode_ahead",
          "compact_transfer", "pack_backend", "gop_index_offset",
          "frame_offset", "plan_override", "gop_qp")


@pytest.mark.parametrize("env", [
    {},
    {"TVT_PACK_WORKERS": "3", "TVT_PIPELINE_WINDOW": "2",
     "TVT_DECODE_AHEAD": "5", "TVT_COMPACT_TRANSFER": "0"},
    {"TVT_PACK_BACKEND": "process", "TVT_PIPELINE_WINDOW": "junk",
     "TVT_AQ_STRENGTH": "0.1"}])
def test_make_shard_encoder_resolves_the_reference_knobs(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tcfg.invalidate_settings_cache()
    jcfg.invalidate_settings_cache()
    encs = []
    try:
        for qp in (None, 35):
            over = dict(qp=31, gop_frames=5, max_segments=7)
            tenc = tdispatch.make_shard_encoder(
                TMeta(width=64, height=48), _settings(tcfg, **over), None,
                qp=qp, device="cpu")
            encs.append(tenc)
            jenc = jdispatch.make_shard_encoder(
                JMeta(width=64, height=48), _settings(jcfg, **over),
                _one_device_mesh(), qp=qp)
            for k in _KNOBS:
                assert getattr(tenc, k) == getattr(jenc, k), k
            assert dataclasses.asdict(tenc.rd) == dataclasses.asdict(jenc.rd)
            assert dataclasses.asdict(tenc.sps) == dataclasses.asdict(jenc.sps)
            assert dataclasses.asdict(tenc.pps) == dataclasses.asdict(jenc.pps)
            assert tenc.num_devices == jenc.num_devices == 1
            assert [dataclasses.astuple(g) for g in tenc.plan(23).gops] == \
                [dataclasses.astuple(g) for g in jenc.plan(23).gops]
    finally:
        for enc in encs:
            _shutdown_sidecars(enc)
        for k in env:
            monkeypatch.delenv(k)
        tcfg.invalidate_settings_cache()
        jcfg.invalidate_settings_cache()


@pytest.mark.parametrize("case,item", [
    ("mode_decision", "A7"), ("pskip", "A7"), ("deblock", "A7"),
    ("aq_strength", "A7"), ("sfe_bands", "A11"), ("shape_band", "A11"),
    ("rungs", "A9"), ("band_range", "A12"), ("total_bands", "A12"),
    ("mesh", "A2")])
def test_make_shard_encoder_refuses_what_is_not_ported(case, item):
    over, kw = {}, {}
    if case in ("mode_decision", "pskip", "deblock"):
        over[case] = True
    elif case == "aq_strength":
        over[case] = 1.0
    elif case == "sfe_bands":
        over[case] = 2
    elif case == "shape_band":
        kw["shape"] = "band"
    elif case == "rungs":
        kw["rungs"] = [object()]
    elif case == "band_range":
        kw["band_range"] = (0, 1)
    elif case == "total_bands":
        kw["total_bands"] = 2
    else:
        kw["mesh"] = object()
    with pytest.raises(NotImplementedError, match=item):
        tdispatch.make_shard_encoder(TMeta(width=64, height=48),
                                     _settings(tcfg, **over),
                                     device="cpu", **kw)


def test_encoder_refuses_rd_features_from_the_settings_tier(monkeypatch):
    with pytest.raises(ValueError, match="unknown shard shape"):
        tdispatch.make_shard_encoder(TMeta(width=64, height=48),
                                     _settings(tcfg), shape="ring",
                                     device="cpu")
    monkeypatch.setenv("TVT_DEBLOCK", "1")
    tcfg.invalidate_settings_cache()
    try:
        with pytest.raises(NotImplementedError, match="A7"):
            tdispatch.GopShardEncoder(TMeta(width=64, height=48),
                                      device="cpu")
    finally:
        monkeypatch.delenv("TVT_DEBLOCK")
        tcfg.invalidate_settings_cache()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdispatch.make_shard_encoder(TMeta(width=64, height=48),
                                         _settings(tcfg))


# ---- offsets, plan override, foreign frames ----------------------------------

@pytest.mark.parametrize("inter", [True, False])
def test_offsets_and_plan_override_match(inter):
    w, h, n = 64, 48, 9
    clip = _smooth_clip(n, w, h, seed=12)
    jenc = jdispatch.GopShardEncoder(
        JMeta(width=w, height=h, num_frames=n), qp=28, gop_frames=3,
        inter=inter, mesh=_one_device_mesh())
    tenc = _port_encoder(clip, w, h, 28, 3, inter=inter)
    for enc in (jenc, tenc):
        enc.gop_index_offset, enc.frame_offset = 4, 14
    jsegs = jenc.encode([JFrame(*f) for f in clip])
    tsegs = tenc.encode([TFrame(*f) for f in clip])
    assert [dataclasses.astuple(s.gop) for s in tsegs] == \
        [dataclasses.astuple(s.gop) for s in jsegs]
    assert [s.gop.index for s in tsegs] == [4, 5, 6]
    assert [s.payload for s in tsegs] == [s.payload for s in jsegs]
    # an external plan replaces the planner: its GOP boundaries are kept
    plan = SegmentPlan(gops=(GopSpec(0, 0, 5), GopSpec(1, 5, 4)),
                       num_devices=1, frames_per_gop=5)
    tenc2 = _port_encoder(clip, w, h, 28, 3, inter=inter)
    tenc2.plan_override = plan
    assert tenc2.plan(n) is plan
    segs = tenc2.encode([TFrame(*f) for f in clip])
    assert [len(s.frame_sizes) for s in segs] == [5, 4]


def test_reference_frame_source_passes_the_port_cursor(tmp_path):
    """Frames from the JAX package's ingest carry its own ChromaFormat
    enum; the port's staging takes them as 4:2:0 by value."""
    w, h, n = 64, 48, 6
    clip = _smooth_clip(n, w, h, seed=13)
    path = tmp_path / "clip.y4m"
    write_y4m(path, JMeta(width=w, height=h, num_frames=n),
              [JFrame(*f) for f in clip])
    base = tconcat(_port_encoder(clip, w, h, 27, 3).encode(
        [TFrame(*f) for f in clip]))
    with jdecode.open_video(path) as src:
        assert type(src[0].chroma).__module__.startswith("thinvids_tpu.")
        got = tconcat(_port_encoder(clip, w, h, 27, 3).encode(src))
    assert got == base
    bad = [TFrame(y=f[0], u=f[0], v=f[0]) for f in clip]     # 4:4:4
    with pytest.raises(ValueError, match="4:2:0"):
        _port_encoder(clip, w, h, 27, 3).encode(bad)


# ---- the job -------------------------------------------------------------------

def _make_rig(tmp_path, name, **executor_kw):
    snap = jcfg.Settings(values=dict(jcfg.DEFAULT_SETTINGS, gop_frames=4,
                                     qp=30, heartbeat_throttle_s=0.0))
    reg = WorkerRegistry()
    for i in range(8):
        reg.heartbeat(f"w{i:02d}")
    coord = Coordinator(registry=reg, settings_fn=lambda: snap)
    execu = LocalExecutor(coord, output_dir=str(tmp_path / name),
                          sync=True, **executor_kw)
    coord._launcher = execu.launch
    return coord


def _run_job(coord, path, w, h, n):
    job = coord.add_job(str(path), JMeta(width=w, height=h, num_frames=n))
    job = coord.store.get(job.id)
    assert job.status is Status.DONE, job.failure_reason
    with open(job.output_path, "rb") as fp:
        return job, fp.read()


@pytest.mark.parametrize("w,h,n", [(64, 48, 12), (80, 40, 10)])
def test_job_through_the_reference_executor_writes_its_mp4(tmp_path, w, h, n):
    clip = _smooth_clip(n, w, h, seed=w + n)
    path = tmp_path / "clip.y4m"
    write_y4m(path, JMeta(width=w, height=h, fps_num=30, num_frames=n),
              [JFrame(*f) for f in clip])
    built = []

    def factory(meta, settings, mesh):
        enc = tdispatch.make_shard_encoder(meta, settings, None,
                                           device="cpu")
        built.append(enc)
        return enc

    port_job, port_mp4 = _run_job(
        _make_rig(tmp_path, "port", encoder_factory=factory), path, w, h, n)
    ref_job, ref_mp4 = _run_job(
        _make_rig(tmp_path, "ref", mesh=_one_device_mesh()), path, w, h, n)
    assert len(built) == 1 and built[0].gop_frames == 4 and built[0].qp == 30
    assert port_job.parts_total == ref_job.parts_total == -(-n // 4)
    assert port_job.parts_done == port_job.parts_total
    assert port_mp4 == ref_mp4
    assert port_job.output_bytes == len(port_mp4)

    # the port alone: port ingest → port encoder → port concat → port mux
    settings = tcfg.Settings(values=dict(tcfg.DEFAULT_SETTINGS, gop_frames=4,
                                         qp=30))
    with tdecode.open_video(path) as src:
        enc = tdispatch.make_shard_encoder(src.meta, settings, device="cpu")
        data = tmp4.mux_mp4(tconcat(enc.encode(src)), src.meta,
                            audio=src.audio)
    assert data == ref_mp4
