"""Port parity for the transcode job path: settings-built encoders, the
transfer and pack backends, and a whole job through the reference's
executor with the port's encoder.

- `compact_transfer=False` and `pack_backend=process` give the default
  transfer's bytes (and the JAX package's), the sidecars really take the
  GOPs, and a broken sidecar pool degrades to an inline pack of the same
  spool;
- `make_shard_encoder` resolves the knobs the reference resolves (the RD
  features included, each of which gives the JAX package's bytes), builds
  the farm's band slice as the reference does, and raises TypeError for
  a mesh that is not a DeviceMesh (the mesh itself runs in
  tests/test_torch_mesh.py);
- every RD feature on (RD_ALL) through GopShardEncoder gives the JAX
  package's per-GOP `encode_gop` bytes with the compact, sparse2 and
  process pack backends, and the all-intra wave with mode decision + AQ
  gives the JAX wave's bytes;
- `sfe_bands > 0` or shape="band" builds the port's SfeShardEncoder with
  the reference's band layout and bytes;
- a y4m job run by `LocalExecutor` with the port's encoder writes the MP4
  the JAX executor writes (both on one device, RD off and with
  `TVT_MODE_DECISION=1 TVT_DEBLOCK=1`; split-frame with `sfe_bands=3`,
  the reference's bands on three devices), and the port-only composition
  (port open_video → port encoder → port mux) writes the same bytes.

Every test that starts pack sidecars shuts them down in a `finally`,
waiting a bounded time.
"""

import contextlib
import dataclasses
import logging
import os
import subprocess
import sys

import functools

import numpy as np
import pytest

import jax
import torch

from bench import make_frames
from thinvids_tpu.cluster import Coordinator, WorkerRegistry
from thinvids_tpu.cluster.executor import LocalExecutor
from thinvids_tpu.codecs.h264 import encoder as jencoder
from thinvids_tpu.codecs.h264 import rdo as jrdo
from thinvids_tpu.core import config as jcfg
from thinvids_tpu.core.status import Status
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.core.types import concat_segments as jconcat
from thinvids_tpu.ingest import decode as jdecode
from thinvids_tpu.io.y4m import write_y4m
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
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


@pytest.mark.parametrize("case,item", [("mesh", "A2")])
def test_make_shard_encoder_refuses_what_is_not_ported(case, item):
    over, kw = {}, {}
    # ROADMAP A2 (the mesh) is ported: what is refused is a mesh that is
    # not a DeviceMesh, never dropped in favour of one card
    kw["mesh"] = object()
    for shape in (None, "band"):
        with pytest.raises(TypeError, match="DeviceMesh"):
            tdispatch.make_shard_encoder(TMeta(width=64, height=48),
                                         _settings(tcfg, **over),
                                         shape=shape, device="cpu", **kw)


@pytest.mark.parametrize("case", ["band_range", "total_bands"])
def test_make_shard_encoder_builds_the_farm_slice(case):
    """`band_range` / `total_bands` with the band shape give the port's
    FarmBandEncoder over the reference's slice of the reference's global
    layout (a slice with neighbours needs the halo session, as the
    reference's does); with the GOP shape they are ignored, as there."""
    from thinvids_tpu.parallel import sfefarm as jsfefarm
    from thinvids_tpu_torch.parallel import sfefarm as tsfefarm

    kw = dict(total_bands=3)
    if case == "band_range":
        kw.update(band_range=(1, 3), session=object())
    meta = dict(width=64, height=96)
    tenc = tdispatch.make_shard_encoder(TMeta(**meta), _settings(tcfg),
                                        shape="band", halo_rows=16,
                                        device="cpu", **kw)
    jenc = jdispatch.make_shard_encoder(JMeta(**meta), _settings(jcfg),
                                        None, shape="band", halo_rows=16,
                                        **kw)
    assert isinstance(tenc, tsfefarm.FarmBandEncoder)
    assert isinstance(jenc, jsfefarm.FarmBandEncoder)
    for attr in ("global_band_plan", "band_plan"):
        assert dataclasses.astuple(getattr(tenc, attr)) == \
            dataclasses.astuple(getattr(jenc, attr))
    assert (tenc.band_lo, tenc.band_hi, tenc.edge_top, tenc.edge_bot,
            tenc.halo_rows, tenc.session) == \
        (jenc.band_lo, jenc.band_hi, jenc.edge_top, jenc.edge_bot,
         jenc.halo_rows, jenc.session)
    if case == "band_range":
        with pytest.raises(ValueError, match="halo session"):
            tdispatch.make_shard_encoder(
                TMeta(**meta), _settings(tcfg), shape="band",
                device="cpu", total_bands=3, band_range=(1, 3))
    gop = tdispatch.make_shard_encoder(TMeta(**meta), _settings(tcfg),
                                       device="cpu", **kw)
    assert type(gop) is tdispatch.GopShardEncoder


@pytest.mark.parametrize("shape", [None, "band"])
def test_make_shard_encoder_builds_the_ladder(shape):
    """`rungs` gives the port's LadderShardEncoder (whatever the shape, as
    the reference's seam does) with the settings' gop_frames and
    max_segments on every rung encoder, and the reference's rung set."""
    from thinvids_tpu.abr import ladder as jladder
    from thinvids_tpu_torch.abr import ladder as tladder

    over = dict(qp=31, gop_frames=5, max_segments=7, ladder_rungs="32,24")
    tmeta, jmeta = TMeta(width=64, height=48), JMeta(width=64, height=48)
    trungs = tladder.plan_ladder(tmeta, _settings(tcfg, **over))
    tenc = tdispatch.make_shard_encoder(tmeta, _settings(tcfg, **over), None,
                                        shape=shape, rungs=trungs,
                                        device="cpu")
    jenc = jdispatch.make_shard_encoder(
        jmeta, _settings(jcfg, **over), _one_device_mesh(), shape=shape,
        rungs=jladder.plan_ladder(jmeta, _settings(jcfg, **over)))
    assert type(tenc) is tladder.LadderShardEncoder
    assert [dataclasses.astuple(r) for r in tenc.rungs] == \
        [dataclasses.astuple(r) for r in jenc.rungs]
    assert len(tenc.encoders) == len(jenc.encoders) == 3
    for te, je in zip(tenc.encoders, jenc.encoders):
        for k in ("qp", "gop_frames", "max_segments", "gops_per_wave"):
            assert getattr(te, k) == getattr(je, k), k
        assert dataclasses.asdict(te.sps) == dataclasses.asdict(je.sps)
        assert te.device.type == "cpu"
    assert [s is None for s in tenc.scalers] == [True, False, False]
    assert [dataclasses.astuple(g) for g in tenc.plan(23).gops] == \
        [dataclasses.astuple(g) for g in jenc.plan(23).gops]


@pytest.mark.parametrize("case", ["sfe_bands", "shape_band"])
def test_make_shard_encoder_builds_the_band_shape(case):
    """`sfe_bands > 0` or shape="band" gives the port's SfeShardEncoder
    with the reference's band layout, halo and knobs, and its bytes."""
    over, kw = dict(qp=29, gop_frames=3, sfe_halo_rows=16), {}
    if case == "sfe_bands":
        over["sfe_bands"] = 3
    else:
        over["sfe_bands"] = 0
        kw["shape"] = "band"
    w, h = 64, 96
    tenc = tdispatch.make_shard_encoder(TMeta(width=w, height=h),
                                        _settings(tcfg, **over), None,
                                        device="cpu", **kw)
    # the reference caps the bands at its devices; bands=0 is one a device
    jmesh = jdispatch.default_mesh(jax.devices()[:3 if case == "sfe_bands"
                                                 else 1])
    jenc = jdispatch.make_shard_encoder(JMeta(width=w, height=h),
                                        _settings(jcfg, **over), jmesh, **kw)
    assert type(tenc) is tdispatch.SfeShardEncoder
    assert tenc.num_bands == jenc.num_bands == (3 if case == "sfe_bands"
                                                else 1)
    assert tenc.halo_rows == jenc.halo_rows == 16
    assert dataclasses.astuple(tenc.band_plan) == \
        dataclasses.astuple(jenc.band_plan)
    for k in ("qp", "gop_frames", "max_segments"):
        assert getattr(tenc, k) == getattr(jenc, k), k
    clip = _smooth_clip(6, w, h, seed=41)
    assert tconcat(tenc.encode([TFrame(*f) for f in clip])) == \
        jconcat(jenc.encode([JFrame(*f) for f in clip]))


_RD_ENV = {"mode_decision": ("TVT_MODE_DECISION", "1", True),
           "pskip": ("TVT_PSKIP", "1", True),
           "deblock": ("TVT_DEBLOCK", "1", True),
           "aq_strength": ("TVT_AQ_STRENGTH", "1.0", 1.0)}


@contextlib.contextmanager
def _process_settings(monkeypatch, env: dict):
    """Both packages' process settings snapshots with `env` set."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tcfg.invalidate_settings_cache()
    jcfg.invalidate_settings_cache()
    try:
        yield
    finally:
        for k in env:
            monkeypatch.delenv(k)
        tcfg.invalidate_settings_cache()
        jcfg.invalidate_settings_cache()


def _rd_clip():
    w, h = 64, 48
    return _smooth_clip(8, w, h, seed=31), w, h


@pytest.mark.parametrize("case", ["mode_decision", "pskip", "deblock",
                                  "aq_strength"])
def test_make_shard_encoder_encodes_each_rd_knob_as_the_reference(
        monkeypatch, case):
    """Each RD knob on — in the job's settings and in the process
    snapshot, which is where both packages' GopShardEncoder reads it —
    resolves the same RdConfig and gives the JAX package's bytes."""
    env_key, env_val, value = _RD_ENV[case]
    clip, w, h = _rd_clip()
    with _process_settings(monkeypatch, {env_key: env_val}):
        over = dict(gop_frames=4, qp=28, **{case: value})
        tenc = tdispatch.make_shard_encoder(
            TMeta(width=w, height=h), _settings(tcfg, **over), None,
            device="cpu")
        jenc = jdispatch.make_shard_encoder(
            JMeta(width=w, height=h), _settings(jcfg, **over),
            _one_device_mesh())
        assert dataclasses.asdict(tenc.rd) == dataclasses.asdict(jenc.rd)
        assert tenc.rd != trdo.RD_OFF
        got = tconcat(tenc.encode([TFrame(*f) for f in clip]))
        assert got == jconcat(jenc.encode([JFrame(*f) for f in clip]))


def test_encoder_refuses_rd_features_from_the_settings_tier(monkeypatch):
    """Not refused any more: TVT_DEBLOCK=1 resolves the same RdConfig in
    both packages' GopShardEncoder and the same stream; an unknown
    shape and a missing card are still refused."""
    with pytest.raises(ValueError, match="unknown shard shape"):
        tdispatch.make_shard_encoder(TMeta(width=64, height=48),
                                     _settings(tcfg), shape="ring",
                                     device="cpu")
    clip, w, h = _rd_clip()
    with _process_settings(monkeypatch, {"TVT_DEBLOCK": "1"}):
        tenc = tdispatch.GopShardEncoder(TMeta(width=w, height=h), qp=28,
                                         gop_frames=4, device="cpu")
        jenc = jdispatch.GopShardEncoder(JMeta(width=w, height=h), qp=28,
                                         gop_frames=4,
                                         mesh=_one_device_mesh())
        assert tenc.rd == trdo.RdConfig(deblock=True)
        assert dataclasses.asdict(tenc.rd) == dataclasses.asdict(jenc.rd)
        assert tconcat(tenc.encode([TFrame(*f) for f in clip])) == \
            jconcat(jenc.encode([JFrame(*f) for f in clip]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdispatch.make_shard_encoder(TMeta(width=64, height=48),
                                         _settings(tcfg))


# ---- RD configs through the transfer and pack backends -----------------------

_RD_ALL = dict(mode_decision=True, pskip=True, deblock=True,
               aq_q=jrdo.aq_from_strength(1.0))


@functools.lru_cache(maxsize=None)
def _jax_rd_gops(w, h, n, gop):
    """The JAX package's per-GOP encode_gop streams of the RD_ALL clip,
    concatenated (GopShardEncoder's segments, as tests/test_rdo.py
    pins them)."""
    frames = make_frames(n, w, h)
    meta = JMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n)
    return b"".join(
        jencoder.encode_gop(frames[g:g + gop], meta, qp=27,
                            idr_pic_id=g // gop, with_headers=True,
                            return_recon=True,
                            rd=jrdo.RdConfig(**_RD_ALL))[0]
        for g in range(0, n, gop))


@pytest.mark.parametrize("backend", ["compact", "sparse2", "process"])
def test_rd_all_through_the_shard_encoder_matches(backend):
    w, h, n, gop = 96, 80, 8, 4
    frames = [TFrame(y=f.y, u=f.u, v=f.v) for f in make_frames(n, w, h)]
    kw = {"sparse2": dict(compact_transfer=False),
          "process": dict(pack_backend="process", pack_workers=2)
          }.get(backend, {})
    enc = tdispatch.GopShardEncoder(
        TMeta(width=w, height=h, fps_num=30, fps_den=1, num_frames=n),
        qp=27, gop_frames=gop, rd=trdo.RdConfig(**_RD_ALL), device="cpu",
        **kw)
    try:
        got = tconcat(enc.encode_waves(enc.stage_waves(frames)))
        snap = enc.stages.snapshot()
    finally:
        _shutdown_sidecars(enc)
    assert got == _jax_rd_gops(w, h, n, gop)
    assert snap["dense_fallback_waves"] == 0
    # the sidecars took both GOPs (not a quiet thread fallback)
    assert snap["proc_pack_gops"] == (2 if backend == "process" else 0)


def test_intra_wave_with_mode_decision_and_aq_matches():
    w, h, n = 96, 80, 4
    clip = _smooth_clip(n, w, h, seed=17)
    kw = dict(mode_decision=True, aq_q=4)
    tenc = _port_encoder(clip, w, h, 27, 2, inter=False,
                         rd=trdo.RdConfig(**kw))
    jenc = jdispatch.GopShardEncoder(
        JMeta(width=w, height=h, num_frames=n), qp=27, gop_frames=2,
        inter=False, mesh=_one_device_mesh(), rd=jrdo.RdConfig(**kw))
    tsegs = tenc.encode([TFrame(*f) for f in clip])
    jsegs = jenc.encode([JFrame(*f) for f in clip])
    assert [s.frame_sizes for s in tsegs] == [s.frame_sizes for s in jsegs]
    assert tconcat(tsegs) == jconcat(jsegs)
    assert tenc.stages.snapshot()["dense_fallback_waves"] == 0


def test_deblock_needs_the_inter_path():
    meta = dict(width=64, height=48)
    for mod, Meta, rdc, extra in (
            (tdispatch, TMeta, trdo.RdConfig, dict(device="cpu")),
            (jdispatch, JMeta, jrdo.RdConfig,
             dict(mesh=_one_device_mesh()))):
        with pytest.raises(ValueError, match="deblock requires the inter"):
            mod.GopShardEncoder(Meta(**meta), inter=False,
                                rd=rdc(deblock=True), **extra)
        # the intra RD features are fine there
        mod.GopShardEncoder(Meta(**meta), inter=False,
                            rd=rdc(mode_decision=True, aq_q=4), **extra)


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

def _make_rig(tmp_path, name, settings=None, **executor_kw):
    snap = jcfg.Settings(values=dict(jcfg.DEFAULT_SETTINGS, gop_frames=4,
                                     qp=30, heartbeat_throttle_s=0.0,
                                     **(settings or {})))
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


def test_rd_job_through_the_reference_executor_writes_its_mp4(
        tmp_path, monkeypatch):
    """TVT_MODE_DECISION=1 TVT_DEBLOCK=1: both executors' encoders take
    the RD features from the process snapshot; the port's MP4 is the
    JAX executor's."""
    w, h, n = 64, 48, 8
    clip = _smooth_clip(n, w, h, seed=23)
    path = tmp_path / "clip.y4m"
    write_y4m(path, JMeta(width=w, height=h, fps_num=30, num_frames=n),
              [JFrame(*f) for f in clip])
    built = []

    def factory(meta, settings, mesh):
        enc = tdispatch.make_shard_encoder(meta, settings, None,
                                           device="cpu")
        built.append(enc)
        return enc

    with _process_settings(monkeypatch, {"TVT_MODE_DECISION": "1",
                                         "TVT_DEBLOCK": "1"}):
        port_job, port_mp4 = _run_job(
            _make_rig(tmp_path, "port", encoder_factory=factory), path, w,
            h, n)
        ref_job, ref_mp4 = _run_job(
            _make_rig(tmp_path, "ref", mesh=_one_device_mesh()), path, w,
            h, n)
    assert [e.rd for e in built] == [trdo.RdConfig(mode_decision=True,
                                                   deblock=True)]
    assert port_job.parts_total == ref_job.parts_total == 2
    assert port_mp4 == ref_mp4


def test_sfe_job_through_the_reference_executor_writes_its_mp4(tmp_path):
    """sfe_bands=3: the reference's LocalExecutor with the port's
    make_shard_encoder runs the split-frame encoder (three band slices
    a picture, on one device) and writes the MP4 the JAX executor
    writes with one band on each of three devices."""
    w, h, n = 64, 96, 8
    clip = _smooth_clip(n, w, h, seed=43)
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
        _make_rig(tmp_path, "port", settings=dict(sfe_bands=3),
                  encoder_factory=factory),
        path, w, h, n)
    ref_job, ref_mp4 = _run_job(
        _make_rig(tmp_path, "ref", settings=dict(sfe_bands=3)), path, w, h,
        n)
    assert [type(e) for e in built] == [tdispatch.SfeShardEncoder]
    assert built[0].num_bands == 3 and built[0].qp == 30
    assert port_job.parts_done == port_job.parts_total == 2
    assert ref_job.parts_total == 2
    assert port_mp4 == ref_mp4
    # three slices a picture, in the MP4's samples
    _, _, samples, keys = tmp4.annexb_to_samples(tconcat(
        built[0].encode([TFrame(*f) for f in clip])))
    assert len(samples) == n and keys == [True, False, False, False] * 2


def test_vbr2pass_job_through_the_reference_executor_writes_its_mp4(
        tmp_path, monkeypatch):
    """rc_mode=vbr2pass with a bitrate target: an executor whose
    `_encode_vbr2pass` runs the port's rc.encode_vbr2pass (the reference's
    loop, the executor's retry wrapper around every pass) with the port's
    encoder writes the JAX executor's MP4. The reference's complexity
    program raises during the port's run, so the port's analysis ran."""
    from thinvids_tpu.parallel import rc as jrc
    from thinvids_tpu_torch.parallel import rc as trc

    w, h, n = 64, 48, 16
    clip = _smooth_clip(n, w, h, seed=29)
    path = tmp_path / "clip.y4m"
    write_y4m(path, JMeta(width=w, height=h, fps_num=30, num_frames=n),
              [JFrame(*f) for f in clip])
    runs = []

    class PortRcExecutor(LocalExecutor):
        def _encode_vbr2pass(self, job, token, enc, frames, settings, meta,
                             target_kbps):
            segments, stats = trc.encode_vbr2pass(
                frames, meta, target_kbps, base_qp=int(settings.qp),
                enc=enc, encode_fn=lambda e: self._encode_with_retry(
                    job, token, e, frames, settings, allow_replan=False),
                aq_strength=float(settings.get("aq_strength", 0.0) or 0.0))
            runs.append((enc, stats))
            return segments

    def refuse(*a, **k):
        raise AssertionError("the reference's complexity program ran")

    rc_settings = dict(rc_mode="vbr2pass", target_bitrate_kbps=150.0)
    coord = _make_rig(tmp_path, "port", settings=rc_settings)
    execu = PortRcExecutor(
        coord, output_dir=str(tmp_path / "port"), sync=True,
        encoder_factory=lambda m, s, mesh: tdispatch.make_shard_encoder(
            m, s, None, device="cpu"))
    coord._launcher = execu.launch
    with monkeypatch.context() as mp:
        mp.setattr(jrc, "_complexity_stats", refuse)
        port_job, port_mp4 = _run_job(coord, path, w, h, n)
    ref_job, ref_mp4 = _run_job(
        _make_rig(tmp_path, "ref", settings=rc_settings,
                  mesh=_one_device_mesh()), path, w, h, n)
    (enc, stats), = runs
    assert type(enc) is tdispatch.GopShardEncoder
    assert stats["passes"] >= 3 and stats["gop_qps"] != [30] * 4
    assert enc.gop_qp == dict(enumerate(stats["gop_qps"]))
    assert port_job.parts_done == port_job.parts_total == ref_job.parts_total
    assert port_mp4 == ref_mp4


def test_ladder_job_through_the_reference_executor_writes_its_hls(
        tmp_path, monkeypatch):
    """A `.ladder.y4m` job: an executor whose `_encode_ladder` plans with
    the port's plan_ladder and encodes with the port's
    make_shard_encoder(rungs=) writes the JAX executor's HLS tree, names
    and bytes. The reference's LadderShardEncoder.dispatch_wave raises
    during the port's run, so the port's fan-out ran. Precondition,
    asserted first: on this clip the port's scaled planes equal the JAX
    package's (a sample that lands exactly on a half may round the other
    way in another summation order; tests/test_torch_abr.py holds the
    rungs given the same planes)."""
    from thinvids_tpu.abr import ladder as jladder
    from thinvids_tpu.abr.scale import PlaneScaler as JScaler
    from thinvids_tpu_torch.abr import ladder as tladder
    from thinvids_tpu_torch.abr.scale import PlaneScaler as TScaler

    w, h, n = 64, 48, 16
    clip = _smooth_clip(n, w, h, seed=3)
    padded = [TFrame(*f).padded(16) for f in clip]
    planes = [np.stack([getattr(f, p) for f in padded]) for p in "yuv"]
    for dw, dh in ((42, 32), (32, 24)):
        got = TScaler(w, h, dw, dh, device="cpu").scale_wave(
            *(torch.from_numpy(p) for p in planes))
        want = JScaler(w, h, dw, dh).scale_wave(*planes)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))

    path = tmp_path / "clip.ladder.y4m"
    write_y4m(path, JMeta(width=w, height=h, fps_num=30, num_frames=n),
              [JFrame(*f) for f in clip])
    built = []

    class PortLadderExecutor(LocalExecutor):
        def _encode_ladder(self, job, token, frames, settings, meta, stage):
            stage[0] = "segment"
            rungs = tladder.plan_ladder(meta, settings)
            enc = tdispatch.make_shard_encoder(meta, settings, None,
                                               rungs=rungs, device="cpu")
            built.append(enc)
            self.coordinator.update_progress(
                job.id, token, parts_total=enc.plan(len(frames)).num_gops,
                segment_progress=100.0)
            stage[0] = "encode"
            bundles = self._encode_with_retry(job, token, enc, frames,
                                              settings, allow_replan=False)
            self._emit_stage_breakdown(job, enc)
            return rungs, {r.name: tladder.rung_segments(bundles, r.name)
                           for r in rungs}

    def refuse(*a, **k):
        raise AssertionError("the reference's ladder fan-out ran")

    ladder_settings = dict(segment_s=0.25, ladder_rungs="32,24")
    coord = _make_rig(tmp_path, "port", settings=ladder_settings)
    execu = PortLadderExecutor(coord, output_dir=str(tmp_path / "port"),
                               sync=True)
    coord._launcher = execu.launch
    with monkeypatch.context() as mp:
        mp.setattr(jladder.LadderShardEncoder, "dispatch_wave", refuse)
        port_job = _run_ladder_job(coord, path, w, h, n)
    ref_job = _run_ladder_job(
        _make_rig(tmp_path, "ref", settings=ladder_settings,
                  mesh=_one_device_mesh()), path, w, h, n)
    (enc,) = built
    assert type(enc) is tladder.LadderShardEncoder
    assert [r.name for r in enc.rungs] == ["48p", "32p", "24p"]
    assert enc.stages.snapshot()["scale"] > 0
    assert port_job.parts_done == port_job.parts_total == \
        ref_job.parts_total == 4
    port_tree = _tree(os.path.dirname(port_job.output_path))
    ref_tree = _tree(os.path.dirname(ref_job.output_path))
    assert sorted(port_tree) == sorted(ref_tree) and len(ref_tree) > 6
    for name in ref_tree:
        assert port_tree[name] == ref_tree[name], name


def _run_ladder_job(coord, path, w, h, n):
    job = coord.add_job(str(path), JMeta(width=w, height=h, num_frames=n))
    job = coord.store.get(job.id)
    assert job.job_type == "ladder"
    assert job.status is Status.DONE, job.failure_reason
    assert job.output_path.endswith("master.m3u8")
    return job


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as fp:
                out[os.path.relpath(full, root)] = fp.read()
    return out
