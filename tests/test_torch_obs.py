"""Port parity for observability: the metrics registry, the trace store,
and the encoders' stage spans, stage totals and split-frame latency ring.

- the port's `obs.metrics` and `obs.trace` pass the reference's
  registry and trace-store cases (tests/test_obs.py), each case run over
  both packages' modules;
- a traced port encode (GOP waves, the ladder, split-frame) records the
  span names and tags the JAX encoder records on the same input, and
  its bytes are the same with and without a recorder (and JAX's);
- `stage_snapshot()` accumulates across encoders and survives an
  encoder's `reset()`, and the totals reach the Prometheus registry;
- `frame_latency_percentiles()` summarizes a split-frame encode as the
  reference's does.
"""

import re
import time

import jax
import numpy as np
import pytest
import torch

from thinvids_tpu.core import config as jcfg
from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.core.types import concat_segments as jconcat
from thinvids_tpu.obs import metrics as jmetrics
from thinvids_tpu.obs import trace as jtrace
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu_torch.abr import ladder as tladder
from thinvids_tpu_torch.core import config as tcfg
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.core.types import concat_segments as tconcat
from thinvids_tpu_torch.obs import metrics as tmetrics
from thinvids_tpu_torch.obs import trace as ttrace
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)

#: package name → (its metrics module, its trace module, its config)
OBS = {"jax": (jmetrics, jtrace, jcfg), "torch": (tmetrics, ttrace, tcfg)}


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


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return (value.replace(r"\"", '"').replace(r"\n", "\n")
            .replace("\\\\", "\\"))


def parse_prometheus(text):
    """Strict text-exposition parser (tests/test_obs.py's): every sample
    line belongs to a family announced by # HELP + # TYPE, labels parse,
    values are numbers. Returns {family: {"type", "help", "samples":
    [(name, {label: value}, float)]}}."""
    families = {}
    owner = {}
    for line in text.rstrip("\n").split("\n"):
        assert line.strip() == line and line, f"bad line {line!r}"
        if line.startswith("# HELP "):
            _h, name, help_text = line[2:].split(" ", 2)
            families[name] = {"help": help_text, "type": None,
                              "samples": []}
            owner[name] = name
        elif line.startswith("# TYPE "):
            _t, name, kind = line[2:].split(" ", 2)
            assert name in families, f"TYPE before HELP for {name}"
            families[name]["type"] = kind
            if kind == "histogram":
                for suffix in ("_bucket", "_sum", "_count"):
                    owner[name + suffix] = name
        elif line.startswith("#"):
            continue
        else:
            m = _SAMPLE_RE.match(line)
            assert m, f"unparseable sample line {line!r}"
            name, raw_labels, raw_value = m.groups()
            fam = owner.get(name)
            assert fam is not None, f"sample {name} for unknown family"
            labels = {}
            if raw_labels:
                consumed = 0
                for lm in _LABEL_RE.finditer(raw_labels):
                    labels[lm.group(1)] = _unescape(lm.group(2))
                    consumed = lm.end()
                rest = raw_labels[consumed:].strip(", ")
                assert not rest, f"unparsed labels {rest!r} in {line!r}"
            families[fam]["samples"].append(
                (name, labels, float(raw_value)))
    for name, fam in families.items():
        assert fam["type"] in ("counter", "gauge", "histogram"), name
    return families


@pytest.fixture(params=sorted(OBS))
def obs(request):
    return OBS[request.param]


# ---- metrics registry -----------------------------------------------------------

class TestMetricsRegistry:
    def test_counter_gauge_histogram_render_and_parse(self, obs):
        metrics, _, _ = obs
        reg = metrics.MetricsRegistry()
        c = reg.counter("t_requests_total", "requests", labels=("route",))
        c.labels("hls").inc()
        c.labels("hls").inc(2)
        g = reg.gauge("t_sessions", "sessions")
        g.set(7)
        h = reg.histogram("t_latency_seconds", "latency",
                          buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 5.0, 50.0):
            h.observe(v)
        fams = parse_prometheus(reg.render())
        assert fams["t_requests_total"]["type"] == "counter"
        assert ("t_requests_total", {"route": "hls"}, 3.0) \
            in fams["t_requests_total"]["samples"]
        assert ("t_sessions", {}, 7.0) in fams["t_sessions"]["samples"]
        assert fams["t_latency_seconds"]["type"] == "histogram"

    def test_histogram_buckets_monotone_and_inf_equals_count(self, obs):
        metrics, _, _ = obs
        reg = metrics.MetricsRegistry()
        h = reg.histogram("t_h_seconds", "h", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.005, 0.05, 0.5, 2.0, 9.0):
            h.observe(v)
        fams = parse_prometheus(reg.render())
        samples = fams["t_h_seconds"]["samples"]
        buckets = [(labels["le"], v) for name, labels, v in samples
                   if name.endswith("_bucket")]
        counts = [v for _le, v in buckets]
        assert counts == sorted(counts), "bucket counts must be cumulative"
        count = next(v for name, _l, v in samples
                     if name.endswith("_count"))
        total = next(v for name, _l, v in samples
                     if name.endswith("_sum"))
        assert buckets[-1][0] == "+Inf" and buckets[-1][1] == count == 6
        assert total == pytest.approx(11.56)

    def test_label_escaping_roundtrips(self, obs):
        metrics, _, _ = obs
        reg = metrics.MetricsRegistry()
        g = reg.gauge("t_esc", "esc", labels=("path",))
        nasty = 'a"b\\c\nd'
        g.labels(nasty).set(1)
        fams = parse_prometheus(reg.render())
        (_name, labels, value), = fams["t_esc"]["samples"]
        assert labels["path"] == nasty and value == 1.0

    def test_conflicting_redeclaration_raises(self, obs):
        metrics, _, _ = obs
        reg = metrics.MetricsRegistry()
        reg.counter("t_x_total", "x")
        assert reg.counter("t_x_total", "x") is reg.get("t_x_total")
        with pytest.raises(ValueError):
            reg.gauge("t_x_total", "x")
        with pytest.raises(ValueError):
            reg.counter("t_x_total", "x", labels=("a",))

    def test_percentiles_nearest_rank(self, obs):
        metrics, _, _ = obs
        vals = sorted(float(v) for v in range(1, 101))
        assert metrics.percentiles(vals, {"p50": 0.5, "p99": 0.99}) == \
            {"p50": 50.0, "p99": 99.0}
        assert metrics.percentiles([], {"p50": 0.5}) == {}


def test_registries_declare_the_same_schema():
    """The port's metrics module declares the reference's families, each
    with the same name, kind, help and labels."""
    def declared(mod):
        out = {}
        for attr, val in vars(mod).items():
            vals = val.values() if isinstance(val, dict) else [val]
            for m in vals:
                if isinstance(m, mod.Metric):
                    out[m.name] = (attr, m.kind, m.help,
                                   tuple(m.labelnames))
        return out

    want = declared(jmetrics)
    assert len(want) > 20
    assert declared(tmetrics) == want


# ---- trace store ----------------------------------------------------------------

class TestTraceStore:
    def test_ring_bound_honors_trace_ring_spans(self, obs):
        _, trace, cfg = obs
        cfg.update_live_settings({"trace_ring_spans": 256})
        try:
            store = trace.TraceStore()
            store.start("jring")
            for i in range(300):
                store.record_span("jring", "s", t0=float(i), dur_s=0.01)
            snap = store.snapshot("jring")
            assert len(snap["spans"]) == 256
            assert snap["spans"][-1]["t0"] == 299.0
        finally:
            cfg.reset_live_settings()

    def test_trace_sample_zero_records_nothing(self, obs):
        _, trace, cfg = obs
        cfg.update_live_settings({"trace_sample": 0.0})
        try:
            store = trace.TraceStore()
            assert store.start("joff") == ""
            rec = store.recorder("joff")
            assert not rec.enabled
            with rec.span("anything"):
                pass
            assert store.snapshot("joff")["spans"] == []
        finally:
            cfg.reset_live_settings()

    def test_ingest_drops_stale_trace_id(self, obs):
        _, trace, _ = obs
        store = trace.TraceStore()
        tid = store.start("jr")
        wire = [{"name": "w", "t0": 1.0, "dur_s": 0.5, "tags": {"k": 1}}]
        assert store.ingest("jr", "not-the-trace", wire) == 0
        assert store.ingest("jr", tid, wire, host="w00") == 1
        span = store.snapshot("jr")["spans"][0]
        assert span["host"] == "w00" and span["tags"] == {"k": 1}

    def test_export_chrome_shape(self, obs):
        _, trace, _ = obs
        store = trace.TraceStore()
        tid = store.start("jx")
        rec = store.recorder("jx", host="h1")
        with rec.span("outer", wave=0):
            with rec.span("inner"):
                pass
        doc = store.export_chrome("jx")
        events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert {e["name"] for e in events} == {"outer", "inner"}
        for e in events:
            assert isinstance(e["ts"], int) and e["dur"] >= 1
            assert e["args"]["trace_id"] == tid
        metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
        assert any(e["name"] == "process_name"
                   and e["args"]["name"] == "h1" for e in metas)
        assert doc["otherData"]["trace_id"] == tid

    def test_eviction_is_lru_by_activity_not_start_order(self, obs):
        _, trace, _ = obs
        store = trace.TraceStore()
        store.start("long-runner")
        for i in range(trace.MAX_JOBS - 1):
            store.start(f"short-{i}")
            store.record_span("long-runner", "wave", t0=float(i),
                              dur_s=0.1)
        store.start("one-more")        # evicts the LRU entry
        assert store.snapshot("long-runner") is not None
        assert store.snapshot("short-0") is None

    def test_restart_gets_fresh_trace_and_drops_straggler_spans(self, obs):
        _, trace, _ = obs
        store = trace.TraceStore()
        old = store.start("j2")
        new = store.start("j2")
        assert old != new
        assert store.ingest(
            "j2", old, [{"name": "stale", "t0": 1.0, "dur_s": 1.0}]) == 0
        assert store.trace_id("j2") == new

    def test_bind_exposes_ids_to_current_thread(self, obs):
        _, trace, _ = obs
        assert trace.current_ids() is None
        with trace.bind("jobX", "traceY"):
            assert trace.current_ids() == ("jobX", "traceY")
        assert trace.current_ids() is None

    def test_span_buffer_drains_wire_spans(self, obs):
        _, trace, _ = obs
        buf = trace.SpanBuffer("tid", "job", host="w1")
        with buf.span("encode", shard=3):
            pass
        buf.record("upload", 1.0, 0.25, bytes=10)
        spans = buf.drain()
        assert [(s["name"], s["tags"]) for s in spans] == \
            [("encode", {"shard": 3}), ("upload", {"bytes": 10})]
        assert buf.drain() == []


# ---- the encoders' spans --------------------------------------------------------

def _traced(store, job, enc, encode):
    """(bytes, spans) of one encode with the job's recorder bound."""
    store.start(job)
    enc.stages.set_tracer(store.recorder(job))
    try:
        data = encode()
    finally:
        enc.stages.set_tracer(None)
    spans = store.snapshot(job)["spans"]
    store.drop(job)
    return data, spans


def _names_tags(spans):
    return sorted({(s["name"], tuple(sorted(s["tags"].items())))
                   for s in spans})


#: the spans the port records and the reference does not: the driving
#: thread's waits for a staged and for a collected wave, each slice's
#: pack on the pack pool, and the split-frame walk's steps
PORT_SPANS = {"await_staged", "await_collect", "cavlc", "walk_intra",
              "walk_probe", "walk_p", "walk_link"}


def _tags(spans, name, key):
    """The `key` tags of the `name` spans, in record order."""
    return [s["tags"][key] for s in spans if s["name"] == name]


def test_traced_wave_encode_records_the_reference_spans():
    w, h, n = 64, 48, 8
    clip = _smooth_clip(n, w, h, seed=41)
    tenc = tdispatch.GopShardEncoder(TMeta(width=w, height=h, num_frames=n),
                                     qp=30, gop_frames=2, device="cpu")
    tframes = [TFrame(*f) for f in clip]
    baseline = tconcat(tenc.encode(tframes))
    got, tspans = _traced(ttrace.TRACE, "port-waves", tenc,
                          lambda: tconcat(tenc.encode(tframes)))
    jenc = jdispatch.GopShardEncoder(
        JMeta(width=w, height=h, num_frames=n), qp=30, gop_frames=2,
        mesh=jdispatch.default_mesh(jax.devices()[:1]))
    want, jspans = _traced(jtrace.TRACE, "ref-waves", jenc,
                           lambda: jconcat(jenc.encode(
                               [JFrame(*f) for f in clip])))
    assert got == baseline == want
    assert tspans, "tracer was bound but recorded nothing"
    # the reference's spans, exactly, beside the port's own
    assert _names_tags([s for s in tspans if s["name"] not in PORT_SPANS]) \
        == _names_tags(jspans)
    assert not {s["name"] for s in jspans} & PORT_SPANS
    # one wave: its pull, then the pull that finds the stream's end
    assert _tags(tspans, "await_staged", "wave") == [0, 1]
    assert _tags(tspans, "await_collect", "wave") == [0]
    # one cavlc span a slice: 8 frames, one slice each
    assert sum(s["name"] == "cavlc" for s in tspans) == n
    # no tracer bound: nothing more records, and the bytes stay
    assert tenc.stages.tracer() is None
    assert tconcat(tenc.encode(tframes)) == baseline


def test_ladder_set_tracer_reaches_every_rung():
    w, h, n = 64, 48, 8
    clip = _smooth_clip(n, w, h, seed=3)
    over = dict(qp=30, gop_frames=4, ladder_rungs="32,24")
    trungs = tladder.plan_ladder(
        TMeta(width=w, height=h, num_frames=n),
        tcfg.Settings(values=dict(tcfg.DEFAULT_SETTINGS, **over)))
    enc = tladder.LadderShardEncoder(TMeta(width=w, height=h, num_frames=n),
                                     trungs, gop_frames=4, device="cpu")
    ttrace.TRACE.start("ladder")
    rec = ttrace.TRACE.recorder("ladder")
    enc.stages.set_tracer(rec)
    assert len(enc.encoders) == 3
    assert all(e.stages.tracer() is rec for e in enc.encoders)
    assert enc.stages.tracer() is rec
    bundles = enc.encode([TFrame(*f) for f in clip])
    spans = ttrace.TRACE.snapshot("ladder")["spans"]
    ttrace.TRACE.drop("ladder")
    names = {s["name"] for s in spans}
    # the stager stages and scales; every rung dispatches and packs
    assert {"stage", "scale", "dispatch", "pack", "concat"} <= names
    assert sum(s["name"] == "dispatch" for s in spans) == 3 * \
        enc.stages.snapshot()["waves"]
    enc.stages.set_tracer(None)
    assert all(e.stages.tracer() is None for e in enc.encoders)
    assert len(bundles) == 2


def test_traced_sfe_encode_records_the_reference_frame_spans():
    w, h, n = 64, 96, 6
    clip = _smooth_clip(n, w, h, seed=43)
    tenc = tdispatch.SfeShardEncoder(TMeta(width=w, height=h, num_frames=n),
                                     qp=30, gop_frames=3, bands=2,
                                     device="cpu")
    tframes = [TFrame(*f) for f in clip]
    baseline = tconcat(tenc.encode(tframes))
    got, tspans = _traced(ttrace.TRACE, "port-sfe", tenc,
                          lambda: tconcat(tenc.encode(tframes)))
    # the reference collects each in-flight GOP on its own thread, so
    # which of its frames record a gap depends on thread timing; one GOP
    # in flight gives its frame-order contract (the port keeps that order
    # at any window: test_sfe_frame_gaps_keep_frame_order_when_a_gop_collects_late)
    jenc = jdispatch.SfeShardEncoder(JMeta(width=w, height=h, num_frames=n),
                                     qp=30, gop_frames=3, bands=2,
                                     pipeline_window=1)
    want, jspans = _traced(jtrace.TRACE, "ref-sfe", jenc,
                           lambda: jconcat(jenc.encode(
                               [JFrame(*f) for f in clip])))
    assert got == baseline == want
    assert _names_tags([s for s in tspans if s["name"] not in PORT_SPANS]) \
        == _names_tags(jspans)
    assert not {s["name"] for s in jspans} & PORT_SPANS
    # two GOPs of 3 frames, a wave each: the walk's steps once a frame
    # of each GOP, tagged with the frame in the GOP
    assert _tags(tspans, "await_staged", "wave") == [0, 1, 2]
    assert _tags(tspans, "await_collect", "wave") == [0, 1]
    assert _tags(tspans, "walk_intra", "frame") == [0, 0]
    for name in ("walk_probe", "walk_p", "walk_link"):
        assert _tags(tspans, name, "frame") == [1, 2, 1, 2], name
    assert sum(s["name"] == "cavlc" for s in tspans) == 2 * n
    frames = sorted(s["tags"]["frame"] for s in tspans
                    if s["name"] == "sfe_frame")
    # every frame after the first of the pass records its gap
    assert frames == list(range(1, n))
    assert all(s["dur_s"] > 0 for s in tspans if s["name"] == "sfe_frame")


class _LateFirstGop(tdispatch.SfeShardEncoder):
    """Collects GOP 0 late, as a loaded host may: its frames' packing
    starts after GOP 1's has had time to finish."""

    def collect_wave(self, pending):
        if pending[0].index == 0:
            time.sleep(0.5)
        return super().collect_wave(pending)


def test_sfe_frame_gaps_keep_frame_order_when_a_gop_collects_late():
    w, h, n = 64, 96, 6
    clip = [TFrame(*f) for f in _smooth_clip(n, w, h, seed=43)]
    enc = _LateFirstGop(TMeta(width=w, height=h, num_frames=n), qp=30,
                        gop_frames=3, bands=2, pipeline_window=2,
                        device="cpu")
    want = tconcat(tdispatch.SfeShardEncoder(
        TMeta(width=w, height=h, num_frames=n), qp=30, gop_frames=3,
        bands=2, device="cpu").encode(clip))
    got, spans = _traced(ttrace.TRACE, "port-sfe-late", enc,
                         lambda: tconcat(enc.encode(clip)))
    assert got == want
    frames = [s["tags"]["frame"] for s in spans if s["name"] == "sfe_frame"]
    assert frames == list(range(1, n))
    assert list(enc.frame_done_t) == sorted(enc.frame_done_t)
    assert all(s["dur_s"] > 0 for s in spans if s["name"] == "sfe_frame")


# ---- totals and the latency ring -------------------------------------------------

def test_stage_snapshot_accumulates_across_encoders_and_survives_reset():
    w, h, n = 64, 48, 4
    frames = [TFrame(*f) for f in _smooth_clip(n, w, h, seed=5)]
    before = tdispatch.stage_snapshot()
    encs = [tdispatch.GopShardEncoder(TMeta(width=w, height=h, num_frames=n),
                                      qp=30, gop_frames=2, device="cpu")
            for _ in range(2)]
    for enc in encs:
        enc.encode(frames)
    after = tdispatch.stage_snapshot()
    own = [enc.stages.snapshot() for enc in encs]
    for key in ("waves", "h2d_bytes", "d2h_bytes"):
        assert after[key] - before[key] == sum(s[key] for s in own) > 0
    assert after["pack"] >= before["pack"] + 0.9 * sum(
        s["pack"] for s in own)
    encs[0].stages.reset()
    assert encs[0].stages.snapshot()["waves"] == 0
    assert tdispatch.stage_snapshot()["waves"] == after["waves"]
    # the totals bridge into the port's Prometheus registry
    fams = parse_prometheus(tmetrics.REGISTRY.render())
    waves = fams["tvt_waves_total"]["samples"][0][2]
    assert waves >= after["waves"] - before["waves"]
    stages = {lab["stage"] for _n, lab, _v in
              fams["tvt_stage_seconds_total"]["samples"]}
    assert {"stage", "dispatch", "pack"} <= stages


def test_frame_latency_percentiles_after_an_sfe_encode():
    w, h, n = 64, 96, 6
    enc = tdispatch.SfeShardEncoder(TMeta(width=w, height=h, num_frames=n),
                                    qp=30, gop_frames=3, bands=2,
                                    device="cpu")
    tconcat(enc.encode([TFrame(*f) for f in _smooth_clip(n, w, h, seed=9)]))
    assert len(enc.frame_latencies_ms()) >= 4
    pct = tdispatch.frame_latency_percentiles()
    assert pct["count"] >= 4
    assert pct["p99_ms"] >= pct["p50_ms"] > 0
    fams = parse_prometheus(tmetrics.REGISTRY.render())
    count = next(v for name, _l, v in
                 fams["tvt_sfe_frame_latency_seconds"]["samples"]
                 if name.endswith("_count"))
    assert count >= n - 1
