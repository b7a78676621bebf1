"""The metric arithmetic on fixed records: a rate over the whole window
with its drain, a tail over every frame, the idle share as a union of
intervals, and the roofline counts against hand counts."""

import re
from pathlib import Path

import numpy as np
import pytest

from tvbench import devtrace, harness, roofline

ROOT = Path(__file__).resolve().parents[2]


def read(name, rec):
    return harness.reader(name)(rec)


def test_fps_is_frames_done_over_the_window_with_its_drain():
    # 3 jobs of 256 frames; the last one ran past the 4 s window to 5 s
    rec = {"frames_done": 768, "window_s": 5.0}
    assert read("fps", rec) == 768 / 5.0


def test_latency_tails_are_over_every_frame():
    lat = list(range(1, 101))              # 100 frames, 1..100 ms
    rec = {"latencies_ms": lat}
    assert read("latency_p50_ms", rec) == pytest.approx(50.5)
    assert read("latency_p95_ms", rec) == pytest.approx(95.05)
    assert read("latency_p95_ms", {"latencies_ms": []}) is None


def test_idle_is_one_minus_the_union_of_device_intervals():
    ivals = [(0.0, 1.0), (0.5, 1.5), (3.0, 4.0), (9.5, 12.0)]
    assert devtrace.busy_seconds(ivals, 0.0, 10.0) == pytest.approx(3.0)
    assert devtrace.gaps(ivals, 0.0, 10.0) == [(1.5, 3.0), (4.0, 9.5)]
    rec = {"trace": {"busy_s": 3.0, "window_s": 10.0, "events": 4}}
    assert read("device_idle_pct.tx", rec) == pytest.approx(70.0)
    assert read("device_idle_pct.sfe", {"trace": None}) is None


def test_live_idle_is_taken_inside_the_encode_spans_alone():
    """device_idle_pct.sfe: the union of device intervals inside the
    live_encode_batch spans over their length; the waits for frames
    between them do not count."""
    ivals = [(0.0, 1.0), (0.5, 1.5), (3.0, 4.0), (9.5, 12.0)]
    spans = [("live_encode_batch", 0.0, 2.0), ("awaiting_frames", 2.0, 8.0),
             ("live_encode_batch", 8.0, 10.0), ("stage", 0.2, 0.4)]
    got = devtrace.in_spans(ivals, spans, 0.0, 10.0)
    assert got["live_encode_batch"] == [pytest.approx(2.0),
                                        pytest.approx(4.0)]
    assert got["awaiting_frames"] == [pytest.approx(1.0), pytest.approx(6.0)]
    assert got["stage"] == [pytest.approx(0.2), pytest.approx(0.2)]
    assert devtrace.overlap([(0, 2), (3, 5)], [(1, 4)]) == pytest.approx(2.0)
    rec = {"trace": {"busy_s": 3.0, "window_s": 10.0, "events": 4,
                     "in_spans": got}}
    assert read("device_idle_pct.sfe", rec) == pytest.approx(50.0)
    assert read("device_idle_pct.tx", rec) == pytest.approx(70.0)
    assert read("device_idle_pct.sfe", {"trace": dict(
        rec["trace"], in_spans={})}) is None


def test_reduce_labels_each_gap_by_the_host_span_open_at_its_middle():
    tr = devtrace.DeviceTrace()
    tr.t0, tr.t1 = 100.0, 110.0
    tr.events = [("k1", 100.0, 101.0), ("k2", 100.5, 102.0),
                 ("k1", 105.0, 106.0), ("memcpy", 109.0, 110.0)]
    spans = [("job", 99.0, 111.0), ("pack", 102.5, 104.5),
             ("stage", 106.0, 109.0)]
    out = devtrace.reduce(tr, spans)
    assert out["busy_s"] == pytest.approx(4.0)
    assert out["window_s"] == pytest.approx(10.0)
    assert out["breakdown"]["device_ops"][0] == ["k1", pytest.approx(2.0)]
    assert out["breakdown"]["idle_gaps"] == [
        ["pack", pytest.approx(3.0)], ["stage", pytest.approx(3.0)]]
    assert devtrace.label(spans, 99.5) == "job"
    assert out["in_spans"]["pack"] == [pytest.approx(0.0),
                                       pytest.approx(2.0)]
    assert out["in_spans"]["job"] == [pytest.approx(4.0),
                                      pytest.approx(10.0)]


def test_reduce_keeps_each_cards_busy_time_and_the_union_as_before():
    """Two cards' events: busy_s stays the union over all cards (any
    card busy), busy_s_by_device gives each card's own; the same events
    without a card index read as card 0's, every other key alike."""
    tr = devtrace.DeviceTrace()
    tr.t0, tr.t1 = 100.0, 110.0
    tr.events = [("k1", 99.0, 101.0, 0), ("k2", 100.5, 102.0, 1),
                 ("k1", 105.0, 106.0, 1), ("memcpy", 109.0, 111.0, 0)]
    spans = [("job", 99.0, 111.0), ("pack", 102.5, 104.5)]
    out = devtrace.reduce(tr, spans)
    assert out["busy_s"] == pytest.approx(4.0)     # 100-102, 105-106, 109-110
    assert out["busy_s_by_device"] == {"0": pytest.approx(2.0),
                                       "1": pytest.approx(2.5)}
    assert out["busy_s"] == pytest.approx(devtrace.busy_seconds(
        [(s, e) for _, s, e, _ in tr.events], 100.0, 110.0))
    one = devtrace.DeviceTrace()
    one.t0, one.t1 = tr.t0, tr.t1
    one.events = [(n, s, e) for n, s, e, _ in tr.events]
    bare = devtrace.reduce(one, spans)
    assert bare["busy_s_by_device"] == {"0": out["busy_s"]}
    one.events = [(n, s, e, 0) for n, s, e, _ in tr.events]
    carded = devtrace.reduce(one, spans)
    assert bare == carded
    assert {k: v for k, v in out.items() if k != "busy_s_by_device"} == \
        {k: v for k, v in carded.items() if k != "busy_s_by_device"}


def test_the_result_reads_busy_time_averaged_over_the_cells_cards():
    """The result's busy_s is each card's busy time averaged over the
    cell's cards (a card with no event counts as idle); on one card it
    is the union that devtrace.reduce gives, value for value."""
    from tvbench.run import mean_busy_s

    tr = devtrace.DeviceTrace()
    tr.t0, tr.t1 = 100.0, 110.0
    tr.events = [("k1", 99.0, 101.0, 0), ("k2", 100.5, 102.0, 1),
                 ("k1", 105.0, 106.0, 1), ("memcpy", 109.0, 111.0, 3)]
    out = devtrace.reduce(tr, [])
    assert mean_busy_s(out, 4) == pytest.approx((1.0 + 2.5 + 1.0) / 4)
    tr.events = [(n, s, e, 0) for n, s, e, _ in tr.events]
    one = devtrace.reduce(tr, [])
    assert mean_busy_s(one, 1) == one["busy_s"]


def test_me_search_bound_against_a_hand_count():
    # 2 bands of 32 x 48: 227 candidates x 1536 px / 4 = 87,168 ops each
    ops, nbytes = roofline.me_search_bound(32, 48, 2)
    assert ops == 2 * 87168
    planes = 4 * (32 + 32) * (48 + 32)               # 20,480
    chroma = 2 * 16 * 24 * 2                         # 1,536
    rest = 3072 + chroma + 2 * 3 * 2 * 4 + 3072 + chroma
    assert nbytes == 2 * (planes + rest) + 28


def test_intra_bound_against_a_hand_count():
    ops, nbytes = roofline.intra_pair_bound(2, 3, 4)       # 24 MBs
    assert ops == 24 * 24 * (16 + 64 + 80 + 32 + 80 + 80)
    assert nbytes == 24 * (384 + 4 + 3072)


def test_roofline_share_is_bound_over_the_mean_traced_launch():
    shape = [1088, 1920, 1]
    bound, by = roofline.bound_seconds(*roofline.me_search_bound(*shape))
    assert by == "operations"
    rec = {"shapes": {"me_search": shape, "intra_pair": [1, 68, 120]},
           "trace": {"kernels": {
               "(anonymous namespace)::search_kernel(short const*)":
                   [4 * bound, 4 * bound],
               "halfpel_kernel": [1.0],
               "intra_row0_kernel(int)": [1e-3], "intra_cols_kernel": [3e-3]}}}
    assert read("me_search_roofline.tx", rec) == pytest.approx(25.0)
    ib, _ = roofline.bound_seconds(*roofline.intra_pair_bound(1, 68, 120))
    assert read("intra_core_roofline.tx", rec) == pytest.approx(
        100 * ib / 4e-3)
    assert read("me_search_roofline.sfe", {"trace": {"kernels": {}}}) is None


def test_frozen_constants_match_the_port_and_its_bring_up_checks():
    from thinvids_tpu_torch.codecs.h264 import torchme

    assert roofline.ME_HALO == torchme.ME_HALO
    assert roofline.ME_CANDIDATES == len(torchme.OFFSET_TABLE)
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "H100_INT32_OPS = 132 * 64 * 1.98e9" in smoke
    assert "H100_BYTES_PER_S = 3.35e12" in smoke
    assert re.search(r"INTRA_OPS_PER_BLOCK = 16 \+ 64 \+ 80 \+ 32 \+ 80 \+ 80",
                     smoke)
    assert roofline.H100_INT32_OPS == 132 * 64 * 1.98e9
    assert roofline.INTRA_OPS_PER_BLOCK == 352


def test_per_frame_stage_readers():
    rec = {"frames": 10, "stage_delta": {"sparse_unpack": 10.0,
                                         "unflatten": 5.0, "pack": 15.0,
                                         "fetch": 4.0, "sfe": 6.0,
                                         "stage": 20.0}}
    assert read("host_pack_ms_per_frame.tx", rec) == 3.0
    assert read("sfe_collect_ms_per_frame.sfe", rec) == 1.0
    assert read("stage_ms_per_frame.sfe", rec) == 2.0
    assert read("host_pack_ms_per_frame.tx", {"frames": 0}) is None


def test_job_overhead_is_wall_minus_the_wave_loop():
    """The wave loop starts at the first wave's staging (its first
    decode span), so that ingest is counted once, in its own metric."""
    job = {"ok": True, "t0": 10.0, "t1": 12.5, "spans": [
        ("wave_dispatch", 10.4, 10.5), ("decode", 10.1, 10.3),
        ("stage", 10.3, 10.4),
        ("wave_collect", 11.0, 12.1), ("wave_dispatch", 10.9, 11.0)]}
    assert read("job_overhead_ms.tx", {"jobs": [job]}) == \
        pytest.approx(1e3 * (2.5 - 2.0))
    assert np.isclose(read("job_overhead_ms.tx", {"jobs": [
        job, dict(job, t1=13.5)]}), 1e3 * 1.0)
    no_staging = dict(job, spans=[s for s in job["spans"]
                                  if s[0] not in ("decode", "stage")])
    assert read("job_overhead_ms.tx", {"jobs": [no_staging]}) == \
        pytest.approx(1e3 * (2.5 - 1.7))
