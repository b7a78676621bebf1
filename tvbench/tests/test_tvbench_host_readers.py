"""The host critical path's readers on fixed records: the waits, the CPU
time and the syncs a frame from the stage deltas, the job layer from a
job's spans, the walk's idle share from the device time inside its
spans; each returns None when its keys are absent, as a program that
does not record them gives."""

import pytest

from tvbench import devtrace, harness

#: the eight readers, each with the stage-delta keys it reads
PER_FRAME = {
    "ingest_wait_ms_per_frame.tx": ("await_staged",),
    "ingest_cpu_ms_per_frame.tx": ("cpu.decode", "cpu.stage"),
    "host_pack_cpu_ms_per_frame.tx": ("cpu.sparse_unpack", "cpu.unflatten",
                                      "cpu.cavlc"),
    "stage_wait_ms_per_frame.sfe": ("await_staged",),
    "walk_ms_per_frame.sfe": ("walk_intra", "walk_probe", "walk_p",
                              "walk_link"),
    "host_syncs_per_frame.sfe": ("host_syncs",),
}


def read(name, rec):
    return harness.reader(name)(rec)


#: a window of 10 frames with the keys the program records (and the
#: older stages beside them)
DELTA = {"await_staged": 30.0, "cpu.decode": 12.0, "cpu.stage": 8.0,
         "cpu.sparse_unpack": 5.0, "cpu.unflatten": 3.0, "cpu.cavlc": 22.0,
         "walk_intra": 4.0, "walk_probe": 6.0, "walk_p": 15.0,
         "walk_link": 5.0, "host_syncs": 70, "decode": 40.0, "stage": 10.0,
         "pack": 9.0}


@pytest.mark.parametrize("name, want", [
    ("ingest_wait_ms_per_frame.tx", 3.0),
    ("ingest_cpu_ms_per_frame.tx", 2.0),
    ("host_pack_cpu_ms_per_frame.tx", 3.0),
    ("stage_wait_ms_per_frame.sfe", 3.0),
    ("walk_ms_per_frame.sfe", 3.0),
    ("host_syncs_per_frame.sfe", 7.0),
])
def test_per_frame_readers(name, want):
    rec = {"frames": 10, "stage_delta": dict(DELTA)}
    assert read(name, rec) == pytest.approx(want)
    assert read(name, {"frames": 0, "stage_delta": dict(DELTA)}) is None


@pytest.mark.parametrize("name", sorted(PER_FRAME))
def test_per_frame_readers_are_silent_without_their_keys(name):
    """A program without the new stages (the parent of the change that
    adds them) records none of the keys: the reader finds nothing."""
    older = {k: v for k, v in DELTA.items() if k in ("decode", "stage",
                                                     "pack")}
    assert read(name, {"frames": 10, "stage_delta": older}) is None
    assert read(name, {"frames": 10}) is None
    for key in PER_FRAME[name]:
        partial = {k: v for k, v in DELTA.items() if k != key}
        assert read(name, {"frames": 10, "stage_delta": partial}) is None


def test_job_layer_is_the_mean_of_each_traced_jobs_layer_spans():
    job = {"ok": True, "t0": 10.0, "t1": 12.5, "spans": [
        ("job_open", 10.0, 10.01), ("encoder_build", 10.01, 10.02),
        ("decode", 10.02, 10.5), ("wave_dispatch", 10.5, 10.6),
        ("wave_collect", 10.6, 12.4), ("stitch", 12.4, 12.41),
        ("mux", 12.41, 12.44), ("commit", 12.44, 12.5)]}
    assert read("job_layer_ms.tx", {"jobs": [job]}) == pytest.approx(120.0)
    slower = dict(job, spans=job["spans"] + [("commit", 13.0, 13.04)])
    assert read("job_layer_ms.tx", {"jobs": [job, slower]}) == \
        pytest.approx(140.0)
    # untraced, failed or older jobs: nothing to read
    failed = dict(job, ok=False)
    older = dict(job, spans=[s for s in job["spans"]
                             if s[0] in ("decode", "wave_dispatch",
                                         "wave_collect")])
    assert read("job_layer_ms.tx", {"jobs": [failed, older]}) is None
    assert read("job_layer_ms.tx", {"jobs": [{"ok": True, "t0": 0,
                                              "t1": 1}]}) is None
    assert read("job_layer_ms.tx", {}) is None


def test_walk_idle_is_one_minus_the_busy_share_of_its_steps():
    ivals = [(0.0, 1.0), (2.5, 3.0)]
    spans = [("walk_intra", 0.0, 2.0), ("walk_p", 2.0, 3.0),
             ("walk_p", 5.0, 6.0), ("dispatch", 0.0, 6.0)]
    got = devtrace.in_spans(ivals, spans, 0.0, 10.0)
    rec = {"trace": {"busy_s": 1.5, "window_s": 10.0, "events": 2,
                     "in_spans": got}}
    # busy 1.0 of the intra step's 2 s and 0.5 of the P steps' 2 s
    assert read("device_idle_in_walk_pct.sfe", rec) == pytest.approx(62.5)
    older = dict(rec["trace"], in_spans={"dispatch": got["dispatch"]})
    assert read("device_idle_in_walk_pct.sfe", {"trace": older}) is None
    assert read("device_idle_in_walk_pct.sfe", {"trace": None}) is None
    assert read("device_idle_in_walk_pct.sfe", {}) is None


def test_the_new_metrics_are_entries_of_their_one_cell():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in list(PER_FRAME) + ["job_layer_ms.tx",
                                   "device_idle_in_walk_pct.sfe"]:
        cell = "tx1080-films" if name.endswith(".tx") else "sfe2160-live"
        assert entries[name]["workloads"] == [cell]
        assert callable(harness.reader(name))
    assert entries["walk_ms_per_frame.sfe"]["layer"] == "SFE walk"
