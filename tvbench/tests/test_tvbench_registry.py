"""BENCHMARK.json against the contract's shape, and the harness finding
cells, configurations, traffic mixes and metric readers by name, so that
a later change adds one as new files alone."""

import json
import re

import pytest
import tinyroot

from tvbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["tvbench"]
    assert BENCH["command"] == ["python3", "tvbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    cells = {w["name"] for w in BENCH["workloads"]}
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"fps", "latency_p95_ms", "latency_p50_ms", "setup_s"} <= e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"] if e["name"] ==
                     m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        got = {m["name"] for m in harness.metrics_for(BENCH, cell, False)}
        assert "setup_s" in got and len(got) >= 2
        assert harness.metrics_for(BENCH, cell, True)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    spec = harness.cell_spec(BENCH, cell)
    assert harness.generator(spec["traffic"]["generator"]).run
    for trace in (False, True):
        for m in harness.metrics_for(BENCH, cell, trace):
            assert callable(harness.reader(m["name"]))
    cfg = spec["config"]
    assert cfg["name"] == spec["cell"]["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == cfg["reduced"]


def test_a_new_cell_config_and_metric_are_new_files_alone(tmp_path):
    """A throwaway configuration, traffic mix, cell and end-to-end metric,
    each a new file and entry: the harness runs them with no file of
    the benchmark edited."""
    root, bench = tinyroot.make(tmp_path)
    before = {p: p.read_bytes() for p in (root / "tvbench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "h264-96x64-cqp30-gop2"
    cfg.update(width=96, height=64)
    cfg["settings"].update(qp=30, gop_frames=2)
    (root / "tvbench/configs/h264-96x64-cqp30-gop2.json").write_text(
        json.dumps(cfg))
    (root / "tvbench/traffic/shorts.json").write_text(json.dumps(
        {"generator": "jobs", "frames": 4, "clips": 1, "fps": 24,
         "trace_first": 0, "trace_jobs": 1, "check_gops": 2}))
    (root / "tvbench/metrics/jobs_per_s.py").write_text(
        "def read(rec):\n"
        "    return len(rec['jobs']) / rec['window_s']\n")
    bench["configs"].append({"name": cfg["name"], "source": "test",
                             "file": "tvbench/configs/"
                                     "h264-96x64-cqp30-gop2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tx96-shorts", "config": cfg["name"],
                               "traffic": "shorts", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "jobs_per_s", "unit": "jobs/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tx96-shorts"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "fps")["workloads"].append("tx96-shorts")
    out = tinyroot.run(root, bench, "tx96-shorts")
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"fps", "setup_s", "jobs_per_s"}
    assert out["metrics"]["jobs_per_s"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_per_layer_metric_reads_its_record():
    """A new per-layer metric file is read from the run's record; one
    that finds nothing is left out of the line."""
    ctx = harness.Context(harness.cell_spec(BENCH, "tx1080-films"), 1, 1.0,
                          True, "cpu", None, 0.0)
    ctx.setup_s = 3.0
    rec = {"attempted": 2, "failed": 0, "frames": 512, "frames_done": 512,
           "window_s": 4.0, "stage_delta": {"decode": 512.0, "stage": 256.0,
                                            "d2h_bytes": 1024},
           "jobs": [], "checks": {"x": {"value": 0, "limit": 0}},
           "shapes": {}, "info": {}}
    out = harness.assemble(BENCH, ctx, rec, {"platform": "cpu"})
    assert out["metrics"]["ingest_ms_per_frame.tx"]["value"] == 1.5
    assert out["metrics"]["d2h_bytes_per_frame.tx"]["value"] == 2.0
    assert "device_idle_pct.tx" not in out["metrics"]     # no trace
    assert "job_overhead_ms.tx" not in out["metrics"]     # no spans
    assert list(out)[-1] == "compared"
