"""BENCHMARK.json against the contract's shape, and the harness finding
cells, configurations, traffic mixes and metric readers by name, so that
a later change adds one as new files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest
import tinyroot

from tvbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
ROOT = Path(__file__).resolve().parents[2]


def four_card_cells_allowed(bench: dict) -> bool:
    """Every cell asks for 1 or 4 cards, and at most a quarter of the
    cells, rounded down, for 4 (one always may)."""
    chips = [w["chips"] for w in bench["workloads"]]
    return set(chips) <= {1, 4} and \
        chips.count(4) <= max(1, len(chips) // 4)


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
    assert four_card_cells_allowed(BENCH)
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


def test_the_four_card_rule_refuses_two_of_three():
    bench = json.loads(json.dumps(BENCH))
    cell = dict(bench["workloads"][0], chips=4)
    assert four_card_cells_allowed(dict(bench, workloads=[
        *bench["workloads"], dict(cell, name="a4")]))
    assert not four_card_cells_allowed(dict(bench, workloads=[
        bench["workloads"][0], dict(cell, name="a4"), dict(cell, name="b4")]))
    assert not four_card_cells_allowed(dict(bench, workloads=[
        dict(cell, name="a2", chips=2)]))
    eight = [dict(cell, name=f"c{i}", chips=1) for i in range(6)]
    assert four_card_cells_allowed(dict(bench, workloads=[
        *eight, dict(cell, name="a4"), dict(cell, name="b4")]))


#: a generator that a four-card cell would bring: the films jobs on a
#: mesh of the cell's cards (`DeviceMesh(("cpu",) * chips)` on the CPU)
MESH_GENERATOR = """
from tvbench import harness


def run(ctx):
    from thinvids_tpu_torch.core.devices import DeviceMesh

    chips = int(ctx.cell["chips"])
    mesh = DeviceMesh(("cpu",) * chips if ctx.device == "cpu"
                      else [f"cuda:{i}" for i in range(chips)])
    return harness.generator("jobs", ctx.root).run(ctx, mesh=mesh)
"""


@pytest.mark.parametrize("chips", [1, 4])
def test_a_new_cell_config_and_metric_are_new_files_alone(tmp_path, chips,
                                                          monkeypatch):
    """A throwaway configuration, traffic mix, cell and end-to-end metric
    (and, for a four-card cell, its generator), each a new file and
    entry of the benchmark before the tiny copy is made from it: the
    harness runs them, and no file the benchmark had is edited."""
    src = tmp_path / "src"
    shutil.copytree(ROOT / "tvbench", src / "tvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", src)
    bench = json.loads((src / "BENCHMARK.json").read_text())
    cfg = json.loads((src / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "h264-96x64-cqp30-gop2"
    cfg.update(width=96, height=64)
    cfg["settings"].update(qp=30, gop_frames=2)
    (src / "tvbench/configs/h264-96x64-cqp30-gop2.json").write_text(
        json.dumps(cfg))
    generator = "jobs" if chips == 1 else "meshjobs"
    (src / "tvbench/traffic/shorts.json").write_text(json.dumps(
        {"generator": generator, "frames": 24, "clips": 3, "fps": 24,
         "trace_first": 0, "trace_jobs": 1, "check_gops": 2}))
    if chips > 1:
        (src / "tvbench/traffic/meshjobs.py").write_text(MESH_GENERATOR)
    (src / "tvbench/metrics/jobs_per_s.py").write_text(
        "def read(rec):\n"
        "    return len(rec['jobs']) / rec['window_s']\n")
    bench["configs"].append({"name": cfg["name"], "source": "test",
                             "file": "tvbench/configs/"
                                     "h264-96x64-cqp30-gop2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tx96-shorts", "config": cfg["name"],
                               "traffic": "shorts", "chips": chips,
                               "why": "test"})
    bench["end_to_end"].append({"name": "jobs_per_s", "unit": "jobs/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tx96-shorts"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "fps")["workloads"].append("tx96-shorts")
    assert four_card_cells_allowed(bench)
    (src / "BENCHMARK.json").write_text(json.dumps(bench))

    from thinvids_tpu_torch.cluster.executor import LocalExecutor

    meshes = []
    build = LocalExecutor._default_encoder

    def seen(self, meta, settings, mesh):
        meshes.append(mesh)
        return build(self, meta, settings, mesh)

    monkeypatch.setattr(LocalExecutor, "_default_encoder", seen)
    root, tiny = tinyroot.make(tmp_path / "tiny", src=src)
    out = tinyroot.run(root, tiny, "tx96-shorts")
    # every job ran on the cell's own mesh (or the one device)
    assert meshes and all(
        (m is None) if chips == 1 else
        (m.size == chips and {d.type for d in m.devices} == {"cpu"})
        for m in meshes)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"fps", "setup_s", "jobs_per_s"}
    assert out["metrics"]["jobs_per_s"]["value"] > 0
    assert out["device"]["count"] == chips
    # the tiny cut by rule: 64 x 48, GOPs of 2, three GOPs a clip
    cut = json.loads((root / "tvbench/configs/"
                      "h264-96x64-cqp30-gop2.json").read_text())
    assert (cut["width"], cut["height"]) == (64, 48)
    mix = json.loads((root / "tvbench/traffic/shorts.json").read_text())
    assert (mix["frames"], mix["clips"]) == (6, 2)
    assert out["info"]["clip_frames"] == 6
    had = {p.relative_to(ROOT): p.read_bytes()
           for p in (ROOT / "tvbench").rglob("*")
           if p.is_file() and "__pycache__" not in p.parts}
    assert had == {p: (src / p).read_bytes() for p in had}


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
