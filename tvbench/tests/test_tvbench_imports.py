"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: `thinvids_tpu_torch` begins with
`thinvids_tpu`), the reference imports nothing of the port, and the run
fails with no result where it cannot measure."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "tvbench"
JAX = {"jax", "jaxlib", "flax", "thinvids_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module a file imports (relative imports
    resolve inside tvbench)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add("tvbench" if node.level else node.module.split(".")[0])
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = list(BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & JAX, f
    # the check is by whole name: the port itself is allowed
    assert "thinvids_tpu_torch".split(".")[0] not in JAX


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH_DIR / "reference").glob("*.py"):
        assert _imports(f) <= {"__future__", "dataclasses", "re", "struct",
                               "numpy", "tvbench"}, f
    code = ("import sys; sys.modules['thinvids_tpu_torch'] = None; "
            "sys.modules['torch'] = None; "
            "from tvbench.reference import h264, mp4; "
            "print(sorted(m for m in sys.modules if m.startswith('thin')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "['thinvids_tpu_torch']"   # the blocker


def test_a_run_loads_no_jax_module(tmp_path):
    code = f"""
import sys, time, json
sys.path.insert(0, {str(BENCH_DIR / 'tests')!r})
from pathlib import Path
import tinyroot
from tvbench import harness
root, bench = tinyroot.make(Path({str(tmp_path)!r}))
out = tinyroot.run(root, bench, "tx1080-films", seconds=0.5)
print(json.dumps([out["correct"], harness.forbidden_loaded()]))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.splitlines()[-1]) == [True, []]


def test_the_check_names_what_it_finds(monkeypatch):
    from tvbench import harness

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "thinvids_tpu_torch_x", object())
    assert harness.forbidden_loaded() == ["jaxlib"]


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "tvbench/run.py", "--workload", "tx1080-films",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_the_run_fails_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = _run_py(ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr


def test_with_only_the_benchmark_the_run_fails_with_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "tvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run_py(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


def test_the_result_line_has_its_keys_and_compared_comes_last(
        tmp_path):
    sys.path.insert(0, str(BENCH_DIR / "tests"))
    import tinyroot

    out = tinyroot.run(*tinyroot.make(tmp_path), "tx1080-clips", seconds=0.5)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(out)[-1] == "compared"
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"}
    for v in out["compared"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(out)
