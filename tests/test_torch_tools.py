"""The port's last two tools against the reference's cases:

- `tools/import_media.py`: tests/test_import.py's cases, read with every
  `thinvids_tpu` import naming `thinvids_tpu_torch` (as
  tests/test_torch_remote.py collects its cases) and run over the
  port's import_media, ingest.probe and ingest.decode;
- `tools/fuzz_native.py`: a short seeded run on the production build of
  the port's native library (tier 1), and the ASan / UBSan legs of
  tests/test_native_fuzz.py over the port's harness (`slow`).
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys
import types

import pytest

from thinvids_tpu_torch.tools import fuzz_native

REPO = pathlib.Path(__file__).resolve().parent.parent


def _reference_cases(name: str) -> types.ModuleType:
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    src = re.sub(r"\bthinvids_tpu\b", "thinvids_tpu_torch",
                 path.read_text())
    mod = types.ModuleType(f"{name}_over_the_port")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


_IMPORT = _reference_cases("test_import")
for _name, _obj in vars(_IMPORT).items():
    if _name.startswith(("test_", "Test")):
        globals()[_name] = _obj


def test_import_cases_run_the_port():
    assert _IMPORT.main.__module__ == "thinvids_tpu_torch.tools.import_media"


def test_fuzz_native_seeded_run_on_the_production_build(capsys):
    assert fuzz_native.main(["--iterations", "40", "--seed", "7"]) == 0
    out = capsys.readouterr().out
    assert "0 crashes, 0 divergences" in out or "nothing to fuzz" in out


def _run_fuzz(extra_env: dict, iterations: int = 150) -> None:
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update(extra_env)
    proc = subprocess.run(
        [sys.executable, "-m", "thinvids_tpu_torch.tools.fuzz_native",
         "--iterations", str(iterations)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (
        f"fuzz harness failed (rc={proc.returncode})\n"
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    assert "0 crashes, 0 divergences" in proc.stdout or \
        "nothing to fuzz" in proc.stdout, proc.stdout


def _runtime(name: str) -> str | None:
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out = subprocess.run([gxx, f"-print-file-name={name}"],
                         capture_output=True, text=True)
    path = out.stdout.strip()
    return path if os.path.sep in path and os.path.exists(path) else None


@pytest.mark.slow
class TestSanitizedFuzz:
    def test_ubsan_corpus(self):
        if shutil.which("g++") is None:
            pytest.skip("no g++")
        _run_fuzz({"TVT_NATIVE_SANITIZE": "ubsan",
                   "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1"})

    def test_asan_corpus(self):
        libasan = _runtime("libasan.so")
        if libasan is None:
            pytest.skip("no g++ / libasan runtime")
        _run_fuzz({"TVT_NATIVE_SANITIZE": "asan",
                   "ASAN_OPTIONS": "detect_leaks=0",
                   "LD_PRELOAD": libasan})
