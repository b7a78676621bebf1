"""The port stands alone: thinvids_tpu_torch and chip_smoke.py import
neither JAX nor anything of the JAX package (thinvids_tpu), not even its
jax-free host modules — the port keeps its own copies of those.

Two checks: every module imports in a fresh interpreter where `jax` is
unimportable and an import hook refuses `thinvids_tpu`; and an AST scan
finds no import statement naming either, including imports inside
functions that the first check would not reach.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "thinvids_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_FORBIDDEN = ("jax", "jaxlib", "thinvids_tpu")

_ISOLATED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

sys.modules["jax"] = None
sys.modules["jaxlib"] = None


class RefuseReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "thinvids_tpu" or name.startswith("thinvids_tpu."):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, RefuseReference())
import thinvids_tpu_torch

names = ["thinvids_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(thinvids_tpu_torch.__path__,
                                          "thinvids_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke

assert callable(chip_smoke.main)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "thinvids_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def _top_level_imports(path: pathlib.Path) -> list[str]:
    """Absolute module names imported anywhere in the file."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_every_module_imports_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _ISOLATED_IMPORT],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    # the package, its subpackages and every module were imported
    assert int(res.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_import_names_jax_or_the_reference(path):
    bad = [n for n in _top_level_imports(path)
           if n.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port(tmp_path):
    rel = {str(p.relative_to(ROOT)) for p in SOURCES}
    for want in ("chip_smoke.py",
                 "thinvids_tpu_torch/codecs/h264/torchme.py",
                 "thinvids_tpu_torch/parallel/dispatch.py",
                 "thinvids_tpu_torch/parallel/packproc.py",
                 "thinvids_tpu_torch/core/config.py",
                 "thinvids_tpu_torch/ingest/decode.py",
                 "thinvids_tpu_torch/io/mp4.py",
                 "thinvids_tpu_torch/tools/oracle.py",
                 "thinvids_tpu_torch/tools/metrics.py",
                 "thinvids_tpu_torch/codecs/h264/deblock.py",
                 "thinvids_tpu_torch/codecs/h264/torchdeblock.py",
                 "thinvids_tpu_torch/native/__init__.py",
                 "thinvids_tpu_torch/parallel/rc.py",
                 "thinvids_tpu_torch/abr/scale.py",
                 "thinvids_tpu_torch/abr/ladder.py",
                 "thinvids_tpu_torch/abr/hls.py",
                 "thinvids_tpu_torch/ingest/tail.py",
                 "thinvids_tpu_torch/live/packager.py",
                 "thinvids_tpu_torch/obs/metrics.py",
                 "thinvids_tpu_torch/obs/trace.py",
                 "thinvids_tpu_torch/cluster/executor.py",
                 "thinvids_tpu_torch/cluster/remote.py",
                 "thinvids_tpu_torch/cluster/halo.py",
                 "thinvids_tpu_torch/cluster/partstore.py",
                 "thinvids_tpu_torch/farm/controller.py",
                 "thinvids_tpu_torch/farm/lifecycle.py",
                 "thinvids_tpu_torch/farm/provider.py",
                 "thinvids_tpu_torch/tools/loadgen.py",
                 "thinvids_tpu_torch/parallel/sfefarm.py",
                 "thinvids_tpu_torch/parallel/planner.py",
                 "thinvids_tpu_torch/core/devices.py",
                 "thinvids_tpu_torch/codecs/h264/decoder.py",
                 "thinvids_tpu_torch/tools/import_media.py",
                 "thinvids_tpu_torch/tools/fuzz_native.py"):
        assert want in rel
    # the scan catches both spellings, at module level and in a function,
    # and lets relative imports and the port's own name through
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\n"
                     "from . import torchme\n"
                     "import thinvids_tpu_torch\n"
                     "def f():\n"
                     "    from thinvids_tpu.codecs import h264\n")
    found = [n.split(".")[0] for n in _top_level_imports(probe)]
    assert sorted(set(found) & set(_FORBIDDEN)) == ["jax", "thinvids_tpu"]
    assert "thinvids_tpu_torch" in found


_TORCH_FREE_IMPORT = r"""
import importlib, sys

for name in ("torch", "jax", "jaxlib"):
    sys.modules[name] = None
for name in ("thinvids_tpu_torch.abr.ladder", "thinvids_tpu_torch.abr.hls"):
    importlib.import_module(name)
from thinvids_tpu_torch.abr.ladder import parse_rung_heights, rung_width

assert parse_rung_heights("360p; junk, 720 ,720") == [720, 360]
assert rung_width(1920, 1080, 480) == 854
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "jaxlib")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_ladder_planning_and_hls_import_without_torch():
    """abr.ladder and abr.hls run on a control plane that loads no device
    backend: they import (and plan rung widths) with torch and jax
    unimportable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _TORCH_FREE_IMPORT],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


_LIVE_TORCH_FREE_IMPORT = r"""
import importlib, sys

for name in ("torch", "jax", "jaxlib"):
    sys.modules[name] = None
for name in ("thinvids_tpu_torch.ingest.tail",
             "thinvids_tpu_torch.live.packager",
             "thinvids_tpu_torch.obs.metrics",
             "thinvids_tpu_torch.obs.trace"):
    importlib.import_module(name)
from thinvids_tpu_torch.ingest.tail import is_live_name
from thinvids_tpu_torch.obs.trace import TRACE

assert is_live_name("cam.live.y4m")
assert TRACE.start("job")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "jaxlib", "thinvids_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_tail_packager_and_obs_import_without_torch():
    """The tail source, the live packager and the observability modules
    run on control-plane threads: they import (and work) with torch and
    jax unimportable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _LIVE_TORCH_FREE_IMPORT],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


_EXECUTOR_JAX_FREE_IMPORT = r"""
import importlib.abc, sys

sys.modules["jax"] = None
sys.modules["jaxlib"] = None


class RefuseReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "thinvids_tpu" or name.startswith("thinvids_tpu."):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, RefuseReference())
from thinvids_tpu_torch.cluster import executor
from thinvids_tpu_torch.cluster.executor import run_live

assert executor._live_batch_plan(9, 4, 1).gops[-1].num_frames == 1
try:
    run_live("missing.live.y4m", "out", None)
except RuntimeError as exc:
    assert "CUDA is not available" in str(exc), exc
else:
    raise AssertionError("run_live ran without a card")
print("ok")
"""


def test_live_executor_imports_without_jax():
    """cluster.executor imports with jax unimportable and the reference
    refused, and run_live's default device raises before it tails."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", _EXECUTOR_JAX_FREE_IMPORT],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


_FARM_TORCH_FREE_IMPORT = r"""
import importlib, importlib.abc, sys

for name in ("torch", "jax", "jaxlib"):
    sys.modules[name] = None


class RefuseReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "thinvids_tpu" or name.startswith("thinvids_tpu."):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, RefuseReference())
for name in ("thinvids_tpu_torch.cluster.remote",
             "thinvids_tpu_torch.cluster.halo",
             "thinvids_tpu_torch.cluster.partstore",
             "thinvids_tpu_torch.farm",
             "thinvids_tpu_torch.farm.controller",
             "thinvids_tpu_torch.farm.lifecycle",
             "thinvids_tpu_torch.farm.provider",
             "thinvids_tpu_torch.tools.loadgen"):
    importlib.import_module(name)
import numpy as np

from thinvids_tpu_torch.cluster import Coordinator
from thinvids_tpu_torch.cluster.halo import (HaloRelay, pack_arrays,
                                             unpack_arrays)
from thinvids_tpu_torch.cluster.remote import (ShardBoard, pack_parts,
                                               unpack_parts)
from thinvids_tpu_torch.core.types import EncodedSegment, GopSpec
from thinvids_tpu_torch.farm import CapacityController, NullProvider
from thinvids_tpu_torch.parallel.planner import plan_encode

seg = EncodedSegment(gop=GopSpec(index=3, start_frame=6, num_frames=2),
                     payload=b"\0\0\1x", frame_sizes=(4,))
assert unpack_parts(pack_parts([seg]))[0].payload == seg.payload
cnt = np.arange(6, dtype=np.int32).reshape(3, 2)
assert (unpack_arrays(pack_arrays({"cnt": cnt}))["cnt"] == cnt).all()
relay = HaloRelay()
relay.set_gen("j", 1)
co = Coordinator()
board = ShardBoard(co)
assert board.claim("w0") is None
farm = CapacityController(co, provider=NullProvider(), board=board)
assert farm is not None
plan = plan_encode(32, co._settings_fn(), num_devices=2, shape="band",
                   total_bands=3, group_count=2, mb_height=9)
assert plan.band_groups == ((0, 2), (2, 3))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "jaxlib", "thinvids_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def test_remote_halo_partstore_farm_and_loadgen_import_without_torch():
    """The remote backend's control plane — the board and wire format,
    the halo relay, the part spool, the farm controller, lifecycle and
    providers, the load harness — runs on coordinator threads: it
    imports (and works) with torch and jax unimportable and the
    reference refused; only the worker's encode loads torch."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _FARM_TORCH_FREE_IMPORT],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


_LAST_MODULES = r"""
import importlib, sys

for name in ("torch", "jax", "jaxlib"):
    sys.modules[name] = None
for name in ("thinvids_tpu_torch.codecs.h264.decoder",
             "thinvids_tpu_torch.tools.import_media",
             "thinvids_tpu_torch.tools.fuzz_native"):
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] == "thinvids_tpu")
assert not leaked, leaked
print("ok")
"""


def test_the_decoder_and_the_last_tools_need_neither_torch_nor_jax():
    """The decoder, import_media and fuzz_native are host code: they
    import with torch and JAX both unimportable, and nothing of the JAX
    package comes in with them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _LAST_MODULES], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


_SPEC_PATH_TORCH_FREE = r"""
import hashlib, importlib.abc, sys

import numpy as np

for name in ("torch", "jax", "jaxlib"):
    sys.modules[name] = None


class RefuseReference(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "thinvids_tpu" or name.startswith("thinvids_tpu."):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, RefuseReference())
from thinvids_tpu_torch.codecs.h264.encoder import encode_frames
from thinvids_tpu_torch.core.types import Frame, VideoMeta

rng = np.random.default_rng(4)
frames = [Frame(rng.integers(0, 256, (48, 80), dtype=np.uint8),
                rng.integers(0, 256, (24, 40), dtype=np.uint8),
                rng.integers(0, 256, (24, 40), dtype=np.uint8))
          for _ in range(2)]
stream = encode_frames(frames, VideoMeta(width=80, height=48), qp=27,
                       use_device=False)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "jaxlib", "thinvids_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(hashlib.sha256(stream).hexdigest())
"""


def test_numpy_encode_path_runs_without_torch():
    """codecs.h264.encoder imports with torch and jax unimportable and
    the reference refused, and `encode_frames(..., use_device=False)`
    there gives the reference's ``use_jax=False`` stream (equal sha256)."""
    import hashlib

    import numpy as np

    from thinvids_tpu.codecs.h264.encoder import encode_frames
    from thinvids_tpu.core.types import Frame, VideoMeta

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _SPEC_PATH_TORCH_FREE],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    rng = np.random.default_rng(4)
    frames = [Frame(rng.integers(0, 256, (48, 80), dtype=np.uint8),
                    rng.integers(0, 256, (24, 40), dtype=np.uint8),
                    rng.integers(0, 256, (24, 40), dtype=np.uint8))
              for _ in range(2)]
    want = encode_frames(frames, VideoMeta(width=80, height=48), qp=27,
                         use_jax=False)
    assert res.stdout.split()[-1] == hashlib.sha256(want).hexdigest()
