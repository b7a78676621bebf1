"""The reference's suites of the host modules the port copied, run over
the port: tests/test_io.py (io/bits, io/y4m), tests/test_mp4.py
(io/mp4), tests/test_stamp.py (tools/stamp), tests/test_metrics.py
(tools/metrics) and tests/test_core.py (core/*, through the package
root's exports).

Each reference test module is read with every `thinvids_tpu` import
naming `thinvids_tpu_torch` instead and executed as a module of its own;
its cases are collected here and run once more on the port's modules.
The port's encode entry points take ``device="cuda"`` by default and
raise without a card, so the cases run them on the CPU: the
`encode_clip_sharded` and `encode_gop` the cases call are the port's with
``device="cpu"``.

Beside them, the two repairs these suites needed: the package roots
export the reference's names (`core`, `io`, a lazy `parallel` whose
`packproc` sidecars import without torch, `default_mesh` in
parallel.dispatch), and `encode_waves(pack_workers=)` resizes the pack
pool per call and gives the reference's stream.
"""

import functools
import os
import pathlib
import re
import subprocess
import sys
import types

import jax
import numpy as np
import torch

from thinvids_tpu.core.types import Frame as JFrame
from thinvids_tpu.core.types import VideoMeta as JMeta
from thinvids_tpu.core.types import concat_segments as jconcat
from thinvids_tpu.parallel import dispatch as jdispatch
from thinvids_tpu_torch.codecs.h264 import encoder as tencoder
from thinvids_tpu_torch.core.types import Frame as TFrame
from thinvids_tpu_torch.core.types import VideoMeta as TMeta
from thinvids_tpu_torch.core.types import concat_segments as tconcat
from thinvids_tpu_torch.parallel import dispatch as tdispatch

import pytest

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: module attribute → its CPU stand-in, in the port's modules and in the
#: namespace of every reference module executed here
CPU_STANDINS = {
    (tdispatch, "encode_clip_sharded"):
        functools.partial(tdispatch.encode_clip_sharded, device="cpu"),
    (tencoder, "encode_gop"):
        functools.partial(tencoder.encode_gop, device="cpu"),
}


def reference_cases(name: str) -> types.ModuleType:
    """tests/<name>.py with its `thinvids_tpu` imports pointed at the
    port, executed as a module of its own (tracebacks keep the reference
    file's lines); the names it imports from the port at module scope
    are swapped for their CPU stand-ins."""
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    src = re.sub(r"\bthinvids_tpu\b", "thinvids_tpu_torch", path.read_text())
    mod = types.ModuleType(f"{name}_over_the_port")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    for (owner, attr), standin in CPU_STANDINS.items():
        if mod.__dict__.get(attr) is getattr(owner, attr):
            mod.__dict__[attr] = standin
    return mod


def collect(mod: types.ModuleType, namespace: dict) -> None:
    """Put `mod`'s test classes, test functions and fixtures into a test
    module's namespace, where pytest collects them."""
    for name, obj in vars(mod).items():
        if name.startswith(("test_", "Test")) or \
                type(obj).__name__ == "FixtureFunctionDefinition":
            namespace[name] = obj


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    for (owner, attr), standin in CPU_STANDINS.items():
        monkeypatch.setattr(owner, attr, standin)


for _name in ("test_io", "test_mp4", "test_stamp", "test_metrics",
              "test_core"):
    collect(reference_cases(_name), globals())


# ---------------------------------------------------------------------------
# the package roots (ROADMAP C1)
# ---------------------------------------------------------------------------


def test_package_roots_export_the_reference_names():
    import thinvids_tpu.core as jcore
    import thinvids_tpu.io as jio
    import thinvids_tpu.parallel as jparallel
    import thinvids_tpu_torch.core as tcore
    import thinvids_tpu_torch.io as tio
    import thinvids_tpu_torch.parallel as tparallel

    for ref, port in ((jcore, tcore), (jio, tio), (jparallel, tparallel)):
        assert port.__all__ == ref.__all__
        for name in port.__all__:
            got, want = getattr(port, name), getattr(ref, name)
            got = getattr(got, "func", got)     # the CPU stand-in's
            assert getattr(got, "__name__", type(got).__name__) == \
                getattr(want, "__name__", type(want).__name__)
    assert tparallel.GopShardEncoder is tdispatch.GopShardEncoder
    from thinvids_tpu_torch.core.devices import default_mesh
    assert tdispatch.default_mesh is default_mesh


def test_packproc_and_the_roots_import_without_torch():
    """`parallel` stays lazy: the process pack sidecars import packproc
    (and the core, io roots) in a process where torch cannot load."""
    code = ("import sys\n"
            "for name in ('torch', 'jax', 'triton'):\n"
            "    sys.modules[name] = None\n"
            "import thinvids_tpu_torch.parallel.packproc\n"
            "from thinvids_tpu_torch.core import Status, Settings\n"
            "from thinvids_tpu_torch.io import BitReader, read_y4m\n"
            "from thinvids_tpu_torch.parallel import plan_segments\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


# ---------------------------------------------------------------------------
# encode_waves(pack_workers=) (ROADMAP C2)
# ---------------------------------------------------------------------------


def test_pack_workers_per_call_gives_the_reference_stream():
    rng = np.random.default_rng(7)
    n, w, h = 8, 64, 48
    clip = []
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = 128 + 60 * np.sin((xx + 2 * i) * 0.11) * np.cos((yy + i) * 0.09)
        clip.append((np.clip(y + rng.normal(0, 2, (h, w)), 0, 255)
                     .astype(np.uint8),
                     rng.integers(100, 156, (h // 2, w // 2), np.uint8),
                     rng.integers(100, 156, (h // 2, w // 2), np.uint8)))
    jenc = jdispatch.GopShardEncoder(
        JMeta(width=w, height=h, num_frames=n), qp=30, gop_frames=4,
        mesh=jdispatch.default_mesh(jax.devices()[:1]), pack_workers=2)
    tenc = tdispatch.GopShardEncoder(
        TMeta(width=w, height=h, num_frames=n), qp=30, gop_frames=4,
        device="cpu", pack_workers=2)
    _, jwaves = jenc.prepare_waves([JFrame(*f) for f in clip])
    _, twaves = tenc.prepare_waves([TFrame(*f) for f in clip])
    want = jconcat(jenc.encode_waves(jwaves))
    for pw in (1, 8):
        got = tconcat(tenc.encode_waves(twaves, pack_workers=pw))
        assert jconcat(jenc.encode_waves(jwaves, pack_workers=pw)) == want
        assert got == want
        assert tenc.pack_workers == pw
        assert (tenc._pack_pool is None) == (pw == 1)
    sfe = tdispatch.SfeShardEncoder(
        TMeta(width=w, height=h, num_frames=n), qp=30, gop_frames=4,
        bands=2, device="cpu", pack_workers=2)
    _, swaves = sfe.prepare_waves([TFrame(*f) for f in clip])
    one = tconcat(sfe.encode_waves(swaves, pack_workers=1))
    assert sfe.pack_workers == 1
    assert tconcat(sfe.encode_waves(swaves, pack_workers=8)) == one
    assert sfe.pack_workers == 8
