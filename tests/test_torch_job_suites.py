"""The reference's suites of the job store, the coordinator's journal,
ingest and the CLI, run over the port: tests/test_durability.py
(cluster/jobs, cluster/coordinator, core/events: journal, SIGKILL
truncation, recovery), tests/test_transcode.py (ingest/decode,
ingest/probe, io/mp4, a job through the executor) and tests/test_cli.py
(`cli coordinator` and `cli agent` as processes); and the reference's
cases that hold a subsystem's contract through the analyzer:
tests/test_live.py (no dead settings key; tail and packager
device-free), tests/test_abr.py (ladder and hls device-free),
tests/test_compact.py (the sync boundary) and tests/test_streaming.py
(the read_video ban).

Each reference test module is read with every `thinvids_tpu` import
naming `thinvids_tpu_torch` instead and executed as a module of its own;
its cases are collected here and run once more on the port's modules.
The port's encoders and executors take ``device="cuda"`` by default and
raise without a card, so the cases run them on the CPU: the
`encode_clip_sharded` and `LocalExecutor` they use are the port's with
``device="cpu"``, and every `cli coordinator` they spawn gets
``--device cpu``.

The analyzer cases read the manifest's device vocabulary in the port's
terms: `jax_free` → `device_free`, `check_jax_confinement` →
`check_device_confinement`, `jaxcore` → `torchcore`, and the blocking
sync calls `device_get` → `cpu`, `block_until_ready` → `synchronize`.
This module's `analysis_ctx` (the port's manifest and its package tree,
the tree `cli check` scans) takes the place of tests/conftest.py's.
"""

import functools
import os
import pathlib
import re
import types

import pytest
import torch

from thinvids_tpu_torch.cluster import executor as texecutor
from thinvids_tpu_torch.parallel import dispatch as tdispatch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def on_the_cpu(cls):
    """`cls` with ``device="cpu"`` as its default."""
    class Cpu(cls):
        def __init__(self, *args, device="cpu", **kw):
            super().__init__(*args, device=device, **kw)

    Cpu.__name__ = Cpu.__qualname__ = cls.__name__
    return Cpu


#: module attribute → its CPU stand-in, in the port's modules and in the
#: namespace of every reference module executed here
CPU_STANDINS = {
    (tdispatch, "encode_clip_sharded"):
        functools.partial(tdispatch.encode_clip_sharded, device="cpu"),
    (texecutor, "LocalExecutor"): on_the_cpu(texecutor.LocalExecutor),
}

#: the analyzer's device vocabulary: the reference's → the port's
ANALYSIS_TERMS = (
    (r"\bjax_free\b", "device_free"),
    (r"\bcheck_jax_confinement\b", "check_device_confinement"),
    (r"\bjaxcore\b", "torchcore"),
    (r'"device_get"', '"cpu"'),
    (r'"block_until_ready"', '"synchronize"'),
)


def reference_cases(name: str, terms=(), standins=None,
                    pins=()) -> types.ModuleType:
    """tests/<name>.py with its `thinvids_tpu` imports pointed at the
    port (and `terms` rewritten), executed as a module of its own
    (tracebacks keep the reference file's lines); the names it imports
    from the port at module scope are swapped for their CPU stand-ins
    (`standins`, CPU_STANDINS by default). Each pin (old, new) replaces
    an exact text of the reference module, which must appear in it."""
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    src = re.sub(r"\bthinvids_tpu\b", "thinvids_tpu_torch", path.read_text())
    src = re.sub(r'("thinvids_tpu_torch\.cli", "coordinator",)',
                 r'\1 "--device", "cpu",', src)
    for pattern, repl in terms:
        src = re.sub(pattern, repl, src)
    for old, new in pins:
        assert old in src, f"{name}: pin {old!r} no longer applies"
        src = src.replace(old, new)
    mod = types.ModuleType(f"{name}_over_the_port")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    for (owner, attr), standin in (standins or CPU_STANDINS).items():
        if mod.__dict__.get(attr) is getattr(owner, attr):
            mod.__dict__[attr] = standin
    return mod


def collect(mod: types.ModuleType, namespace: dict, names=None,
            leave_out=()) -> None:
    """Put `mod`'s test classes, test functions and fixtures (or only
    `names`) into a test module's namespace, where pytest collects
    them. `leave_out` names cases not to collect: ``"test_x"`` or
    ``"TestClass.test_x"`` (the class is collected as a subclass
    without that method)."""
    left = set(leave_out)
    for name, obj in vars(mod).items():
        if names is not None:
            if name not in names:
                continue
        elif not (name.startswith(("test_", "Test")) or
                  type(obj).__name__ == "FixtureFunctionDefinition"):
            continue
        if name in left:
            left.discard(name)
            continue
        drop = {m.split(".", 1)[1] for m in leave_out
                if m.startswith(name + ".")}
        if drop:
            assert all(callable(getattr(obj, m, None)) for m in drop), drop
            obj = type(name, (obj,), dict.fromkeys(drop))
            left -= {f"{name}.{m}" for m in drop}
        namespace[name] = obj
    assert not left, f"{mod.__name__}: no case named {sorted(left)}"


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    for (owner, attr), standin in CPU_STANDINS.items():
        monkeypatch.setattr(owner, attr, standin)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def analysis_ctx():
    """(the port's manifest, SourceTree over the port's package) — the
    tree `python -m thinvids_tpu_torch.cli check` analyzes."""
    from thinvids_tpu_torch.analysis import SourceTree, default_manifest

    return default_manifest(), SourceTree(
        os.path.join(REPO, "thinvids_tpu_torch"))


for _name in ("test_durability", "test_transcode", "test_cli"):
    collect(reference_cases(_name), globals())
collect(reference_cases("test_live", ANALYSIS_TERMS), globals(),
        {"test_every_settings_key_has_a_reader_outside_config",
         "test_tail_and_packager_are_manifested_jax_free"})
collect(reference_cases("test_abr", ANALYSIS_TERMS), globals(),
        {"test_ladder_and_hls_are_manifested_jax_free"})
collect(reference_cases("test_compact", ANALYSIS_TERMS), globals(),
        {"TestSyncConfinement"})
collect(reference_cases("test_streaming", ANALYSIS_TERMS), globals(),
        {"TestNoMaterializedPrologue"})
